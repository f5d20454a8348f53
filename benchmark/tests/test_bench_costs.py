"""The cost model against hand counts, and the peaks table."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import costs, peaks  # noqa: E402

LEVELS = ("relu5_1", "relu4_1", "relu3_1", "relu2_1", "relu1_1")


def test_one_conv():
    # conv1_2 at 512²: 64 × 64 × 9 products per pixel, a multiply and an add each.
    assert costs.conv3x3_flops(64, 64, 512, 512) == 2 * 9 * 64 * 64 * 512 * 512


def test_one_gram():
    # relu1_1 at 512², four bf16 images: C(C+1)/2 distinct entries × N × 2 FLOPs.
    flops, nbytes = costs.gram_work(4, 64, 512 * 512, 2)
    assert flops == 4 * (64 * 65 // 2) * 2 * 512 * 512
    assert nbytes == 4 * (512 * 512 * 64 * 2 + (64 * 64 + 64) * 4)


def test_one_junction():
    # [4, 64, 256, 256] state: 64→64, 64→3, 3→64, 64→64 at 512².
    flops, nbytes = costs.junction_work(4, 256, 256, 2)
    assert flops == 4 * 2 * 512 * 512 * 9 * (4096 + 192 + 192 + 4096)
    assert nbytes == 4 * 64 * (2 * 256 * 256) * 2


def test_level_shapes():
    assert costs.level_shape("relu1_1", 512, 512) == (64, 512 * 512)
    assert costs.level_shape("relu5_1", 512, 512) == (512, 32 * 32)


def test_relu1_1_level_by_hand():
    h = w = 512
    convs = 2 * costs.conv3x3_flops(3, 64, h, w)  # encoder conv1_1 and decoder dec_conv1_1
    assert costs.level_flops("relu1_1", h, w) == convs + 2 * (2 * 64 * 64 * h * w)


@pytest.mark.parametrize("h, w, tflop", [(512, 512, 0.829), (720, 1280, 2.92), (2048, 2048, 13.27)])
def test_frame_flops(h, w, tflop):
    assert costs.frame_flops(h, w, LEVELS) / 1e12 == pytest.approx(tflop, abs=5e-3)


def test_bound_is_the_larger_of_the_two():
    assert costs.bound_seconds(1e12, 1.0, 1e12, 1e12) == 1.0
    assert costs.bound_seconds(1.0, 2e12, 1e12, 1e12) == 2.0


def test_peaks():
    name = "NVIDIA H100 80GB HBM3"
    assert peaks.arithmetic_peak(name, "bfloat16") == 989.0e12
    assert peaks.arithmetic_peak(name, "float32") == pytest.approx(494.7e12 / 3)
    assert peaks.card_peaks("NVIDIA H100 PCIe")["hbm"] == 2.0e12
    with pytest.raises(KeyError):
        peaks.card_peaks("cpu")
