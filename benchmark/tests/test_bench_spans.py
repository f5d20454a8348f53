"""The readers of the program's spans, on a synthetic Chrome trace with
``wct.stylize`` › ``wct.transform`` / ``wct.op.conv`` ranges and a
stubbed span summary; each reads nothing where its span is absent."""

import sys
import types
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import spec, tracing  # noqa: E402
from wct_tpu_torch.utils import profiling  # noqa: E402


def host(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": 1}


def launch(ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "pid": 1, "tid": 1, "args": {"correlation": corr}}


def kernel(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7,
            "args": {"correlation": corr}}


SPANS = [
    host("bench.window", 0, 400),
    host("wct.stylize", 10, 300),
    host("wct.level.relu5_1", 10, 300),
    host("wct.encode", 10, 50),
    host("wct.op.conv", 12, 40),
    host("aten::reflection_pad2d", 13, 5, cat="cpu_op"),
    host("aten::convolution", 20, 10, cat="cpu_op"),
    host("wct.transform", 70, 100),
    host("aten::linalg_eigh", 80, 20, cat="cpu_op"),
]
WORK = [
    launch(14, 1), kernel("reflection_pad2d_out_kernel<float>", 100, 20, 1),  # 100-120
    launch(21, 2), kernel("cudnn_conv_kernel<float>", 120, 30, 2),  # 120-150
    launch(81, 3), kernel("syevbj_batch", 150, 40, 3),  # 150-190
    launch(150, 4), kernel("gram_kernel<float>", 190, 10, 4),  # 150 is in wct.transform
    launch(200, 5), kernel("Memcpy DtoH (Device -> Pinned)", 200, 20, 5, cat="gpu_memcpy"),
    launch(350, 6), kernel("quantise_kernel", 350, 30, 6),  # after wct.stylize
]


def ctx(events, images=2):
    return types.SimpleNamespace(trace=tracing.read_events(events), images_traced=images)


def read(name, c):
    return spec.metric_reader(name)(c)


def without(*names):
    return [e for e in SPANS if e["name"] not in names] + WORK


def test_the_trace_ties_kernels_to_the_program_spans():
    t = ctx(SPANS + WORK).trace
    # busy: 100-220 and 350-380 = 150 µs
    assert t.busy_s == pytest.approx(150e-6)
    assert t.device_seconds(under="wct.op.conv") == pytest.approx(50e-6)
    assert t.device_seconds(under="aten::convolution") == pytest.approx(30e-6)
    assert t.device_seconds(under="wct.transform") == pytest.approx(50e-6)


@pytest.mark.parametrize("name", ["transform.device_share.bf16", "transform.device_share.f32"])
def test_transform_device_share(name):
    assert read(name, ctx(SPANS + WORK)) == pytest.approx(100.0 * 50 / 150)
    assert read(name, ctx(without("wct.transform"))) is None


@pytest.mark.parametrize("name", ["convs.layer_share.bf16", "convs.layer_share.f32"])
def test_conv_layer_share_counts_the_pads(name):
    c = ctx(SPANS + WORK)
    assert read(name, c) == pytest.approx(100.0 * 50 / 150)
    assert read(name, c) > read("convs.device_share.bf16", c)
    assert read(name, ctx(without("wct.op.conv"))) is None


def test_kernels_per_frame_leaves_out_copies_and_what_lies_outside_the_cascade():
    # under wct.stylize: the pad, the conv, eigh's and the Gram's kernel,
    # and the copy (not counted): 4 kernels over 2 images
    assert read("cascade.kernels_per_frame.bf16", ctx(SPANS + WORK)) == pytest.approx(2.0)
    assert read("cascade.kernels_per_frame.bf16", ctx(SPANS + WORK, images=0)) is None
    assert read("cascade.kernels_per_frame.bf16", ctx(without("wct.stylize"))) is None


def test_host_ms_per_frame_reads_the_span_summary(monkeypatch):
    summary = {"wct.stylize": {"calls": 4, "total_ns": 36_000_000, "self_ns": 1_000_000}}
    monkeypatch.setattr(profiling, "span_totals", lambda: summary)
    c = ctx(SPANS + WORK, images=4)
    assert read("cascade.host_ms_per_frame.bf16", c) == pytest.approx(9.0)
    monkeypatch.setattr(profiling, "span_totals", lambda: {})
    assert read("cascade.host_ms_per_frame.bf16", c) is None
    monkeypatch.delattr(profiling, "span_totals")
    assert read("cascade.host_ms_per_frame.bf16", c) is None


def test_each_new_metric_is_read_by_its_quantitys_reader():
    for name, file in [("transform.device_share.f32", "transform.device_share.py"),
                       ("convs.layer_share.bf16", "convs.layer_share.py"),
                       ("cascade.kernels_per_frame.bf16", "cascade.kernels_per_frame.py"),
                       ("cascade.host_ms_per_frame.bf16", "cascade.host_ms_per_frame.py")]:
        assert Path(spec.metric_reader(name).__code__.co_filename).name == file
