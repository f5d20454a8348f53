"""The reader of ``transform.eigh_roofline.f32`` on a synthetic Chrome
trace: the least time of the eigendecompositions its declared launch
counter counts (9·C³ FLOPs a matrix at the f32 FFMA rate) over the
device time under ``wct.op.eigh``, and nothing where the counter or the
span has nothing to give."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import costs, peaks, program, spec  # noqa: E402
from test_bench_eigh_span import SPANS, WORK  # noqa: E402
from test_bench_spans import ctx as span_ctx  # noqa: E402

NAME = "transform.eigh_roofline.f32"
CARD = "NVIDIA H100 80GB HBM3"
LEVELS = ["relu5_1", "relu4_1", "relu3_1", "relu2_1", "relu1_1"]


def ctx(events, launches):
    c = span_ctx(events)
    c.counts = {"eigh": launches} if launches is not None else {}
    c.config = {"relu_targets": LEVELS}
    c.traffic = {"microbatch": 4, "height": 512, "width": 512}
    c.peaks, c.costs = peaks.card_peaks(CARD), costs
    return c


def test_eigh_work_by_hand():
    flops, nbytes = costs.eigh_work(4, 512)
    assert flops == 4 * 9 * 512**3
    assert nbytes == 4 * (2 * 512 * 512 + 512) * 4


def test_reads_the_bound_over_the_device_time_under_the_span():
    # two microbatches of the five levels; 60 µs under wct.op.eigh
    bound = sum(max(9.0 * 4 * c**3 / 67.0e12, 4 * (2 * c * c + c) * 4 / 3.35e12)
                for c in (512, 512, 256, 128, 64))
    assert bound == pytest.approx(0.1545e-3, rel=2e-3)
    got = spec.metric_reader(NAME)(ctx(SPANS + WORK, 10))
    assert got == pytest.approx(100.0 * 2 * bound / 60e-6)


@pytest.mark.parametrize("launches", [None, 0, 7])
def test_reads_nothing_without_whole_microbatches_counted(launches):
    assert spec.metric_reader(NAME)(ctx(SPANS + WORK, launches)) is None


def test_reads_nothing_without_the_span():
    events = [e for e in SPANS if e["name"] != "wct.op.eigh"] + WORK
    assert spec.metric_reader(NAME)(ctx(events, 10)) is None


def test_the_counter_it_declares_resolves_in_the_program():
    module = spec.metric_module(NAME)
    assert module.COUNTERS == {"eigh": "ops.eigh.eigh_cuda.launches"}
    assert isinstance(program.counter(module.COUNTERS["eigh"]), int)


def test_the_entry_reads_the_f32_cell_and_moves_its_frames():
    entry = next(m for m in spec.load_benchmark()["per_layer"] if m["name"] == NAME)
    assert entry["unit"] == "%" and entry["better"] == "higher"
    assert entry["moves"] == "frames_per_s.f32"
    assert entry["workloads"] == ["wct5-f32-fidelity.offline512"]
    assert Path(spec.metric_reader(NAME).__code__.co_filename).name == "transform.eigh_roofline.py"


def test_the_retired_eigh_share_is_gone():
    names = {m["name"] for m in spec.load_benchmark()["per_layer"]}
    assert "transform.eigh_share" not in names
    assert not (BENCH / "metrics" / "transform.eigh_share.py").exists()
