"""The reader of ``transform.eigh_span_share.f32`` on a synthetic Chrome
trace: device time launched under the program's ``wct.op.eigh`` (inside
``wct.op.sqrt``) over busy time, and nothing where the span is absent, as
in a program from before the span."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import spec  # noqa: E402
from test_bench_spans import ctx, host, kernel, launch  # noqa: E402

NAME = "transform.eigh_span_share.f32"

SPANS = [
    host("bench.window", 0, 400),
    host("wct.stylize", 10, 300),
    host("wct.transform", 20, 200),
    host("wct.op.gram", 25, 20),
    host("wct.op.sqrt", 50, 100),
    host("wct.op.eigh", 55, 60),
    host("aten::mm", 130, 10, cat="cpu_op"),
]
WORK = [
    launch(30, 1), kernel("centered_gram_kernel", 100, 20, 1),  # 100-120: the Gram
    launch(60, 2), kernel("eigh_jacobi", 120, 60, 2),  # 120-180: under wct.op.eigh
    launch(131, 3), kernel("sm80_xmma_gemm_f32f32", 180, 20, 3),  # 180-200: sqrt, not eigh
    launch(300, 4), kernel("quantise_kernel", 300, 20, 4),  # 300-320: after the transform
]


def test_reads_device_time_under_the_eigh_span():
    c = ctx(SPANS + WORK)
    # busy: 100-200 and 300-320 = 120 µs; under wct.op.eigh: 60 µs
    assert c.trace.busy_s == pytest.approx(120e-6)
    assert spec.metric_reader(NAME)(c) == pytest.approx(100.0 * 60 / 120)


def test_reads_nothing_without_the_span():
    c = ctx([e for e in SPANS if e["name"] != "wct.op.eigh"] + WORK)
    assert spec.metric_reader(NAME)(c) is None


def test_the_entry_reads_the_f32_cell_and_moves_its_frames():
    entry = next(m for m in spec.load_benchmark()["per_layer"] if m["name"] == NAME)
    assert entry["layer"] == "transform" and entry["moves"] == "frames_per_s.f32"
    assert entry["workloads"] == ["wct5-f32-fidelity.offline512"]
    assert Path(spec.metric_reader(NAME).__code__.co_filename).name == "transform.eigh_span_share.py"
