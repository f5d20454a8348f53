"""The trace arithmetic on a synthetic Chrome trace."""

import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import spec, tracing  # noqa: E402


def host(name, ts, dur, tid=1, cat="cpu_op"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid}


def launch(ts, corr, tid=1):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "pid": 1, "tid": tid, "args": {"correlation": corr}}


def kernel(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 7,
            "args": {"correlation": corr}}


EVENTS = [
    host("bench.window", 100, 100, cat="user_annotation"),
    host("bench.job", 100, 90, cat="user_annotation"),
    host("aten::convolution", 102, 10),
    host("aten::cudnn_convolution", 103, 5),
    launch(104, 1),
    host("aten::linalg_eigh", 130, 20),
    launch(131, 2),
    launch(160, 3),
    launch(161, 4),
    kernel("void cudnn_conv_kernel<float>(float*)", 110, 20, 1),  # 110-130
    kernel("eigh_kernel", 125, 15, 2),  # 125-140, overlaps the conv
    kernel("void (anonymous namespace)::gram_kernel<float, true>(int)", 150, 10, 3),  # 150-160
    kernel("Memcpy DtoH", 190, 30, 4, cat="gpu_memcpy"),  # 190-220, clipped at 200
    kernel("before the window", 10, 20, 99),
    {"ph": "X", "cat": "gpu_user_annotation", "name": "bench.job", "ts": 100, "dur": 100},
]


def test_window_and_busy_union():
    t = tracing.read_events(EVENTS)
    assert t.window == (100.0, 200.0)
    # union: 110-140, 150-160, 190-200 = 30 + 10 + 10 µs; annotations are not work
    assert t.busy_s == pytest.approx(50e-6)
    assert t.window_s == pytest.approx(100e-6)


def test_device_time_by_host_range_and_by_name():
    t = tracing.read_events(EVENTS)
    assert t.device_seconds(under="aten::convolution") == pytest.approx(20e-6)
    assert t.device_seconds(under="aten::linalg_eigh") == pytest.approx(15e-6)
    assert t.device_seconds(r"\bgram_kernel<") == pytest.approx(10e-6)
    assert t.device_seconds(under="bench.job") == pytest.approx(50e-6)


def test_idle_gaps_named_by_the_host():
    t = tracing.read_events(EVENTS)
    gaps = dict((name, s) for name, s in t.top_gaps())
    # 100-110 and 160-190 inside bench.job only, 140-150 inside aten::linalg_eigh
    assert t.top_gaps()[0] == ["bench.job", pytest.approx(30e-6)]
    assert gaps["aten::linalg_eigh"] == pytest.approx(10e-6)
    assert sum(s for _, s in t.top_gaps()) == pytest.approx(50e-6)


def test_top_ops_short_names():
    ops = dict((n, s) for n, s in tracing.read_events(EVENTS).top_ops())
    assert ops["cudnn_conv_kernel<float>"] == pytest.approx(20e-6)
    assert ops["gram_kernel<float, true>"] == pytest.approx(10e-6)


def test_a_trace_without_the_window_is_refused():
    with pytest.raises(ValueError):
        tracing.read_events(EVENTS[1:])


def test_union_length():
    assert tracing.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert tracing.union_length([]) == 0


def test_metric_readers_on_the_synthetic_trace():
    class Ctx:
        # eigh's launch (at 131) inside the program's span as well
        trace = tracing.read_events(EVENTS + [host("wct.op.eigh", 129, 22, cat="user_annotation")])

    share = spec.metric_reader("device.idle_share")(Ctx)
    assert share == pytest.approx(50.0)
    assert spec.metric_reader("convs.device_share")(Ctx) == pytest.approx(40.0)
    assert spec.metric_reader("transform.eigh_span_share.f32")(Ctx) == pytest.approx(30.0)
