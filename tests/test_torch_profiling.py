"""The port's stage timers, device sync and trace (``wct_tpu_torch.utils.profiling``),
mirroring ``tests/test_profiling.py`` on CPU tensors."""

import json

import pytest
import torch

from wct_tpu_torch.utils import profiling


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite runs in
    parallel workers, and torch's OpenMP threads spinning on a loaded
    machine made a 30-step test take 150 s instead of 1."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_stage_timer_accumulates():
    t = profiling.StageTimer()
    x = torch.arange(8.0)
    with t.stage("a", sync_on=x):
        _ = x * 2
    out = {}
    with t.stage("a", sync_on=lambda: out["v"]):
        out["v"] = x + 1
    with t.stage("b"):
        pass
    assert t.timed("c", torch.add, x, 1).tolist() == (x + 1).tolist()
    assert t.counts["a"] == 2 and t.counts["b"] == 1 and t.counts["c"] == 1
    assert t.totals["a"] >= 0
    rep = t.report()
    assert "a:" in rep and "×2" in rep


def test_device_sync_handles_nested_trees_and_none():
    profiling.device_sync(None)
    profiling.device_sync({"x": torch.ones(2, 2), "y": None, "z": [torch.zeros(3), (None,)]})
    profiling.device_sync([])


def test_trace_on_cpu_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path), device="cpu") as prof:
        _ = torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") or "mm" in e.get("name", "") for e in events)
    assert profiling.device_busy_share(str(tmp_path / "trace.json")) == 0.0


def test_device_busy_share_is_the_union_of_device_intervals(tmp_path):
    events = [
        {"cat": "cpu_op", "name": "step", "ts": 0, "dur": 100},
        {"cat": "kernel", "name": "a", "ts": 10, "dur": 20},
        {"cat": "kernel", "name": "b", "ts": 20, "dur": 20},  # overlaps a
        {"cat": "gpu_memcpy", "name": "d2h", "ts": 60, "dur": 10},
        {"cat": "ac2g", "name": "flow", "ts": 5},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert profiling.device_busy_share(str(path)) == pytest.approx(0.4)


def test_trace_defaults_to_the_card_and_raises_without_one(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with profiling.trace(str(tmp_path)):
            pass

