"""Observability: synchronised stage timers and a device profiler trace.

Counterpart of ``wct_tpu/utils/profiling.py``. PyTorch returns from a
CUDA call before the card has finished, so a host clock around it
measures the enqueue; every timer here waits for the work first.

- ``device_sync`` — wait for the work that produced a result: on a CUDA
  tensor, an event recorded on the current stream and synchronised; on
  the CPU, nothing (the work is done when the call returns).
- ``StageTimer`` — named wall-clock stages with a device sync at each
  boundary, for per-stage splits (host preparation / H2D / device /
  D2H).
- ``timeit_min``, ``latency_seconds``, ``pipelined_fps`` — the
  measurement protocols of the reference's experiment scripts.
- ``trace`` — ``torch.profiler`` around a block, with CUDA activity on
  the card, written as a Chrome trace; ``device_busy_share`` reads the
  share of a trace's span in which the card ran a kernel or a copy.
- ``shard_times`` — each mesh entry's enqueue and stream time in the
  last data-parallel stylization (``parallel.stylize_sharded``).
"""

from __future__ import annotations

import contextlib
import json
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from wct_tpu_torch.utils.device import resolve_device


def _leaves(out) -> list:
    """The tensors and CUDA events of a nested dict / list / tuple."""
    if isinstance(out, (torch.Tensor, torch.cuda.Event)):
        return [out]
    if isinstance(out, dict):
        out = out.values()
    elif not isinstance(out, (list, tuple)):
        return []
    return [leaf for item in out for leaf in _leaves(item)]


def device_sync(out=None) -> None:
    """Wait until the work that produced ``out`` has finished.

    ``out`` may be a tensor, a CUDA event or a nested dict / list / tuple
    of them (``None`` leaves are skipped). For the first CUDA leaf an
    event is recorded on its device's current stream and synchronised
    (an event leaf is synchronised itself): a stream runs in order, so
    everything enqueued on it before has finished too. CPU tensors need
    no wait.
    """
    for leaf in _leaves(out):
        if isinstance(leaf, torch.cuda.Event):
            leaf.synchronize()
            return
        if leaf.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(leaf.device))
            event.synchronize()
            return


def timeit_min(fn, *args, iters: int = 10, repeats: int = 3) -> float:
    """min-of-``repeats`` mean-of-``iters`` wall time of ``fn(*args)``, ms.

    Warm up once, then time ``iters`` calls ending in one
    ``device_sync``, and keep the best of ``repeats`` runs.
    """
    out = fn(*args)
    device_sync(out)
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        outs = [fn(*args) for _ in range(iters)]
        device_sync(outs[-1])
        best = min(best, (time.perf_counter() - t0) / iters)
    return best * 1e3


class StageTimer:
    """Accumulating named stage timer with device-synced boundaries."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, sync_on=None):
        """Time a block; ``sync_on`` is a ZERO-ARG CALLABLE evaluated at
        block exit returning the value to device-sync on — it must be a
        callable because the output to sync on is produced INSIDE the
        block::

            out = {}
            with t.stage("step", sync_on=lambda: out["v"]):
                out["v"] = step(x)

        Passing a plain value would sync on the PREVIOUS iteration's
        output and misattribute all device time to a later stage.
        """
        t0 = time.perf_counter()
        try:
            yield
        finally:
            device_sync(sync_on() if callable(sync_on) else sync_on)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def timed(self, name: str, fn, *args, **kwargs):
        """Call ``fn``, device-sync its result, record the stage time."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        device_sync(out)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1
        return out

    def report(self) -> str:
        lines = []
        for name, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(
                f"{name}: {total * 1000:.1f} ms total, "
                f"{total / n * 1000:.2f} ms/call ×{n}"
            )
        return "\n".join(lines)


def sync_one_element(out) -> None:
    """Read one element of the first tensor of ``out`` to the host.

    A host read of a CUDA tensor waits for the stream that produced it,
    and shows that the value is readable; CPU tensors are read as they
    are.
    """
    leaves = [x for x in _leaves(out) if isinstance(x, torch.Tensor) and x.numel()]
    if leaves:
        _ = leaves[0].reshape(-1)[0].item()


def latency_seconds(fn, arg, n: int = 5) -> float:
    """Median per-call latency, each call synchronised."""
    sync_one_element(fn(arg))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        sync_one_element(fn(arg))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def pipelined_fps(fn, inputs, n_rounds: int = 3) -> float:
    """Frames/sec: enqueue all inputs, sync once on the last output."""
    sync_one_element(fn(inputs[0]))
    frames = sum(x.shape[0] for x in inputs)
    rates = []
    for _ in range(n_rounds):
        t0 = time.perf_counter()
        out = None
        for x in inputs:
            out = fn(x)
        sync_one_element(out)
        rates.append(frames / (time.perf_counter() - t0))
    return float(np.median(rates))


@contextlib.contextmanager
def trace(log_dir: str, device: str | torch.device = "cuda"):
    """``torch.profiler`` around the block; yields the profiler, or None.

    Records CPU activity, and CUDA activity when ``device`` is a CUDA
    device (asking for one without a card raises, as every entry point
    of the port does). On exit the trace is written to
    ``log_dir/trace.json`` (Chrome's trace format, read by Perfetto).
    As in the reference, a profiler that cannot start prints why and the
    block runs untraced.
    """
    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    try:
        prof.start()
    except RuntimeError as e:
        print(f"[profiling] trace unavailable: {e}")
        prof = None
    try:
        yield prof
    finally:
        if prof is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            prof.stop()
            Path(log_dir).mkdir(parents=True, exist_ok=True)
            prof.export_chrome_trace(str(Path(log_dir) / "trace.json"))


# Chrome-trace categories of work on the card.
_DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def device_busy_share(trace_json: str) -> float:
    """Share of a ``trace`` file's span (first to last event, host events
    included) in which the card ran at least one kernel, copy or memset:
    the union of their intervals over the span. 0.0 for a CPU trace."""
    events = [e for e in json.loads(Path(trace_json).read_text())["traceEvents"]
              if "ts" in e and "dur" in e]
    if not events:
        return 0.0
    span = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                              if e.get("cat") in _DEVICE_CATEGORIES):
        busy += max(0.0, stop - max(start, end))
        end = max(end, stop)
    return busy / span if span > 0 else 0.0


def shard_times(mesh) -> list[dict]:
    """Per mesh entry of the last ``parallel.stylize_sharded`` call: the
    host's enqueue ms and, on the card, the ms between events recorded on
    the entry's stream around its work (waits for that work to end)."""
    rows = []
    for r in mesh.last_shard_times:
        row = {"entry": r["entry"], "enqueue_ms": r["enqueue_s"] * 1e3, "device_ms": None}
        if r["end"] is not None:
            r["end"].synchronize()
            row["device_ms"] = r["start"].elapsed_time(r["end"])
        rows.append(row)
    return rows
