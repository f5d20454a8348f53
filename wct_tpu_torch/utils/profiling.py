"""Observability: program spans, synchronised stage timers and a device
profiler trace.

Counterpart of ``wct_tpu/utils/profiling.py``. PyTorch returns from a
CUDA call before the card has finished, so a host clock around it
measures the enqueue; every timer here waits for the work first.

- ``span`` — a named range of the program (``wct.stylize``,
  ``wct.level.<relu>``, ``wct.encode``, ``wct.op.conv`` …; README's
  table). With no profiler running it is one shared no-op context and
  makes no torch call. Under ``torch.profiler`` it is a
  ``record_function`` range, on the trace's clock beside the CUDA
  activity it launches, and it adds its host time to an in-memory
  summary per name (``span_totals``, ``reset_spans``): calls, total and
  self host ns, self being the total less the time its child spans
  cover.
- ``device_sync`` — wait for the work that produced a result: on a CUDA
  tensor, an event recorded on the current stream and synchronised; on
  the CPU, nothing (the work is done when the call returns).
- ``StageTimer`` — named wall-clock stages with a device sync at each
  boundary, for per-stage splits (host preparation / H2D / device /
  D2H).
- ``trace`` — ``torch.profiler`` around a block, with CUDA activity on
  the card, written as a Chrome trace with the spans' summary beside
  it; ``device_busy_share`` reads the share of a trace's span in which
  the card ran a kernel or a copy.
- ``shard_times`` — each mesh entry's enqueue and stream time in the
  last data-parallel stylization (``parallel.stylize_sharded``).
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import profiler as _autograd_profiler

from wct_tpu_torch.utils.device import resolve_device

# What ``span`` returns while no profiler runs: one shared, reusable
# context, so a span costs a flag read and nothing else.
_OFF = contextlib.nullcontext()
# Per name: [calls, total host ns, self host ns], over profiled stretches.
_TOTALS: dict[str, list[int]] = {}
_TOTALS_LOCK = threading.Lock()
# Per thread, one entry per open span: [its name, the ns its finished
# children took].
_OPEN = threading.local()


def span(name: str):
    """A context manager naming a range of the program.

    With no profiler running (``torch.autograd.profiler``'s enabled flag
    false) it returns a shared no-op context: no allocation, no torch
    call. Under ``torch.profiler`` it enters
    ``torch.profiler.record_function(name)``, so the range lands in the
    trace with the kernels it launches, and adds the range's host time
    to ``span_totals()``. A span opened directly inside one of the same
    name records nothing, so an entry point that calls another of its
    layer (``conv2d_reflect_nchw`` → ``conv2d_valid_nchw``) makes one
    range. Use it in a ``with`` block, so that ranges nest properly on
    each thread.
    """
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    if stack and stack[-1][0] == name:
        return _OFF
    return _recorded(name, stack)


@contextlib.contextmanager
def _recorded(name: str, stack: list):
    with torch.profiler.record_function(name):
        stack.append([name, 0])
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            total = time.perf_counter_ns() - t0
            children = stack.pop()[1]
            if stack:
                stack[-1][1] += total
            with _TOTALS_LOCK:
                row = _TOTALS.setdefault(name, [0, 0, 0])
                row[0] += 1
                row[1] += total
                row[2] += total - children


def span_totals() -> dict[str, dict[str, int]]:
    """The spans' summary since the last ``reset_spans``: per name,
    ``{"calls", "total_ns", "self_ns"}`` of host time. Only stretches
    run under a profiler are counted."""
    with _TOTALS_LOCK:
        return {name: {"calls": c, "total_ns": t, "self_ns": s}
                for name, (c, t, s) in _TOTALS.items()}


def reset_spans() -> None:
    """Clear the spans' summary."""
    with _TOTALS_LOCK:
        _TOTALS.clear()


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


@contextlib.contextmanager
def trace(log_dir: str, device: str | torch.device = "cuda"):
    """``torch.profiler`` around the block; yields the profiler, or None.

    Records CPU activity, and CUDA activity when ``device`` is a CUDA
    device (asking for one without a card raises, as every entry point
    of the port does). On exit the trace is written to
    ``log_dir/trace.json`` (Chrome's trace format, read by Perfetto)
    and the block's ``span_totals()`` to ``log_dir/spans.json`` (the
    summary is reset when the block starts). As in the reference, a
    profiler that cannot start prints why and the block runs untraced.
    """
    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    reset_spans()
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
            (Path(log_dir) / "spans.json").write_text(json.dumps(span_totals(), indent=1))


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
