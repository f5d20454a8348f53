"""What a traced run reads from the profiler's trace.

The trace is ``torch.profiler``'s Chrome trace of a bounded window of
the run, which the benchmark marks on the host with a range named
``bench.window``. Work on the card is every event of category
``kernel``, ``gpu_memcpy`` or ``gpu_memset``; the card is busy where at
least one of them runs (the union of their intervals), clipped to the
window. Each kernel is tied by its correlation id to the host call that
launched it, and through that to the stack of host ranges (ATen ops and
the benchmark's own ``bench.*`` ranges) open at the launch, so that a
reader can ask how much device time ran under, say, ``aten::convolution``.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATEGORIES = ("cpu_op", "user_annotation")
WINDOW = "bench.window"


@dataclasses.dataclass(frozen=True)
class DeviceOp:
    name: str
    start: float  # µs, clipped to the window
    end: float
    stack: tuple[str, ...]  # host ranges open at the launch, outermost first


@dataclasses.dataclass
class Trace:
    window: tuple[float, float]  # µs
    ops: list[DeviceOp]
    gaps: list[tuple[str, float]]  # idle gaps: (what the host did, µs)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    @property
    def busy_s(self) -> float:
        return union_length([(o.start, o.end) for o in self.ops]) * 1e-6

    def device_seconds(self, name_pattern: str | None = None, under: str | None = None) -> float:
        """Device time of the ops whose name matches ``name_pattern`` (a
        regular expression) and, with ``under``, that were launched inside
        a host range of that exact name (a union, so overlapping ops on two
        streams count once)."""
        rx = re.compile(name_pattern) if name_pattern else None
        spans = [(o.start, o.end) for o in self.ops
                 if (rx is None or rx.search(o.name)) and (under is None or under in o.stack)]
        return union_length(spans) * 1e-6

    def top_ops(self, k: int = 10) -> list[list]:
        """The ``k`` device ops that took most time in all, by name, in seconds."""
        totals: dict[str, float] = {}
        for o in self.ops:
            key = short_name(o.name)
            totals[key] = totals.get(key, 0.0) + (o.end - o.start)
        top = sorted(totals.items(), key=lambda kv: -kv[1])[:k]
        return [[name, us * 1e-6] for name, us in top]

    def top_gaps(self, k: int = 10) -> list[list]:
        """The ``k`` longest idle gaps of the card, each named by the host
        range innermost at its start, in seconds."""
        return [[name, us * 1e-6] for name, us in sorted(self.gaps, key=lambda g: -g[1])[:k]]


def union_length(spans) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def union_intervals(spans) -> list[tuple[float, float]]:
    merged: list[list[float]] = []
    for start, end in sorted(spans):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def short_name(name: str, width: int = 80) -> str:
    """A kernel's name without its argument list, cut to ``width``."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:width]


def _stacks(ranges: list[tuple[float, float, str]], times: list[float]) -> list[tuple[str, ...]]:
    """For each of ``times`` (sorted), the names of the properly nested
    host ``ranges`` open at it, outermost first."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(ranges) and ranges[i][0] <= t:
            while stack and stack[-1][1] <= ranges[i][0]:
                stack.pop()
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(tuple(r[2] for r in stack if r[0] <= t <= r[1]))
    return out


def read_events(events: list[dict]) -> Trace:
    """The ``Trace`` of a Chrome trace's event list (``traceEvents``)."""
    complete = [e for e in events if e.get("ph") == "X" and "ts" in e and "dur" in e]
    marks = [e for e in complete if e.get("name") == WINDOW and e.get("cat") in HOST_CATEGORIES]
    if not marks:
        raise ValueError(f"the trace holds no {WINDOW!r} range")
    w0 = min(float(e["ts"]) for e in marks)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in marks)
    main_tid = marks[0].get("tid")

    launches: dict = {}
    host: dict = {}
    for e in complete:
        cat = e.get("cat")
        if cat == "cuda_runtime" or cat == "cuda_driver":
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (float(e["ts"]), e.get("tid"))
        elif cat in HOST_CATEGORIES:
            host.setdefault(e.get("tid"), []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"]))

    device = []
    for e in complete:
        if e.get("cat") not in DEVICE_CATEGORIES:
            continue
        start, end = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        start, end = max(start, w0), min(end, w1)
        if end <= start:
            continue
        launch = launches.get(e.get("args", {}).get("correlation"))
        device.append((e["name"], start, end, launch))

    # The host stack at each launch, per launching thread.
    by_tid: dict = {}
    for i, (_, _, _, launch) in enumerate(device):
        if launch is not None:
            by_tid.setdefault(launch[1], []).append((launch[0], i))
    stacks: dict[int, tuple[str, ...]] = {}
    for tid, items in by_tid.items():
        items.sort()
        for (_, i), stack in zip(items, _stacks(host.get(tid, []), [t for t, _ in items])):
            stacks[i] = stack
    ops = [DeviceOp(name, start, end, stacks.get(i, ()))
           for i, (name, start, end, _) in enumerate(device)]

    # Idle gaps of the card inside the window, named by the main thread's
    # innermost host range at the gap's start.
    busy = union_intervals([(o.start, o.end) for o in ops])
    gaps, reach = [], w0
    for start, end in busy + [(w1, w1)]:
        if start > reach:
            gaps.append((reach, start - reach))
        reach = max(reach, end)
    main_ranges = [r for r in host.get(main_tid, []) if r[2] != WINDOW]
    names = _stacks(main_ranges, [g[0] for g in gaps])
    named = [(stack[-1] if stack else "host outside any range", length)
             for (_, length), stack in zip(gaps, names)]
    return Trace((w0, w1), ops, named)


def read_trace(path) -> Trace:
    return read_events(json.loads(Path(path).read_text())["traceEvents"])
