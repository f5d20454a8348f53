"""Run one cell of the benchmark of ``wct_tpu_torch`` on this machine's card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up (loading, the kernels' build on a
checkout's first run, the style, the input pool, warming every shape the
cell sends) is ``setup_s``; then the cell's traffic runs for ``--seconds``
and its end-to-end metrics are taken (``--trace 0``), or, with
``--trace 1``, the same window runs untraced for the host's numbers and a
bounded traced segment follows for the card's (the per-layer metrics).
After the window the program's state is freed, its sampled outputs are
held against the float64 reference, and the last line of standard output
is one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``, each
number compared beside its limit (also the last lines of standard
error). Earlier lines record the card, the conv choices and the
allocator.

Exits non-zero, printing no result, without a CUDA card or with fewer
cards than the cell asks for, and if the JAX package or JAX is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from harness import check, costs, peaks, spec, tracing  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "wct_tpu")


def loaded_forbidden() -> list[str]:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (``wct_tpu_torch`` is the port, not ``wct_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> dict:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,"
         "power.draw,temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return {"nvidia_smi": out.stdout.strip().splitlines()}


def allocator_line() -> dict:
    s = torch.cuda.memory_stats()
    return {"peak_allocated_bytes": s.get("allocated_bytes.all.peak", 0),
            "peak_reserved_bytes": s.get("reserved_bytes.all.peak", 0),
            "reserved_bytes": s.get("reserved_bytes.all.current", 0),
            "alloc_retries": s.get("num_alloc_retries", 0)}


def enqueue_summary(warmup_s: list[float], window_s: list[float]) -> dict:
    """The host's time to enqueue a job: the last warm-up job's, and the
    median of each quarter of the window's jobs, in ms (a host that
    drifts shows here)."""
    quarters = [q for q in np.array_split(np.asarray(window_s) * 1e3, 4) if q.size]
    return {"warmup_last": warmup_s[-1] * 1e3 if warmup_s else None,
            "window_quarters_p50": [float(np.median(q)) for q in quarters]}


def end_to_end(cell: spec.Cell, w, setup_s: float) -> dict:
    have = {
        "setup_s": (setup_s, "s"),
        "frames_per_s": (w.delivered / w.seconds, "frames/s"),
    }
    return {m["name"]: {"value": have[m["name"].split(".")[0]][0], "unit": m["unit"]}
            for m in cell.end_to_end}


class Context:
    """What a per-layer metric's reader gets: the traced segment, the
    untraced window's host numbers, the program's counters over the traced
    segment (the fixed ones and those the cell's readers declare; one
    whose path does not resolve is absent), the cell's files, the card's
    peaks and the cost model."""

    def __init__(self, cell, window, trace, images_traced, counts, device_name):
        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.window, self.trace = window, trace
        self.images_traced, self.counts = images_traced, counts
        self.device_name = device_name
        self.peaks = peaks.card_peaks(device_name)
        self.peak = peaks.arithmetic_peak(device_name, cell.config["precision"])
        self.costs = costs


def traced_segment(cell, driver, device_name, window) -> tuple[dict, dict, dict]:
    from harness import program

    declared = spec.declared_counters(cell.per_layer)
    before = program.counters(declared)
    tmp = Path(tempfile.mkdtemp(prefix="wct_bench_trace_"))
    path = tmp / "trace.json"
    try:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        prof.start()
        try:
            images = driver.traced(int(cell.traffic["trace_jobs"]))
        finally:
            prof.stop()
        prof.export_chrome_trace(str(path))
        print(json.dumps({"trace_bytes": path.stat().st_size}), flush=True)
        trace = tracing.read_trace(path)
    finally:
        if path.exists():
            path.unlink()
        tmp.rmdir()
    after = program.counters(declared)
    counts = {k: after[k] - before[k] for k in after
              if after[k] is not None and before[k] is not None}
    ctx = Context(cell, window, trace, images, counts, device_name)
    metrics = {}
    for m in cell.per_layer:
        value = spec.metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = {"busy_s": trace.busy_s, "window_s": trace.window_s}
    breakdown = {"device_ops": trace.top_ops(10), "idle_gaps": trace.top_gaps(10)}
    return metrics, device, breakdown


def measure(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: str = "cuda") -> dict:
    """Set up, run the window, read the metrics and check the outputs: the
    result line's object. ``device="cpu"`` runs the same path on the CPU
    (the tests do, at small sizes); a run of the benchmark is on the card."""
    from harness import drivers, program

    card = device != "cpu"
    device_name = torch.cuda.get_device_name(0) if card else "cpu"
    if card:
        print(json.dumps({"card": card_line(), "kind": device_name, "torch": torch.__version__,
                          "cuda": torch.version.cuda, "cudnn": torch.backends.cudnn.version()}),
              flush=True)
    driver = drivers.make(cell.config, cell.traffic, seed, device)
    driver.sync()
    setup_s = time.perf_counter() - T_START
    print(json.dumps({"setup_s": setup_s, "conv_choices": program.conv_choices() if card else {}}),
          flush=True)

    w = driver.window(seconds)
    driver.sync()
    memory_peak = torch.cuda.max_memory_allocated() if card else 0
    if trace:
        metrics, device_extra, breakdown = traced_segment(cell, driver, device_name, w)
    else:
        metrics, device_extra, breakdown = end_to_end(cell, w, setup_s), {}, None
    print(json.dumps({"window_s": w.seconds, "attempted": w.attempted, "delivered": w.delivered,
                      "enqueue_ms": enqueue_summary(driver.warmup.enqueue_s, w.enqueue_s),
                      "allocator": allocator_line() if card else {},
                      "card_after": card_line() if card else {}}), flush=True)

    style, stats, pool = driver.style, driver.style_stats, driver.pool.numpy()
    driver.free()
    values = check.readings(cell.config, style, stats, w.samples, pool, device)
    print(json.dumps({"readings": values, "samples": [i for i, _ in w.samples]}), flush=True)
    failed = w.attempted - w.delivered
    correct, checks = check.judge(values, cell.limits, failed, len(w.samples))
    result = {"correct": correct, "attempted": w.attempted, "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if card else "cpu", "kind": device_name, "count": 1,
                         "memory_peak_bytes": int(memory_peak), **device_extra}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("benchmark: torch.cuda.is_available() is False; this benchmark needs a CUDA card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} cards, this machine has "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = measure(cell, args.seed, args.seconds, bool(args.trace))
    found = loaded_forbidden()
    if found:
        print(f"benchmark: loaded {found}; nothing the benchmark runs may load them",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
