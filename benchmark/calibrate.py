"""Readings for the limits of ``correct``: the program on many seeds and
the control (the reference one precision step below the configuration's)
on a few, in one process, at the cell's own sizes.

    python3 benchmark/calibrate.py --workload <cell> --seeds 12 --control-seeds 3 [--seconds 2] [--seed-list a,b]

The control runs on the first ``--control-seeds`` of the seeds, those of
``--seed-list`` first. Prints one JSON line per seed (with each sampled
image's mean |Δ|), then the largest program reading and the smallest
control reading of each number the readings hold (a variant's own
included). The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import torch  # noqa: E402

from harness import check, drivers, reference, spec  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=2**31 + 1000)
    ap.add_argument("--seed-list", default="", help="seeds to read besides the generated ones, comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--precisions", default="", help="more reference precisions to read, comma-separated")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    params = reference.load_bundle(spec.ROOT / cell.config["weights"])
    rows = {"program": [], "control": []}
    seeds = [int(x) for x in args.seed_list.split(",") if x]
    seeds += [args.first_seed + 7919 * i for i in range(args.seeds)]
    for seed in seeds:
        t0 = time.perf_counter()
        d = drivers.make(cell.config, cell.traffic, seed, "cuda")
        w = d.window(args.seconds)
        style, stats, pool = d.style, d.style_stats, d.pool.numpy()
        d.free()
        t1 = time.perf_counter()
        r = check.readings(cell.config, style, stats, w.samples, pool, "cuda", params)
        r.update(seed=seed, kind="program", samples=len(w.samples),
                 run_s=t1 - t0, reference_s=time.perf_counter() - t1)
        rows["program"].append(r)
        print(json.dumps(r), flush=True)
        del d
        torch.cuda.empty_cache()
    extra = [p for p in args.precisions.split(",") if p]
    for seed in seeds[:args.control_seeds]:
        for precision in [cell.config["control_precision"], *extra]:
            t0 = time.perf_counter()
            r = check.control_readings(cell.config, cell.traffic, seed, "cuda", precision, params)
            r.update(seed=seed, kind="control" if precision == cell.config["control_precision"]
                     else precision, s=time.perf_counter() - t0)
            rows.setdefault(r["kind"], []).append(r)
            print(json.dumps(r), flush=True)
    keys = {k for r in rows["program"] + rows["control"] for k, v in r.items()
            if isinstance(v, float) and k not in ("run_s", "reference_s", "s")}
    summary = {k: {"program_max": max((r[k] for r in rows["program"] if k in r), default=None),
                   "control_min": min((r[k] for r in rows["control"] if k in r), default=None)}
               for k in sorted(keys)}
    print(json.dumps({"workload": cell.name, "summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
