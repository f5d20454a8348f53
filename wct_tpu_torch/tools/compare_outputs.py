"""Pixel-parity comparator: two output directories → per-pair metrics.

    python -m wct_tpu_torch.tools.compare_outputs ours/ reference/ [--tol 0.02]

The port of ``wct_tpu/tools/compare_outputs.py``: run two pipelines on
the same content × style set and compare PNG for PNG, matched by file
name. Reports per-pair max-abs-diff, mean-abs-diff and PSNR; exits
non-zero if any pair exceeds ``--tol`` max-abs-diff.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

from wct_tpu_torch.utils import images


def compare_pair(a: np.ndarray, b: np.ndarray) -> dict:
    if a.shape != b.shape:
        return {"shape_mismatch": f"{a.shape} vs {b.shape}"}
    diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
    mse = float(np.mean(diff**2))
    return {
        "max_abs": float(diff.max()),
        "mean_abs": float(diff.mean()),
        "psnr": float("inf") if mse == 0 else 10 * np.log10(1.0 / mse),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("ours")
    p.add_argument("reference")
    p.add_argument("--tol", type=float, default=0.02,
                   help="max-abs-diff gate per image (in [0,1] units)")
    args = p.parse_args(argv)

    ours = {Path(f).name: f for f in images.get_files(args.ours)}
    refs = {Path(f).name: f for f in images.get_files(args.reference)}
    common = sorted(set(ours) & set(refs))
    missing = sorted(set(refs) - set(ours))
    if not common:
        print("no common filenames to compare", file=sys.stderr)
        return 2
    if missing:
        print(f"WARNING: {len(missing)} reference outputs missing from ours: "
              f"{missing[:5]}...", file=sys.stderr)

    failures = 0
    for name in common:
        m = compare_pair(images.get_img(ours[name]), images.get_img(refs[name]))
        if "shape_mismatch" in m:
            print(f"{name}: SHAPE MISMATCH {m['shape_mismatch']}")
            failures += 1
            continue
        ok = m["max_abs"] <= args.tol
        failures += not ok
        print(
            f"{name}: max {m['max_abs']:.4f} mean {m['mean_abs']:.5f} "
            f"psnr {m['psnr']:.1f} dB {'OK' if ok else 'FAIL'}"
        )
    print(f"{len(common) - failures}/{len(common)} within tol={args.tol}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
