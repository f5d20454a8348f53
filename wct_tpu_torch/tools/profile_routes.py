"""Time the five cascade routes per 512-px frame on the card, in turns.

    python -m wct_tpu_torch.tools.profile_routes [--rounds 3] [--label this]

Runs ``stylize`` on one microbatch of 4 seeded noise images with a cached
seeded style on the trained bundle, for the f32 unfused route
(``method="newton_schulz_pallas"``), the fused one (``fuse_junction=True``)
the bf16 throughput one (``compute_dtype="bfloat16",
method="newton_schulz_fast", compose_conv0=True``) and the bf16 fused one
(``compute_dtype="bfloat16", method="newton_schulz_fast",
fuse_junction=True``) and that one with AdaIN (``transform="adain"``,
whose moments come from the Gram kernel), in the order f32, fused, bf16,
bf16_fused, adain_bf16_fused, then back, for ``--rounds`` rounds: each timing is 5 calls
after 2 of warm-up (CUDA events), divided by the batch. Prints the card's
name and power limit, one JSON line per timing, and a summary with each
route's mean, minimum and maximum.

It uses only entry points that every slice of the port since the bf16
route has, so the same file can time an older checkout of the package in
the same call (put that checkout first on ``PYTHONPATH`` and run this file
by its path), which is how two commits are compared on one card. A route
the checkout does not carry (its ``CascadeConfig`` raises
``NotImplementedError``) is named in one line and skipped.
"""

from __future__ import annotations

import argparse
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from wct_tpu_torch.models import cascade
from wct_tpu_torch.train import checkpoint
from wct_tpu_torch.utils.device import cuda_ms, resolve_device

SIZE, BATCH, ALPHA = 512, 4, 0.6
ROUTES = {
    "f32": dict(method="newton_schulz_pallas"),
    "fused": dict(method="newton_schulz_pallas", fuse_junction=True),
    "bf16": dict(compute_dtype="bfloat16", method="newton_schulz_fast", compose_conv0=True),
    "bf16_fused": dict(compute_dtype="bfloat16", method="newton_schulz_fast", fuse_junction=True),
    "adain_bf16_fused": dict(compute_dtype="bfloat16", method="newton_schulz_fast",
                             fuse_junction=True, transform="adain"),
}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--weights", default=str(Path(__file__).resolve().parents[2] / "weights" / "bundle.npz"))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--label", default="this", help="names the checkout in every line")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    # The query of utils.device.card_name, written out: older checkouts lack it.
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    params = checkpoint.params_from_numpy(checkpoint.load_pytree(args.weights), dev)
    rng = np.random.default_rng(0)
    batch = torch.as_tensor(rng.random((BATCH, SIZE, SIZE, 3)).astype(np.float32), device=dev)
    style = rng.random((SIZE, SIZE, 3)).astype(np.float32)
    runs = {}
    for name, kw in ROUTES.items():
        try:
            cfg = cascade.CascadeConfig(**kw)
        except NotImplementedError as e:
            print(json.dumps({"label": args.label, "route": name, "skipped": str(e)}), flush=True)
            continue
        cache = cascade.precompute_style(params["encoder"], style, cfg)
        runs[name] = (lambda cfg=cfg, cache=cache: cascade.stylize(params, batch, cache, ALPHA, cfg))
    times = {name: [] for name in runs}
    order = list(runs)
    for r in range(args.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            ms = cuda_ms(runs[name], 5) / BATCH
            times[name].append(ms)
            print(json.dumps({"label": args.label, "round": r, "route": name,
                              "ms_per_frame_b4": ms}), flush=True)
    print(json.dumps({"label": args.label, "summary": {
        name: {"mean": sum(t) / len(t), "min": min(t), "max": max(t)} for name, t in times.items()}}),
        flush=True)


if __name__ == "__main__":
    main()
