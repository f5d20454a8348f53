"""Time the encoder head and the decoder tail kernels per call on the card.

    python -m wct_tpu_torch.tools.profile_head_tail [--rounds 2] [--label this]

At the fused main path's shapes, one 512-px microbatch (head ``[4, 3,
512, 512]``, tail ``[4, 64, 512, 512]``) and the 720p stream's frame
(``[1, 3, 720, 1280]``, ``[1, 64, 720, 1280]``), in f32 and in bf16, on
seeded inputs and random weights at the trained model's scales: each
timing is 20 calls of the wrapper after 2 of warm-up (CUDA events), the
wrapper's own work included, as the cascade calls it. Prints the card's
name and power limit and one JSON line per shape and type.

It uses only the wrappers every slice of the port since the bf16 forms
has, so the same file times an older checkout in the same call (put that
checkout first on ``PYTHONPATH`` and run this file by its path): parent,
change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from wct_tpu_torch.ops import junction
from wct_tpu_torch.utils.device import cuda_ms, set_fp32_numerics

SHAPES = ((4, 512, 512), (1, 720, 1280))


def random_head_weights(device, seed: int = 11) -> list[torch.Tensor]:
    """(we1, be1, w12, b12) for the head: conv1_1 with conv0 folded in at ×255
    as the trained model's, conv1_2 He-scaled."""
    rng = np.random.default_rng(seed)
    out = []
    for co, ci, scale in ((64, 3, 255.0), (64, 64, 1.0)):
        w = rng.standard_normal((co, ci, 3, 3)) * np.sqrt(2.0 / (9 * ci)) * scale
        out += [torch.tensor(w, dtype=torch.float32, device=device),
                torch.tensor(rng.standard_normal(co) * 0.1, dtype=torch.float32, device=device)]
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--label", default="this", help="names the checkout in every line")
    args = ap.parse_args(argv)
    set_fp32_numerics()
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    hw = random_head_weights(dev)
    gen = torch.Generator().manual_seed(5)
    for b, h, w in SHAPES:
        x = torch.rand(b, 3, h, w, generator=gen).to(dev)
        f = torch.rand(b, 64, h, w, generator=gen).to(dev)
        wt = ((torch.rand(b, 3, 64, 3, 3, generator=gen) - 0.5) * 0.2).to(dev)
        bt = torch.rand(b, 3, generator=gen).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            xs, fs = x.to(dtype), f.to(dtype)
            calls = {"head": lambda: junction.encoder_head_cuda(xs, *hw),
                     "tail": lambda: junction.decoder_tail_cuda(fs, wt, bt, False)}
            times = {k: [] for k in calls}
            order = list(calls)
            for r in range(args.rounds):
                for k in (order if r % 2 == 0 else order[::-1]):
                    times[k].append(cuda_ms(calls[k], 20))
            print(json.dumps({"label": args.label, "shape": [b, h, w], "dtype": str(dtype)[6:],
                              **{f"{k}_ms": sum(v) / len(v) for k, v in times.items()},
                              **{f"{k}_ms_rounds": v for k, v in times.items()}}), flush=True)


if __name__ == "__main__":
    main()
