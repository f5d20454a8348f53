"""Time the small-channel conv kernel per call on the card, in both layouts.

    python -m wct_tpu_torch.tools.profile_conv_small [--rounds 2] [--label this]

The four trained cases of the bf16 throughput cascade (3→64 + ReLU, the
encoder's conv1_2 and decoder relu2_1's ``dec_conv1_2`` 64→64 + ReLU,
``dec_conv1_1`` 64→3) at one 512-px microbatch (``[4, ·, 512, 512]``) and
the 720p stream's frame (``[1, ·, 720, 1280]``), on seeded inputs (an image
in [0, 1], ReLU maps) and random weights at the trained scales
(``profile_head_tail.random_head_weights``: the 3→64 conv with conv0 folded
in, He-scaled 64→64, its first three rows for 64→3). Each timing is 20
calls of the wrapper after 2 of warm-up (CUDA events), the wrapper's own
work included; beside them one cuDNN bf16 ``F.conv2d`` on the padded map
(+ ReLU), the yardstick no route calls. Prints the card's name and power
limit and one JSON line per shape and case.

It uses only the wrappers every slice of the port since the small conv
has, so the same file times an older checkout in the same call (put that
checkout first on ``PYTHONPATH`` and run this file by its path): parent,
change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

from wct_tpu_torch.ops import conv_small
from wct_tpu_torch.tools.profile_head_tail import random_head_weights
from wct_tpu_torch.utils.device import cuda_ms, set_bf16_numerics

SHAPES = ((4, 512, 512), (1, 720, 1280))


def trained_cases(device) -> list[tuple]:
    """(name, OIHW weights, bias, relu) of the four trained cases, random
    weights at the trained scales."""
    we1, be1, w12, b12 = random_head_weights(device)
    return [("3to64_relu", we1, be1, True), ("conv1_2_64to64_relu", w12, b12, True),
            ("dec_conv1_2_64to64_relu", w12, b12, True),
            ("dec_conv1_1_64to3", w12[:3].contiguous(), b12[:3].contiguous(), False)]


def case_input(cin: int, shape: tuple, gen: torch.Generator, device) -> torch.Tensor:
    """NCHW bf16 input of a case: an image in [0, 1] (3 channels) or a ReLU map."""
    b, h, w = shape
    x = torch.rand(b, cin, h, w, generator=gen) if cin == 3 else torch.randn(b, cin, h, w, generator=gen).relu()
    return x.to(torch.bfloat16).to(device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--label", default="this", help="names the checkout in every line")
    args = ap.parse_args(argv)
    set_bf16_numerics()
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    gen = torch.Generator().manual_seed(5)
    for b, h, w in SHAPES:
        for name, wt, bias, relu in trained_cases(dev):
            x = case_input(wt.shape[1], (b, h, w), gen, dev)
            x_nhwc = x.permute(0, 2, 3, 1).contiguous()
            xp = F.pad(x, (1, 1, 1, 1), mode="reflect")
            w16, b16 = wt.to(torch.bfloat16), bias.to(torch.bfloat16)
            calls = {"nhwc": lambda: conv_small.conv3x3_reflect_small(x_nhwc, wt, bias, relu),
                     "nchw": lambda: conv_small.conv3x3_reflect_small_nchw(x, wt, bias, relu),
                     "cudnn": (lambda: F.conv2d(xp, w16, b16).relu()) if relu else (lambda: F.conv2d(xp, w16, b16))}
            times = {k: [] for k in calls}
            order = list(calls)
            for r in range(args.rounds):
                for k in (order if r % 2 == 0 else order[::-1]):
                    times[k].append(cuda_ms(calls[k], 20))
            print(json.dumps({"label": args.label, "shape": [b, h, w], "case": name,
                              **{f"{k}_ms": sum(v) / len(v) for k, v in times.items()},
                              **{f"{k}_ms_rounds": v for k, v in times.items()}}), flush=True)


if __name__ == "__main__":
    main()
