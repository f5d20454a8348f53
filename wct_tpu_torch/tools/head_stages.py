"""Where an encoder-head tile's time goes, per stage, on the card.

    python -m wct_tpu_torch.tools.head_stages [--dtype bfloat16] [--batch 4] [--height 512]
        [--width 512]

Builds ``csrc/encoder_head.cu`` with ``-DWCT_STAGE_TIMES`` (a library of
its own; the normal build has no stamps), runs it on a seeded image batch ``[B, 3, H, W]`` with random weights at the trained
model's scales, and reads the stamps thread 0 wrote for every tile. Per
tile it reports the median µs of each stage, as ``%globaltimer`` reads
them:

- ``rgb``: from the tile's start until its rgb tile is in shared memory
  (bf16: converted to f32); in the persistent kernel the copies were
  issued during the previous tile's conv1_2, so this is what is left of
  their wait;
- ``e1``: the 3→64 stage and e1's halo fix;
- ``conv1_2_pool``: conv1_2 on ``wgmma``, the ReLU, the pool and the
  store;

``weight_wait``: the ``clock64`` cycles thread 0 spent waiting for
conv1_2's weight chunks, scaled to ns by the tile's own clock, and
``sm_ghz``, that clock. Beside them: the tiles, the blocks' span, ms per
launch of the unstamped build and the shared-memory plan. Prints one
JSON line with the card's name.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch

from wct_tpu_torch.ops import _build, junction
from wct_tpu_torch.tools.profile_head_tail import random_head_weights
from wct_tpu_torch.utils.device import card_name, cuda_ms, set_fp32_numerics

STAMPS = 7  # per tile: csrc/encoder_head.cu kHeadStamps
DEFINES = ("WCT_STAGE_TIMES",)
STAGES = ("rgb", "e1", "conv1_2_pool")


def stage_split(x: torch.Tensor, launch, lib, runs: int = 3) -> dict:
    """Median µs per tile of each stage of the head on ``x``: ``launch()``
    runs the stamped kernel, ``lib`` is its loaded library; the last of
    ``runs`` launches is read."""
    for _ in range(runs):
        launch()
    stamps = torch.zeros((8192, STAMPS), dtype=torch.int64, device=x.device)
    fn = lib.encoder_head_stamps
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(stamps.data_ptr(), stamps.numel(), torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"encoder_head_stamps failed: CUDA error {err}")
    s = stamps.cpu().numpy().astype(np.float64)
    s = s[s[:, 0] > 0]  # the tiles there are (and no more than 8192 of them)
    ns_per_cycle = (s[:, 3] - s[:, 0]) / np.maximum(s[:, 5] - s[:, 4], 1.0)
    spans = {name: s[:, i + 1] - s[:, i] for i, name in enumerate(STAGES)}
    spans["weight_wait"] = s[:, 6] * ns_per_cycle
    spans["tile"] = s[:, 3] - s[:, 0]
    out = {f"{k}_us": float(np.median(v)) / 1e3 for k, v in spans.items()}
    out["sm_ghz"] = float(np.median(1.0 / ns_per_cycle))
    out["tiles_stamped"] = int(s.shape[0])
    out["kernel_span_ms"] = float(s[:, 3].max() - s[:, 0].min()) / 1e6
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    args = p.parse_args(argv)
    set_fp32_numerics()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    x = torch.rand(args.batch, 3, args.height, args.width, generator=gen).to(
        dev, getattr(torch, args.dtype))
    we1, be1, w12, b12 = random_head_weights(dev)
    lib = _build.load("encoder_head", DEFINES)

    def stamped():
        return junction._head_launch("head_stages", x, we1, be1, w12, b12, DEFINES)

    def plain():
        return junction.encoder_head_cuda(x, we1, be1, w12, b12)

    row = stage_split(x, stamped, lib)
    row["ms_unstamped"] = cuda_ms(plain, iters=10)
    row["ms_stamped"] = cuda_ms(stamped, iters=10)
    row.update(dtype=args.dtype, shape=list(x.shape), card=card_name(),
               plan=list(junction.kernel_plan("encoder_head", x.dtype)))
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
