"""Where a small-conv tile's time goes, per stage, on the card.

    python -m wct_tpu_torch.tools.conv_small_stages [--batch 4] [--height 512] [--width 512]

Builds ``csrc/conv3x3_small.cu`` with ``-DWCT_STAGE_TIMES`` (a library of
its own; the normal build has no stamps), runs the four trained cases of
``tools/profile_conv_small`` through both entries on a seeded batch, and
reads the stamps thread 0 wrote for every tile. Per case and layout it
reports the median µs per tile of each stage, from ``clock64`` scaled
by the tile's own clock (``%globaltimer`` against ``clock64``):

- ``staged``: the wait for the tile's input and, for NCHW and NHWC with
  C_in other than 8, 16, 32, 64, its conversion to the channel-minor tile;
- ``patch``: the edge tiles' halo patch and the barrier before the
  products (the median tile has neither in the NHWC box form);
- ``products``: the ``wgmma``'s;
- ``epilogue``: bias, ReLU and rounding, the output slot's writes, the
  barriers (thread 0 also puts the next input in flight);
- ``store``: thread 0 issuing the TMA stores;
- ``tile``: from a tile's start to the block's next.

Beside them ``sm_ghz``, ms per call of the unstamped and the stamped
build, and the card's name: one JSON line per case and layout.
"""

from __future__ import annotations

import argparse
import json

import ctypes
import numpy as np
import torch

from wct_tpu_torch.ops import _build, conv_small
from wct_tpu_torch.tools.profile_conv_small import case_input, trained_cases
from wct_tpu_torch.utils.device import card_name, cuda_ms, set_bf16_numerics

STAMPS, TILES = 8, 8192  # csrc/conv3x3_small.cu kSmallStamps, kSmallStampTiles
DEFINES = ("WCT_STAGE_TIMES",)
STAGES = ("staged", "patch", "products", "epilogue", "store")


def stage_split(device, launch, runs: int = 3) -> dict:
    """Median µs per tile of each stage: ``launch()`` runs the stamped
    kernel; the last of ``runs`` launches is read."""
    for _ in range(runs):
        launch()
    stamps = torch.zeros((TILES, STAMPS), dtype=torch.int64, device=device)
    fn = _build.load("conv3x3_small", DEFINES).conv3x3_small_stamps
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(stamps.data_ptr(), stamps.numel(), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3_small_stamps failed: CUDA error {err}")
    s = stamps.cpu().numpy().astype(np.float64)
    s = s[s[:, 6] > 0]  # the tiles there are (and no more than TILES of them)
    ns_per_cycle = (s[:, 7] - s[:, 6]) / np.maximum(s[:, 5] - s[:, 0], 1.0)
    out = {f"{name}_us": float(np.median((s[:, i + 1] - s[:, i]) * ns_per_cycle)) / 1e3
           for i, name in enumerate(STAGES)}
    out["tile_us"] = float(np.median(s[:, 7] - s[:, 6])) / 1e3
    out["sm_ghz"] = float(np.median(1.0 / ns_per_cycle))
    out["tiles_stamped"] = int(s.shape[0])
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--width", type=int, default=512)
    args = p.parse_args(argv)
    set_bf16_numerics()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(5)
    for name, wt, bias, relu in trained_cases(dev):
        x = case_input(wt.shape[1], (args.batch, args.height, args.width), gen, dev)
        for nhwc in (True, False):
            xs = x.permute(0, 2, 3, 1).contiguous() if nhwc else x

            def stamped():
                return conv_small._launch("conv_small_stages", xs, wt, bias, relu, nhwc, DEFINES)

            def plain():
                return conv_small.conv3x3_small_cuda(xs, wt, bias, relu, nhwc)

            row = {"case": name, "layout": "nhwc" if nhwc else "nchw", "shape": list(x.shape),
                   "ms_unstamped": cuda_ms(plain, 10), **stage_split(dev, stamped),
                   "ms_stamped": cuda_ms(stamped, 10), "card": card_name()}
            print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
