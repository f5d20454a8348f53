"""Measure the rate of ``mma.sync`` and ``wgmma`` on the card.

    python -m wct_tpu_torch.tools.profile_mma [--iters 4096] [--waves 24]

Launches ``csrc/mma_rate.cu`` in each of its modes on ``--waves`` blocks
of 256 threads per SM, ``--iters`` steps each, and times the launch with
CUDA events (3 after 1 of warm-up). Prints the card's name and power
limit, then one JSON line per mode with its ms and TFLOP/s:

- ``tf32_m16n8k8``: the instruction the 3xTF32 kernels issue, alone;
- ``bf16_m16n8k16``: the bf16 instruction of the small conv, alone;
- ``3xtf32_kstep``: the kernels' k-step with operands in registers (split
  into hi and lo, three ``mma`` into a fresh partial, the fold);
  ``tflops`` counts its useful work, ``mma_tflops`` the three passes.

Then ``csrc/wgmma_rate.cu``: one block of two warpgroups per SM, each
issuing groups of four ``wgmma`` in the junction kernel's RS form (A in
registers, B through a 128-byte-swizzle descriptor) back to back:

``wgmma_bf16_m64n64k16`` and ``wgmma_tf32_m64n64k8``, the junction's two
instructions (N = 64, its output channels).

Compare with the data-sheet dense rates of the card (H100 SXM: 495 TF32,
989 bf16 TFLOP/s).
"""

from __future__ import annotations

import argparse
import ctypes
import json

import torch

from wct_tpu_torch.ops import _build
from wct_tpu_torch.utils.device import card_name, cuda_ms, resolve_device

THREADS, CHAINS = 256, 8
# mode: (name, useful FLOP per chain and step, mma passes per useful FLOP)
MODES = {
    0: ("tf32_m16n8k8", 2 * 16 * 8 * 8, 1),
    1: ("bf16_m16n8k16", 2 * 16 * 8 * 16, 1),
    2: ("3xtf32_kstep", 2 * 16 * 8 * 8, 3),
}

WGMMA_MODES = ("wgmma_bf16_m64n64k16", "wgmma_tf32_m64n64k8")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--iters", type=int, default=4096)
    ap.add_argument("--waves", type=int, default=24, help="blocks per SM")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    print(card_name(), flush=True)
    blocks = args.waves * torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(blocks * THREADS, dtype=torch.float32, device=dev)
    for mode, (name, flop, passes) in MODES.items():
        def run(mode=mode):
            _build.launch("mma_rate", "mma_rate", "mma_rate",
                          [ctypes.c_void_p] + [ctypes.c_int] * 3,
                          (out.data_ptr(), blocks, args.iters, mode), dev)

        ms = cuda_ms(run, 3, 1)
        useful = blocks * (THREADS // 32) * args.iters * CHAINS * flop
        tflops = useful / ms / 1e9
        print(json.dumps({"mode": name, "blocks": blocks, "iters": args.iters, "ms": ms,
                          "tflops": tflops, "mma_tflops": tflops * passes,
                          "finite": bool(torch.isfinite(out).all())}), flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    flop = _build.load("wgmma_rate").wgmma_rate_flop
    flop.argtypes, flop.restype = [ctypes.c_int], ctypes.c_longlong
    for mode, name in enumerate(WGMMA_MODES):
        def run(mode=mode):
            _build.launch("wgmma_rate", "wgmma_rate", "wgmma_rate",
                          [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 2,
                          (mode, out.data_ptr(), sms, args.iters), dev)

        ms = cuda_ms(run, 3, 1)
        tflops = sms * 2 * args.iters * 4 * flop(mode) / ms / 1e9
        print(json.dumps({"mode": name, "blocks": sms, "iters": args.iters, "ms": ms,
                          "tflops": tflops, "finite": bool(torch.isfinite(out[: sms * THREADS]).all())}),
              flush=True)


if __name__ == "__main__":
    main()
