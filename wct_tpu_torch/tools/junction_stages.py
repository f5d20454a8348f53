"""Where a junction tile's time goes, per stage, on the card.

    python -m wct_tpu_torch.tools.junction_stages [--dtype bfloat16] [--batch 4] [--size 512]
        [--shallow]

Builds ``csrc/junction.cu`` with ``-DWCT_STAGE_TIMES``, runs it on one
decoder state ``d [B, 64, size/2, size/2]`` (the main path's
``[4, 64, 256, 256]`` by default; random data, random weights at the
trained model's scales) and reads the stamps that thread 0 of every
block wrote. Per tile (one block, which has its SM to itself) it reports
the median µs of each stage, as ``%globaltimer`` reads them:

- ``d_tile``: the index tables, the barriers and the d tile's load;
- ``m_conv``: the decoder's 64→64 conv over the 22×22 region, to its
  last store;
- ``m_halo``: the reflection fix of m's halo (block barriers);
- ``rgb``: the 64→3 stage and its halo fix, split into
  ``rgb_weights`` (waiting for the FFMA stages' weights), ``rgb_compute``
  and ``rgb_halo``;
- ``e1``: the 3→64 stage and its halo fix (shallow: its store);
- ``conv1_2_pool``: conv1_2, the ReLU, the pool and the store;

and ``weight_wait``: the time thread 0 spent waiting for weight chunks
in the m conv and for the FFMA stages' weights (each chunk's mbarrier),
``conv1_2_weight_wait`` for conv1_2's chunks and ``weight_release``,
handing slots back, from ``clock64`` scaled to the tile's ns, and the SM
clock that scaling implies (``sm_ghz``). Beside the split: ms per launch
of the unstamped build, the shared-memory plan, and the distance from a
float64 evaluation of the same chain (f32: max |Δ| over max |ref|;
bf16: the shares bitwise and within one bf16 ulp, as ``chip_smoke.py``
gates them). The stamped build is a library of its own; its launches
are not counted by the wrapper. Prints one JSON line with the card's
name.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import numpy as np
import torch

from wct_tpu_torch.ops import _build, junction
from wct_tpu_torch.utils.device import card_name, cuda_ms, set_fp32_numerics

STAGES = ("d_tile", "m_conv", "m_halo", "rgb", "e1", "conv1_2_pool")
STAMPS = 14  # per block: csrc/junction.cu kStamps
DEFINES = ("WCT_STAGE_TIMES",)


def random_weights(seed: int = 11, device="cuda") -> list[torch.Tensor]:
    """(wd1, bd1, wd2, bd2, we1, be1, w12, b12): He-scaled convs, conv1_1
    (conv0 folded in) at ×255 as the trained model's."""
    rng = np.random.default_rng(seed)
    out = []
    for co, ci, scale in ((64, 64, 1.0), (3, 64, 1.0), (64, 3, 255.0), (64, 64, 1.0)):
        w = rng.standard_normal((co, ci, 3, 3)) * np.sqrt(2.0 / (9 * ci)) * scale
        out += [torch.tensor(w, dtype=torch.float32, device=device),
                torch.tensor(rng.standard_normal(co) * 0.1, dtype=torch.float32, device=device)]
    return out


def stage_split(d: torch.Tensor, weights, deep: bool = True, clip: bool = False,
                runs: int = 3) -> dict:
    """Median µs per tile of each stage of the junction kernel on ``d``,
    from the stamped build; the last of ``runs`` launches is read."""
    for _ in range(runs):
        junction._junction_launch("junction_stages", d, *weights, deep, clip, defines=DEFINES)
    b, _, h, w = d.shape
    blocks = b * (2 * h // junction.TILE) * (2 * w // junction.TILE)
    stamps = torch.empty((blocks, STAMPS), dtype=torch.int64, device=d.device)
    fn = _build.load("junction", DEFINES).junction_stamps
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(stamps.data_ptr(), stamps.numel(), torch.cuda.current_stream(d.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"junction_stamps failed: CUDA error {err}")
    s = stamps.cpu().numpy().astype(np.float64)
    if not (s[:, 0] > 0).all():
        raise RuntimeError("junction: a block wrote no stamps")
    t = s[:, :7]
    ns_per_cycle = (t[:, 6] - t[:, 0]) / np.maximum(s[:, 8] - s[:, 7], 1.0)
    spans = {name: t[:, i + 1] - t[:, i] for i, name in enumerate(STAGES)}
    spans.update(rgb_weights=s[:, 10] - t[:, 3], rgb_compute=s[:, 11] - s[:, 10],
                 rgb_halo=t[:, 4] - s[:, 11])
    spans["weight_wait"] = s[:, 9] * ns_per_cycle
    spans["conv1_2_weight_wait"] = np.maximum(s[:, 12] - s[:, 9], 0) * ns_per_cycle
    spans["weight_release"] = s[:, 13] * ns_per_cycle
    spans["tile"] = t[:, 6] - t[:, 0]
    out = {f"{k}_us": float(np.median(v)) / 1e3 for k, v in spans.items()}
    out["sm_ghz"] = float(np.median(1.0 / ns_per_cycle))
    out["tiles"] = blocks
    out["kernel_span_ms"] = float(t[:, 6].max() - t[:, 0].min()) / 1e6
    return out


def vs_float64(got: torch.Tensor, d: torch.Tensor, weights, deep: bool, clip: bool) -> dict:
    """``got`` against a float64 evaluation of the junction's chain (bf16:
    of its one-rounding rule, ``_junction_plain(acc=torch.float64)``)."""
    if d.dtype == torch.bfloat16:
        ref = junction._junction_plain(d, *weights, deep, clip, acc=torch.float64).float()
        diff = (got.float() - ref).abs()
        excess = diff - (2.0**-7 * ref.abs() + 1e-5 * ref.abs().max())
        return {"bitwise": float((diff == 0).float().mean()),
                "within_ulp": float((excess <= 0).float().mean()),
                "rel_max": float(diff.max() / ref.abs().max())}
    ref = junction._junction_plain(d.double(), *[w.double() for w in weights], deep, clip)
    return {"rel_max": float((got.double() - ref).abs().max() / ref.abs().max())}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="float32")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--size", type=int, default=512, help="full-resolution edge (d is half of it)")
    p.add_argument("--shallow", action="store_true")
    args = p.parse_args(argv)
    set_fp32_numerics()
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    half = args.size // 2
    d = (torch.rand(args.batch, 64, half, half, generator=gen) * 4).to(dev, getattr(torch, args.dtype))
    weights = random_weights(device=dev)
    deep = not args.shallow
    row = stage_split(d, weights, deep=deep)

    def launch():
        return junction._junction_launch("junction", d, *weights, deep, False)

    row["ms"] = cuda_ms(launch, iters=10)
    row["vs_float64"] = vs_float64(launch(), d, weights, deep, False)
    row.update(dtype=args.dtype, shape=list(d.shape),
               plan=list(junction.kernel_plan("junction", d.dtype)), card=card_name())
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
