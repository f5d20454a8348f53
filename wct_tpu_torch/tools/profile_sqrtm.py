"""Time and check the candidates for Newton–Schulz's product on the card.

    python -m wct_tpu_torch.tools.profile_sqrtm [--batch 4]

``method='newton_schulz_fast'`` asks for the cheapest product that still
converges to relative error ≤ 5e-5 at C = 512 (``ops/sqrtm.py``). For
C = 64 … 512, on random SPD matrices of condition number 100, it runs
the plain iteration with each candidate

- ``f32``: ``torch.matmul`` in full f32 (cuBLAS, no TF32),
- ``3xtf32``: ``matmul_3xtf32`` below, three TF32 tensor-core products,
- ``tf32``: one TF32 product, the one that must not be used,

and the hand-written kernel beside them, after a line with the card's
name and power limit, and prints one JSON line each:
ms per call (CUDA events), ``rel_err`` = ‖sqrt − A^{1/2}‖_F / ‖A^{1/2}‖_F
against a float64 eigendecomposition, and ``residual`` =
‖sqrt·sqrt − A‖_F / ‖A‖_F, with A the regularised matrix the iteration
solves for.
"""

from __future__ import annotations

import argparse
import json

import torch

from wct_tpu_torch.ops import sqrtm
from wct_tpu_torch.utils.device import card_name, cuda_ms, resolve_device


def matmul_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An f32-class ``a @ b`` out of three TF32 tensor-core products.

    Each f32 operand splits into ``hi`` (its top 11 significand bits,
    exact in TF32) and ``lo = x − hi``; ``hi·hi + (hi·lo + lo·hi)`` with
    f32 sums drops only ``lo·lo`` (2⁻²² relative) and the rounding of
    ``lo`` to TF32. The card's counterpart of the JAX package's
    ``Precision.HIGH`` (three bf16 passes).
    """
    a_hi = (a.view(torch.int32) & -8192).view(torch.float32)
    b_hi = (b.view(torch.int32) & -8192).view(torch.float32)
    a_lo, b_lo = a - a_hi, b - b_hi
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return a_hi @ b_hi + (a_hi @ b_lo + a_lo @ b_hi)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def sqrt_float64(a: torch.Tensor, reg: float = sqrtm.DEFAULT_REG):
    """``(A_reg^{1/2}, A_reg)`` in float64 for ``a [B, C, C]``: A_reg =
    A + reg·tr(A)/C·I is the matrix the iteration solves for, and its
    square root comes from an eigendecomposition (negative eigenvalues
    clamped to 0)."""
    c = a.shape[-1]
    a64 = a.double()
    shift = reg * a64.diagonal(dim1=-2, dim2=-1).sum(-1) / c
    a64 = a64 + shift[:, None, None] * torch.eye(c, device=a.device, dtype=torch.float64)
    lam, vec = torch.linalg.eigh(a64)
    return (vec * lam.clamp_min(0).sqrt()[:, None, :]) @ vec.mT, a64


def _matmul_tf32(a, b):
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return a @ b
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    print(card_name(), flush=True)
    iters, reg = sqrtm.DEFAULT_ITERS, sqrtm.DEFAULT_REG
    candidates = {
        "f32": lambda a: sqrtm._ns_plain(a, iters, reg, torch.matmul),
        "3xtf32": lambda a: sqrtm._ns_plain(a, iters, reg, matmul_3xtf32),
        "tf32": lambda a: sqrtm._ns_plain(a, iters, reg, _matmul_tf32),
        "kernel": lambda a: sqrtm.ns_sqrtm_cuda(a, iters, reg),
    }
    gen = torch.Generator().manual_seed(0)
    for c in (64, 128, 256, 512):
        q, _ = torch.linalg.qr(torch.randn(args.batch, c, c, generator=gen, dtype=torch.float64))
        eig = torch.logspace(0, -2, c, dtype=torch.float64)
        a = ((q * eig) @ q.mT).float().to(dev).contiguous()
        ref, a64 = sqrt_float64(a, reg)
        for name, fn in candidates.items():
            sq, _ = fn(a)
            torch.cuda.synchronize()
            sq64 = sq.double()
            err = ((sq64 - ref).flatten(1).norm(dim=1) / ref.flatten(1).norm(dim=1)).max()
            res = ((sq64 @ sq64 - a64).flatten(1).norm(dim=1) / a64.flatten(1).norm(dim=1)).max()
            print(json.dumps({"C": c, "B": args.batch, "product": name, "ms": cuda_ms(lambda: fn(a), 10),
                              "rel_err": float(err), "residual": float(res)}), flush=True)


if __name__ == "__main__":
    main()
