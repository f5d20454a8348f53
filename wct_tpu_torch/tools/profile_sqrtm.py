"""Time and check the candidates for Newton–Schulz's product on the card.

    python -m wct_tpu_torch.tools.profile_sqrtm [--batch 4]
    python -m wct_tpu_torch.tools.profile_sqrtm --levels

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

``--levels`` times the kernel alone at the main path's cases instead: C =
64, 128, 256, 512 (relu1_1 … relu4_1; relu5_1 is 512 again) at B = 4 (a
content microbatch) and B = 1 (the style), on the same random SPD
matrices. Per case: ms per call (CUDA events), the kernel launches one
call makes and their summed device time (``torch.profiler``), and
``gap_ms`` = ms − that time, what the card spends between a call's
launches (the tiled route, C > 128, launches two kernels per step).
Then the same for the centred Gram that feeds each level
(``ops/gram.py::centered_gram_cn`` on seeded ReLU-like bf16 maps of the
512-px levels' shapes, N = 262,144 … 1,024; relu1_1 in f32 too) and for
the grouped shapes four groups give at relu1_1 and relu2_1. Run the file
by its path with an older checkout first on ``PYTHONPATH`` to time that
checkout's kernels the same way.
"""

from __future__ import annotations

import argparse
import json

import torch

from wct_tpu_torch.ops import gram, sqrtm
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


def _spd(b: int, c: int, gen: torch.Generator, dev) -> torch.Tensor:
    """``[b, c, c]`` random SPD f32 on ``dev``, eigenvalues 1 … 1e-2."""
    q, _ = torch.linalg.qr(torch.randn(b, c, c, generator=gen, dtype=torch.float64))
    eig = torch.logspace(0, -2, c, dtype=torch.float64)
    return ((q * eig) @ q.mT).float().to(dev).contiguous()


def launches_and_device_ms(fn, calls: int = 3) -> tuple[float | None, float | None]:
    """Kernels one ``fn()`` launches on the card and their summed device
    ms, from a profiler trace of ``calls`` warm calls; ``(None, None)``
    where the trace holds no device event."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        return None, None
    device_ms = sum(e.time_range.end - e.time_range.start for e in kernels) / 1e3
    return len(kernels) / calls, device_ms / calls


# The Gram's inputs at 512 px: (level, C, N).
GRAM_LEVELS = (("relu1_1", 64, 262144), ("relu2_1", 128, 65536), ("relu3_1", 256, 16384),
               ("relu4_1", 512, 4096), ("relu5_1", 512, 1024))


def _timed(row: dict, call) -> None:
    ms = cuda_ms(call, 20)
    launches, device_ms = launches_and_device_ms(call)
    row.update(ms=ms, launches=launches, device_ms=device_ms,
               gap_ms=None if device_ms is None else ms - device_ms)
    print(json.dumps(row), flush=True)


def per_level(dev) -> None:
    iters, reg = sqrtm.DEFAULT_ITERS, sqrtm.DEFAULT_REG
    gen = torch.Generator().manual_seed(0)
    for c in (64, 128, 256, 512):
        for b in (4, 1):
            a = _spd(b, c, gen, dev)
            _timed({"kernel": "ns_sqrtm", "C": c, "B": b},
                   lambda: sqrtm.ns_sqrtm_cuda(a, iters, reg))
    shapes = [(level, b, c, n, torch.bfloat16) for level, c, n in GRAM_LEVELS for b in (4, 1)]
    shapes += [("relu1_1", 4, 64, 262144, torch.float32),
               ("relu1_1_groups4", 16, 16, 262144, torch.bfloat16),
               ("relu2_1_groups4", 16, 32, 65536, torch.bfloat16)]
    for level, b, c, n, dtype in shapes:
        x = torch.relu(torch.randn(b, c, n, generator=gen) - 0.7388).to(dtype).to(dev)
        _timed({"kernel": "centered_gram", "level": level, "shape": [b, c, n],
                "dtype": str(dtype).split(".")[-1]}, lambda: gram.centered_gram_cn(x))
        del x


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--levels", action="store_true",
                    help="time the kernel alone at the main path's cases, with launches and gaps")
    args = ap.parse_args(argv)
    dev = resolve_device("cuda")
    print(card_name(), flush=True)
    if args.levels:
        per_level(dev)
        return
    iters, reg = sqrtm.DEFAULT_ITERS, sqrtm.DEFAULT_REG
    candidates = {
        "f32": lambda a: sqrtm._ns_plain(a, iters, reg, torch.matmul),
        "3xtf32": lambda a: sqrtm._ns_plain(a, iters, reg, matmul_3xtf32),
        "tf32": lambda a: sqrtm._ns_plain(a, iters, reg, _matmul_tf32),
        "kernel": lambda a: sqrtm.ns_sqrtm_cuda(a, iters, reg),
    }
    gen = torch.Generator().manual_seed(0)
    for c in (64, 128, 256, 512):
        a = _spd(args.batch, c, gen, dev)
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
