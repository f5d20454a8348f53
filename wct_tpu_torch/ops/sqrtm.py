"""Newton–Schulz matrix square root: the plain version and the CUDA kernel.

Counterpart of ``wct_tpu/ops/sqrtm.py``. The coupled iteration

    A ← A + reg·tr(A)/C·I;   s = ‖A‖_∞;   Y₀ = A/s, Z₀ = I
    T  = ½(3I − Z Y);  Y ← Y T;  Z ← T Z
    A^{1/2} = Y·√s,   A^{−1/2} = Z/√s

gives both WCT kernels from one run (whitening A^{−1/2}, coloring
A^{1/2}). ``reg`` floors the spectrum relative to the mean diagonal and
plays the role of the reference's 1e-5 rank truncation.

Two versions compute it on a batch ``cov [B, C, C]``:

- ``_ns_plain``: batched ``torch.matmul`` in fp32 (``sqrtm.py:116-125``).
  It is the CPU path, the ``method='newton_schulz'`` and
  ``'newton_schulz_fast'`` path on any device (the same product here,
  see ``_PRECISIONS``; ``product`` lets ``tools/profile_sqrtm.py`` time
  the candidates), and the reference the CUDA kernel is held against.
- ``ns_sqrtm_cuda``: the hand-written kernel ``csrc/ns_sqrtm.cu``, which
  replaces the TPU kernel ``_sqrtm_pallas``: 3xTF32 products, on
  ``wgmma`` from operands split once into packed hi/lo forms for
  C > 64 (one launch per call on a cluster of eight blocks up to 128, a
  launch per step's products above), on ``mma.sync`` with the matrices
  resident in one block's shared memory for C <= 64. The design, its
  bound, the padded edge and the workspace it needs are in the source.

``newton_schulz_sqrtm(..., use_kernel=True)`` takes the kernel for a
CUDA tensor and the plain version only for a CPU tensor; there is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from wct_tpu_torch.ops import reductions

# Converged at 12 iterations for C=512 relu-feature Grams at reg=1e-5;
# 14 adds two of margin (wct_tpu/ops/sqrtm.py:53-60).
DEFAULT_ITERS = 14
DEFAULT_REG = 1e-5


def _ns_plain(cov: torch.Tensor, num_iters: int, reg: float, product=torch.matmul):
    c = cov.shape[-1]
    a = cov.float()
    eye = torch.eye(c, dtype=torch.float32, device=a.device)
    a = a + (reg * reductions.trace(a) / c)[..., None, None] * eye
    norm = reductions.inf_norm(a)[..., None, None]  # ‖A‖_∞ ≥ λ_max
    y, z = a / norm, eye.expand_as(a)
    for _ in range(num_iters):
        t = 1.5 * eye - 0.5 * product(z, y)
        y, z = product(y, t), product(t, z)
    sqrt_norm = torch.sqrt(norm)
    return y * sqrt_norm, z / sqrt_norm


def ns_sqrtm_cuda(cov: torch.Tensor, num_iters: int = DEFAULT_ITERS,
                  reg: float = DEFAULT_REG):
    """The CUDA kernel on ``cov [B, C, C]`` (f32, contiguous, on the card).

    Returns ``(sqrt, isqrt)``, each ``[B, C, C]`` f32. Launches on the
    current stream and does not synchronise. Raises on any input the
    kernel does not take, and if the launch fails.
    ``ns_sqrtm_cuda.launches`` counts the calls that launched it.
    """
    if cov.dim() != 3 or cov.shape[1] != cov.shape[2] or cov.shape[1] == 0:
        raise ValueError(f"ns_sqrtm_cuda needs cov [B, C, C], got {tuple(cov.shape)}")
    if cov.dtype != torch.float32:
        raise TypeError(f"ns_sqrtm_cuda needs float32, got {cov.dtype}")
    if cov.device.type != "cuda":
        raise ValueError(f"ns_sqrtm_cuda needs a CUDA tensor, got {cov.device}")
    if not cov.is_contiguous():
        raise ValueError("ns_sqrtm_cuda needs a contiguous tensor")
    b, c, _ = cov.shape
    if not 0 < b <= 32767:
        raise ValueError(f"ns_sqrtm_cuda takes 1..32767 matrices, got {b}")
    if num_iters < 0:
        raise ValueError(f"num_iters must be >= 0, got {num_iters}")
    from wct_tpu_torch.ops import _build

    ptr, integer = ctypes.c_void_p, ctypes.c_int
    workspace_floats = _build.load("ns_sqrtm").ns_sqrtm_workspace_floats
    workspace_floats.argtypes, workspace_floats.restype = [integer, integer], ctypes.c_longlong
    sq = torch.empty_like(cov)
    isq = torch.empty_like(cov)
    work = torch.empty(workspace_floats(b, c), dtype=torch.float32, device=cov.device)
    _build.launch("ns_sqrtm", "ns_sqrtm", "ns_sqrtm_f32",
                  [ptr] * 4 + [integer] * 3 + [ctypes.c_float],
                  (cov.data_ptr(), sq.data_ptr(), isq.data_ptr(),
                   work.data_ptr() if work.numel() else None, b, c,
                   int(num_iters), float(reg)), cov.device)
    ns_sqrtm_cuda.launches += 1
    return sq, isq


ns_sqrtm_cuda.launches = 0


# The values ``precision`` takes. For 'high' two candidates were
# timed on an H100 (tools/profile_sqrtm.py, PERF.md): full-f32 cuBLAS, and
# a split of each operand into two TF32 halves with three tensor-core
# products. At B = 4 the split is 2.4–5.6× slower at every C from 64 to 512
# (three times the launches of a launch-bound loop, plus the splits) and
# misses the bar at C = 512 (residual 5.8e-5), so 'high' is the f32 product
# too and ``newton_schulz_fast`` computes what ``newton_schulz`` computes.
_PRECISIONS = ("highest", "high")


def newton_schulz_sqrtm(
    cov: torch.Tensor,
    num_iters: int = DEFAULT_ITERS,
    reg: float = DEFAULT_REG,
    use_kernel: bool = False,
    precision: str = "highest",
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cov^{1/2}, cov^{−1/2}) for symmetric PSD ``cov [B, C, C]``.

    ``use_kernel`` selects the CUDA kernel (``method=
    'newton_schulz_pallas'``): a CUDA tensor launches it, a CPU tensor
    takes the plain version, any other device raises. The kernel is
    always full f32 and ignores ``precision``, as the TPU kernel does.

    ``precision`` is the plain iteration's product: ``'highest'`` full
    f32, ``'high'`` (``method='newton_schulz_fast'``) the cheapest
    product that still converges to the reference's bar, relative
    error ≤ 5e-5 at C = 512 (``wct_tpu/ops/sqrtm.py:53-58``), which
    plain TF32 and bf16 do not reach. On an H100 that is full f32 as
    well (see ``_PRECISIONS``).
    """
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of {_PRECISIONS}, got {precision!r}")
    if use_kernel and cov.device.type == "cuda":
        return ns_sqrtm_cuda(cov, num_iters, reg)
    if use_kernel and cov.device.type != "cpu":
        raise ValueError(f"no Newton–Schulz kernel for device {cov.device}")
    return _ns_plain(cov, num_iters, reg)
