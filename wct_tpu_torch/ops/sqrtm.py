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
  It is the CPU path, the ``method='newton_schulz'`` path on any device,
  and the reference the CUDA kernel is held against.
- ``ns_sqrtm_cuda``: the hand-written kernel ``csrc/ns_sqrtm.cu``, which
  replaces the TPU kernel ``_sqrtm_pallas``. The design and its bound
  are in the source.

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


def _ns_plain(cov: torch.Tensor, num_iters: int, reg: float):
    c = cov.shape[-1]
    a = cov.float()
    eye = torch.eye(c, dtype=torch.float32, device=a.device)
    a = a + (reg * reductions.trace(a) / c)[..., None, None] * eye
    norm = reductions.inf_norm(a)[..., None, None]  # ‖A‖_∞ ≥ λ_max
    y, z = a / norm, eye.expand_as(a)
    for _ in range(num_iters):
        t = 1.5 * eye - 0.5 * (z @ y)
        y, z = y @ t, t @ z
    sqrt_norm = torch.sqrt(norm)
    return y * sqrt_norm, z / sqrt_norm


def _bind(lib: ctypes.CDLL):
    fn = lib.ns_sqrtm_f32
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


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

    fn = _bind(_build.load("ns_sqrtm"))
    sq = torch.empty_like(cov)
    isq = torch.empty_like(cov)
    work = torch.empty(5 * b * c * c + b, dtype=torch.float32, device=cov.device)
    with torch.cuda.device(cov.device):
        stream = torch.cuda.current_stream(cov.device).cuda_stream
        err = fn(cov.data_ptr(), sq.data_ptr(), isq.data_ptr(), work.data_ptr(),
                 b, c, int(num_iters), float(reg), stream)
    if err != 0:
        raise RuntimeError(f"ns_sqrtm kernel launch failed: CUDA error {err}")
    ns_sqrtm_cuda.launches += 1
    return sq, isq


ns_sqrtm_cuda.launches = 0


def newton_schulz_sqrtm(
    cov: torch.Tensor,
    num_iters: int = DEFAULT_ITERS,
    reg: float = DEFAULT_REG,
    use_kernel: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(cov^{1/2}, cov^{−1/2}) for symmetric PSD ``cov [B, C, C]``.

    ``use_kernel`` selects the CUDA kernel (``method=
    'newton_schulz_pallas'``): a CUDA tensor launches it, a CPU tensor
    takes the plain version, any other device raises.
    """
    if use_kernel and cov.device.type == "cuda":
        return ns_sqrtm_cuda(cov, num_iters, reg)
    if use_kernel and cov.device.type != "cpu":
        raise ValueError(f"no Newton–Schulz kernel for device {cov.device}")
    return _ns_plain(cov, num_iters, reg)
