"""The WCT stage's reductions, in float32.

Counterpart of ``wct_tpu/ops/reductions.py``, plain forms only. The
JAX package routes these sums through MXU contractions and
optimization barriers so XLA tiles them the same way at every batch
shape; those are XLA-specific and not ported. Here the serving layer
(``cascade.stylize_microbatched``, one fixed batch shape) and cuDNN's
deterministic mode carry the batch-independence guarantee.

Each function takes optional leading batch dims: ``[..., N, C]`` for
the column reductions and ``[..., C, C]`` for the matrix ones. bf16
inputs are summed in f32: ``sum0``/``mean0`` upcast, and
``matmul_f32acc`` multiplies the bf16 operands as they are (every
bf16 × bf16 product is exact in f32) into an f32 result. The Gram is
``ops/gram.py``'s.
"""

from __future__ import annotations

import torch


def has_out_dtype() -> bool:
    """Whether this PyTorch build has ``torch.bmm(..., out_dtype=)``, the
    bf16 × bf16 → f32 product (CUDA only where it exists)."""
    return "dtype" in torch.ops.aten.bmm.overloads()


def matmul_f32acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a [B, M, K] @ b [B, K, N]`` → f32 ``[B, M, N]``, summed in f32.

    The counterpart of ``preferred_element_type=jnp.float32``. bf16
    operands on the card go to cuBLAS as bf16 with an f32 output where
    the build offers it (half the operand bytes); everywhere else both
    are upcast first, which gives the same exact products.
    """
    if (
        a.dtype == b.dtype == torch.bfloat16
        and a.device.type == "cuda"
        and has_out_dtype()
    ):
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def sum0(x: torch.Tensor) -> torch.Tensor:
    """Sum over the N axis of ``[..., N, C]``, accumulated in f32."""
    return x.sum(dim=-2, dtype=torch.float32)


def mean0(x: torch.Tensor) -> torch.Tensor:
    """Mean over the N axis of ``[..., N, C]``."""
    return sum0(x) / x.shape[-2]


def moments0(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, population variance) over the N axis of ``[..., N, C]``, f32.

    Two-pass ``E[(x−μ)²]`` (not ``E[x²]−μ²``), so a large mean does not
    cancel: ``wct_tpu/ops/reductions.py::moments0``, ddof = 0 as
    ``tf.nn.moments``. The plain form: ``gram.moments_cn`` takes it for
    CPU tensors and reads the card's moments off the centred Gram.
    """
    mu = mean0(x)
    centered = x.float() - mu.unsqueeze(-2)
    return mu, mean0(centered * centered)


def vecmat(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``[..., K] @ [..., K, N] → [..., N]``."""
    return (v.float().unsqueeze(-2) @ m.float()).squeeze(-2)


def trace(a: torch.Tensor) -> torch.Tensor:
    """Trace of ``[..., C, C]``."""
    return a.float().diagonal(dim1=-2, dim2=-1).sum(-1)


def inf_norm(a: torch.Tensor) -> torch.Tensor:
    """‖A‖_∞, the largest absolute row sum of ``[..., C, C]``."""
    return a.float().abs().sum(-1).amax(-1)
