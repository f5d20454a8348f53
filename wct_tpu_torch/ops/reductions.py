"""The WCT stage's reductions, in float32.

Counterpart of ``wct_tpu/ops/reductions.py``, plain forms only. The
JAX package routes these sums through MXU contractions and
optimization barriers so XLA tiles them the same way at every batch
shape; those are XLA-specific and not ported. Here the serving layer
(``cascade.stylize_microbatched``, one fixed batch shape) and cuDNN's
deterministic mode carry the batch-independence guarantee.

Each function takes optional leading batch dims: ``[..., N, C]`` for
the column reductions and ``[..., C, C]`` for the matrix ones.
"""

from __future__ import annotations

import torch


def sum0(x: torch.Tensor) -> torch.Tensor:
    """Sum over the N axis of ``[..., N, C]``."""
    return x.float().sum(dim=-2)


def mean0(x: torch.Tensor) -> torch.Tensor:
    """Mean over the N axis of ``[..., N, C]``."""
    return sum0(x) / x.shape[-2]


def vecmat(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """``[..., K] @ [..., K, N] → [..., N]``."""
    return (v.float().unsqueeze(-2) @ m.float()).squeeze(-2)


def gram0(x: torch.Tensor) -> torch.Tensor:
    """``xᵀ x`` for ``[..., N, C]``, contracting N."""
    x = x.float()
    return x.mT @ x


def trace(a: torch.Tensor) -> torch.Tensor:
    """Trace of ``[..., C, C]``."""
    return a.float().diagonal(dim1=-2, dim2=-1).sum(-1)


def inf_norm(a: torch.Tensor) -> torch.Tensor:
    """‖A‖_∞, the largest absolute row sum of ``[..., C, C]``."""
    return a.float().abs().sum(-1).amax(-1)
