"""Adaptive instance normalisation (AdaIN), per-channel moment matching.

Counterpart of ``wct_tpu/ops/adain.py``:

    out = σ_s · (f_c − μ_c) / σ_c + μ_s,   blended α·out + (1−α)·f_c

with σ = √(var + 1e-5) and population variances. The moments are
``gram.moments_cn``'s: on the card the mean and the diagonal of the
centred-Gram kernel, on the CPU the plain two-pass.

The public functions keep the JAX package's single-image ``[H, W, C]``
layout; the cascade calls the ``*_cn`` forms on channel-major
``x [B, C, N]``. Inputs are f32 or bf16, the arithmetic is f32, and a
result comes back in its input's type.
"""

from __future__ import annotations

import dataclasses

import torch

from wct_tpu_torch.ops import gram
from wct_tpu_torch.utils.device import scalar_on

# The reference's eps inside the variance normalisation (ops.py:~45).
DEFAULT_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class AdainStats:
    """Cacheable per-level style moments: channel mean and std, ``[C]`` each."""

    mean: torch.Tensor
    std: torch.Tensor


def _cn(f: torch.Tensor) -> torch.Tensor:
    """One image ``[H, W, C]`` → channel-major batch of one ``[1, C, N]``."""
    return f.reshape(-1, f.shape[-1]).mT[None]


def adain_stats_cn(x: torch.Tensor, eps: float = DEFAULT_EPS) -> AdainStats:
    """Moments of one style image, channel-major ``x [1, C, N]``."""
    mean, var = gram.moments_cn(x)
    return AdainStats(mean=mean[0], std=torch.sqrt(var[0] + eps))


def adain_stats(fs: torch.Tensor, eps: float = DEFAULT_EPS) -> AdainStats:
    """Channel mean and std of style features ``fs [H, W, C]``."""
    return adain_stats_cn(_cn(fs), eps)


def adain_transform_cn(
    x: torch.Tensor, stats: AdainStats, alpha: torch.Tensor | float = 1.0,
    eps: float = DEFAULT_EPS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """AdaIN of ``x [B, C, N]`` as per-image diagonal affines
    ``(scale [B, C], bias [B, C])``, f32, with α folded in:
    ``x·scale + bias`` is ``adain_from_stats_cn``. The cascade folds it
    into the relu1_1 decoder conv (``models/decoder.py::fold_affine_into_conv``).
    """
    return adain_affine_from_moments(*gram.moments_cn(x), stats, alpha, eps)


def adain_affine_from_moments(
    mu_c: torch.Tensor, var_c: torch.Tensor, stats: AdainStats,
    alpha: torch.Tensor | float = 1.0, eps: float = DEFAULT_EPS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``adain_transform_cn`` from the content's moments (``mu_c``,
    population ``var_c``, ``[B, C]`` each), as ``gram.moments_cn`` gives
    them or as the height-sharded cascade combines them."""
    s = stats.std.float() * torch.rsqrt(var_c + eps)
    alpha = scalar_on(alpha, mu_c.device)
    scale = alpha * s + (1.0 - alpha)
    bias = alpha * (stats.mean.float() - s * mu_c)
    return scale, bias


def adain_transform(
    fc: torch.Tensor, stats: AdainStats, alpha: torch.Tensor | float = 1.0,
    eps: float = DEFAULT_EPS,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``adain_transform_cn`` of one image ``fc [H, W, C]``: ``(scale [C], bias [C])``."""
    scale, bias = adain_transform_cn(_cn(fc), stats, alpha, eps)
    return scale[0], bias[0]


def adain_from_stats_cn(
    x: torch.Tensor, stats: AdainStats, alpha: torch.Tensor | float = 1.0,
    eps: float = DEFAULT_EPS,
) -> torch.Tensor:
    """AdaIN of content ``x [B, C, N]`` with cached style moments → ``[B, C, N]``
    in ``x``'s type (``wct_tpu/ops/adain.py:46-59``)."""
    return adain_apply_cn(x, *gram.moments_cn(x), stats, alpha, eps)


def adain_apply_cn(
    x: torch.Tensor, mu_c: torch.Tensor, var_c: torch.Tensor, stats: AdainStats,
    alpha: torch.Tensor | float = 1.0, eps: float = DEFAULT_EPS,
) -> torch.Tensor:
    """``adain_from_stats_cn`` with the content's moments given
    (``mu_c``, population ``var_c``, ``[B, C]`` each): the height-sharded
    cascade (``parallel.mesh``) combines them over its shards."""
    f32 = x.float()
    out = (stats.std.float()[:, None] * (f32 - mu_c[..., None]) * torch.rsqrt(var_c + eps)[..., None]
           + stats.mean.float()[:, None])
    alpha = scalar_on(alpha, x.device)
    return (alpha * out + (1.0 - alpha) * f32).to(x.dtype)


def adain_from_stats(
    fc: torch.Tensor, stats: AdainStats, alpha: torch.Tensor | float = 1.0,
    eps: float = DEFAULT_EPS,
) -> torch.Tensor:
    """AdaIN of one image's content features ``fc [H, W, C]`` → ``[H, W, C]``."""
    out = adain_from_stats_cn(_cn(fc), stats, alpha, eps)
    return out[0].mT.reshape(fc.shape)


def adain(
    fc: torch.Tensor, fs: torch.Tensor, alpha: torch.Tensor | float = 1.0,
    eps: float = DEFAULT_EPS,
) -> torch.Tensor:
    """Single-image AdaIN: content ``fc [H, W, C]``, style ``fs [H', W', C]``."""
    return adain_from_stats(fc, adain_stats(fs, eps), alpha, eps)
