"""Whitening–coloring transform (WCT).

Counterpart of ``wct_tpu/ops/wct.py``:

    cov_c = f_c f_cᵀ/(N−1) + ε I
    whiten:  f̂_c  = cov_c^{−1/2} (f_c − μ_c)
    color:   f̂_cs = cov_s^{+1/2} f̂_c + μ_s
    blend:   out  = α f̂_cs + (1−α) f_c

with cov^{±1/2} from ``eigh`` (hard 1e-5 mask) or Newton–Schulz, and
the whitening, coloring and α-blend folded into one C×C matrix per
image before the feature map is touched.

The public functions keep the JAX package's single-image ``[H, W, C]``
layout. The cascade calls the batched ``*_cn`` forms, which take
channel-major features ``x [B, C, N]`` (an NCHW map with its spatial
dims flattened, no copy).

Not in this slice, and raising ``NotImplementedError`` rather than
being ignored: the soft, top-k and relative truncation modes, grouped
WCT, bf16 features and ``method='newton_schulz_fast'``.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from wct_tpu_torch.ops import reductions, sqrtm

# Reference ops.py:~70: eps=1e-8 on the Gram diagonal, eigenvalues
# truncated at 1e-5.
DEFAULT_EPS = 1e-8
DEFAULT_TRUNC = 1e-5

Method = Literal[
    "eigh", "newton_schulz", "newton_schulz_fast", "newton_schulz_pallas", "auto"
]

# 'auto': eigh for Grams up to 64 channels, Newton–Schulz above
# (wct_tpu/ops/wct.py:59-66).
_AUTO_EIGH_MAX_C = 64

# Where each part that is not ported yet is carried in ROADMAP.md.
ITEM_TRUNC = "ROADMAP.md queue 1 item 4b (truncation modes and grouped WCT)"
ITEM_THROUGHPUT = (
    "ROADMAP.md queue 1 item 5b (throughput path: bf16, newton_schulz_fast, "
    "conv_precision='high')"
)
ITEM_ADAIN_SWAP = "ROADMAP.md queue 1 item 6 (AdaIN and style-swap)"
ITEM_VARIANTS = "ROADMAP.md queue 1 item 11 (opt-in variants)"


def not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to wct_tpu_torch yet: {item}")


@dataclasses.dataclass(frozen=True)
class StyleStats:
    """Cacheable per-level style statistics.

    ``color(x) = x @ kernel + mean`` recolors a whitened, zero-mean
    ``x [N, C]``; ``kernel`` is the symmetric coloring matrix
    cov_s^{1/2} ``[C, C]`` and ``mean`` the style channel mean ``[C]``.
    """

    kernel: torch.Tensor
    mean: torch.Tensor


def _cn(f: torch.Tensor) -> torch.Tensor:
    """One image ``[H, W, C]`` → channel-major batch of one ``[1, C, N]``."""
    return f.reshape(-1, f.shape[-1]).mT[None]


def _sym_pow(
    cov: torch.Tensor, power: float, trunc: float, soft: bool = False,
    topk: int | None = None, rel: float | None = None,
) -> torch.Tensor:
    """``U diag(m(S)·S^power) Uᵀ`` with the hard mask ``m(S) = S > trunc``.

    The reference keeps singular values > 1e-5 (ops.py:~95); a mask
    keeps the shapes fixed. Batched over leading dims.
    """
    if soft or topk is not None or rel is not None:
        raise not_ported("soft, top-k and relative truncation", ITEM_TRUNC)
    s, u = torch.linalg.eigh(cov)  # ascending eigenvalues
    keep = s > trunc
    s_pow = torch.where(keep, torch.sign(s) * torch.abs(s) ** power, 0.0)
    return (u * s_pow[..., None, :]) @ u.mT


def _gram_cn(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Two-pass centred Gram of ``x [..., C, N]``: ``(cov [..., C, C], mean [..., C])``.

    ``cov = (x−μ)(x−μ)ᵀ/(N−1)`` in float32 (reference ops.py:~80).
    """
    if x.dtype == torch.bfloat16:
        raise not_ported("the bf16 Gram", ITEM_THROUGHPUT)
    n = x.shape[-1]
    f32 = x.float()
    mean = reductions.mean0(f32.mT)
    centered = f32 - mean[..., :, None]
    cov = reductions.gram0(centered.mT) / (n - 1)
    return cov, mean


def _gram(f_flat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``_gram_cn`` on ``f_flat [N, C]``."""
    return _gram_cn(f_flat.mT)


def _sqrt_kernels(
    cov: torch.Tensor, power: float, trunc: float, method: Method,
    soft: bool = False, ns_iters: int | None = None,
    topk: int | None = None, rel: float | None = None,
) -> torch.Tensor:
    """cov^{power} for power = ±1/2 on ``cov [B, C, C]`` by ``method``."""
    if method == "auto":
        method = "eigh" if cov.shape[-1] <= _AUTO_EIGH_MAX_C else "newton_schulz"
    if method != "eigh":
        if topk is not None:
            raise ValueError(
                f"trunc_topk requires the eigh path; method resolved to "
                f"{method!r} (C={cov.shape[-1]}) has no spectrum mask to "
                "truncate — its deterministic rank-k guarantee would be "
                "silently dropped"
            )
        if rel is not None:
            raise ValueError(
                f"rel_trunc requires the eigh path; method resolved to "
                f"{method!r} (C={cov.shape[-1]}) has no spectrum mask — "
                "the relative threshold would be silently dropped"
            )
    if method == "eigh":
        return _sym_pow(cov, power, trunc, soft=soft, topk=topk, rel=rel)
    if method == "newton_schulz_fast":
        raise not_ported("method='newton_schulz_fast'", ITEM_THROUGHPUT)
    if method in ("newton_schulz", "newton_schulz_pallas"):
        sq, inv = sqrtm.newton_schulz_sqrtm(
            cov,
            num_iters=sqrtm.DEFAULT_ITERS if ns_iters is None else ns_iters,
            use_kernel=method == "newton_schulz_pallas",
        )
        return inv if power < 0 else sq
    raise ValueError(f"unknown WCT method: {method!r}")


def _check_trunc_modes(
    soft: bool, topk: int | None, rel: float | None, groups: int = 1
) -> None:
    """The three truncation overrides are mutually exclusive modes."""
    chosen = [
        n
        for n, on in (
            ("soft_trunc", soft), ("trunc_topk", topk is not None),
            ("rel_trunc", rel is not None),
        )
        if on
    ]
    if len(chosen) > 1:
        raise ValueError(
            f"truncation modes are mutually exclusive; got {chosen}"
        )
    if topk is not None and groups != 1:
        raise ValueError("trunc_topk is only supported with groups=1")
    if rel is not None and not 0.0 < rel < 1.0:
        raise ValueError(f"rel_trunc must be in (0, 1), got {rel}")
    if groups != 1:
        raise not_ported("grouped WCT (groups > 1)", ITEM_TRUNC)


def whitening_kernel_cn(
    x: torch.Tensor, *, eps: float = DEFAULT_EPS, trunc: float = DEFAULT_TRUNC,
    method: Method = "eigh", groups: int = 1, soft_trunc: bool = False,
    ns_iters: int | None = None, trunc_topk: int | None = None,
    rel_trunc: float | None = None, power: float = -0.5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Whitening matrices + means of ``x [B, C, N]``: ``([B, C, C], [B, C])``.

    ``power=+0.5`` gives the coloring matrices instead (``style_stats``).
    ``ns_iters`` overrides the Newton–Schulz iteration count.
    """
    _check_trunc_modes(soft_trunc, trunc_topk, rel_trunc, groups)
    cov, mean = _gram_cn(x)
    cov = cov + eps * torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    kernel = _sqrt_kernels(
        cov, power, trunc, method, soft=soft_trunc, ns_iters=ns_iters,
        topk=trunc_topk, rel=rel_trunc,
    )
    return kernel, mean


def whitening_kernel(fc: torch.Tensor, **kw) -> tuple[torch.Tensor, torch.Tensor]:
    """Whitening matrix + mean for content features ``fc [H, W, C]``.

    ``whiten(x) = (x − mean) @ kernel`` gives identity channel
    covariance on the retained rank (reference ops.py:~85–110). Keyword
    arguments as ``whitening_kernel_cn``.
    """
    kernel, mean = whitening_kernel_cn(_cn(fc), **kw)
    return kernel[0], mean[0]


def style_stats_cn(x: torch.Tensor, **kw) -> StyleStats:
    """Coloring statistics of one style image, channel-major ``x [1, C, N]``.

    Keyword arguments as ``whitening_kernel_cn`` (the iteration count
    stays at its default: the style is computed once per style).
    """
    kernel, mean = whitening_kernel_cn(x, power=0.5, **kw)
    return StyleStats(kernel=kernel[0], mean=mean[0])


def style_stats(fs: torch.Tensor, **kw) -> StyleStats:
    """Cacheable coloring statistics of style features ``fs [H, W, C]``."""
    return style_stats_cn(_cn(fs), **kw)


def _apply_kernel(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``x [..., N, C] @ kernel [..., C, C]`` in f32.

    Computed as ``(kernelᵀ xᵀ)ᵀ`` so that channel-major features (the
    cascade's, where ``xᵀ`` is the contiguous NCHW map) need no copy.
    """
    return (kernel.float().mT @ x.float().mT).mT


def wct_from_stats_cn(
    x: torch.Tensor, stats: StyleStats, alpha: torch.Tensor | float = 1.0, *,
    eps: float = DEFAULT_EPS, trunc: float = DEFAULT_TRUNC,
    method: Method = "eigh", groups: int = 1, soft_trunc: bool = False,
    ns_iters: int | None = None, trunc_topk: int | None = None,
    rel_trunc: float | None = None,
) -> torch.Tensor:
    """WCT of content ``x [B, C, N]`` against cached style stats → ``[B, C, N]``.

    Whitening, coloring and the α-blend fold into one C×C affine:

        T   = W_c @ K_s
        out = x @ (α·T + (1−α)·I) + α·(μ_s − μ_c @ T)

    which is the reference's ``α·((x − μ_c)·T + μ_s) + (1−α)·x``
    (ops.py:~135), blended against the uncentred content. At α=0 the
    matrix is exactly I and the bias exactly 0.
    """
    in_dtype = x.dtype
    w_c, mu_c = whitening_kernel_cn(
        x, eps=eps, trunc=trunc, method=method, groups=groups,
        soft_trunc=soft_trunc, ns_iters=ns_iters, trunc_topk=trunc_topk,
        rel_trunc=rel_trunc,
    )
    k_s = stats.kernel.float()
    if w_c.dim() - 1 != k_s.dim():
        raise ValueError(
            "content whitening groups do not match cached style stats "
            f"(kernel ranks {w_c.dim() - 1} vs {k_s.dim()}) — precompute the "
            "style with the same `groups`"
        )
    c = x.shape[-2]
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=x.device)
    mu_s = stats.mean.float()
    transform = w_c @ k_s
    eye = torch.eye(c, dtype=torch.float32, device=x.device)
    mu_c_t = reductions.vecmat(mu_c, transform)
    blended = alpha * transform + (1.0 - alpha) * eye
    bias = alpha * (mu_s - mu_c_t)
    out = _apply_kernel(x.mT, blended).mT + bias[..., :, None]
    return out.to(in_dtype)


def wct_from_stats(
    fc: torch.Tensor, stats: StyleStats, alpha: torch.Tensor | float = 1.0, **kw
) -> torch.Tensor:
    """WCT of one image's content features ``fc [H, W, C]`` → ``[H, W, C]``.

    Keyword arguments as ``wct_from_stats_cn``.
    """
    out = wct_from_stats_cn(_cn(fc), stats, alpha, **kw)
    return out[0].mT.reshape(fc.shape)


def wct(
    fc: torch.Tensor, fs: torch.Tensor, alpha: torch.Tensor | float = 1.0, *,
    eps: float = DEFAULT_EPS, trunc: float = DEFAULT_TRUNC,
    method: Method = "eigh", groups: int = 1, soft_trunc: bool = False,
    trunc_topk: tuple[int, int] | None = None, rel_trunc: float | None = None,
) -> torch.Tensor:
    """Single-image WCT: content ``fc [H, W, C]``, style ``fs [H', W', C]``.

    ``trunc_topk=(k_c, k_s)`` would set the top-k mask per side.
    """
    k_c, k_s = trunc_topk if trunc_topk is not None else (None, None)
    stats = style_stats(
        fs, eps=eps, trunc=trunc, method=method, groups=groups,
        soft_trunc=soft_trunc, trunc_topk=k_s, rel_trunc=rel_trunc,
    )
    return wct_from_stats(
        fc, stats, alpha, eps=eps, trunc=trunc, method=method, groups=groups,
        soft_trunc=soft_trunc, trunc_topk=k_c, rel_trunc=rel_trunc,
    )
