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

Every Gram is ``gram.centered_gram_cn``'s (the hand-written kernel on
the card). bf16 features (``compute_dtype='bfloat16'``) take a bf16 ×
bf16 apply with f32 sums; statistics and kernels are f32 whatever the
features are.

Truncation: the hard 1e-5 mask, or (``eigh`` only for the last two) the
soft filter, a top-k index mask or a threshold relative to the largest
eigenvalue. Grouped WCT (``groups = G > 1``) whitens and colours G
blocks of C/G consecutive channels independently: a batch ``[B, C, N]``
is the contiguous view ``[B·G, C/G, N]``, so one Gram launch and one
Newton–Schulz launch serve every block of every image, and the
kernels are block-diagonal ``[..., G, C/G, C/G]``.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

import torch

from wct_tpu_torch.ops import eigh, gram, reductions, sqrtm
from wct_tpu_torch.utils.device import scalar_on, values_on
from wct_tpu_torch.utils.profiling import span

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
    """``U diag(m(S)·S^power) Uᵀ`` by ``eigh``, batched over leading dims.

    ``m(S)`` is the hard mask ``S > trunc`` (the reference keeps
    singular values > 1e-5, ops.py:~95; a mask keeps the shapes fixed),
    or, as ``wct_tpu/ops/wct.py::_sym_pow`` says why:

    - ``topk``: the k largest modes, kept eigenvalues floored at
      ``trunc·1e-3`` (a k past the f32 rank would send noise
      eigenvalues, perhaps negative, through the −1/2 power);
    - ``rel``: ``S > rel·S_max``, the mask f32 and float64 agree on;
    - ``soft``: the filter ``S⁺²/(S⁺² + trunc²)`` on ``S⁺ = max(S, 0)``
      (clamped to the PSD cone first), with the same floor.
    """
    s, u = eigh.eigh_cn(cov)  # ascending eigenvalues
    if topk is not None:
        keep = keep_mask(s, trunc, topk=topk)
        s_pow = torch.where(keep, s.clamp_min(trunc * 1e-3) ** power, 0.0)
    elif rel is not None:
        keep = keep_mask(s, trunc, rel=rel)
        s_pow = torch.where(keep, torch.where(keep, s, 1.0).abs() ** power, 0.0)
    elif soft:
        s_pos = s.clamp_min(0.0)
        filt = s_pos * s_pos / (s_pos * s_pos + trunc * trunc)
        s_pow = filt * s_pos.clamp_min(trunc * 1e-3) ** power
    else:
        keep = keep_mask(s, trunc)
        s_pow = torch.where(keep, torch.sign(s) * torch.abs(s) ** power, 0.0)
    return (u * s_pow[..., None, :]) @ u.mT


def keep_mask(
    s: torch.Tensor, trunc: float, topk: int | None = None, rel: float | None = None
) -> torch.Tensor:
    """The modes a mask keeps, from ascending eigenvalues ``s [..., C]``:
    the top ``topk``, those above ``rel·S_max``, or those above ``trunc``."""
    if topk is not None:
        return torch.arange(s.shape[-1], device=s.device) >= s.shape[-1] - topk
    if rel is not None:
        return s > rel * s[..., -1:]
    return s > trunc


def _gram_cn(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Channel covariance of ``x [B, C, N]``: ``(cov [B, C, C], mean [B, C])``, f32.

    The two-pass centred Gram ``(x−μ)(x−μ)ᵀ/(N−1)`` (reference
    ops.py:~80) of ``gram.centered_gram_cn``, for f32 and bf16
    features alike. On the card that is the hand-written kernel: it
    upcasts bf16 as it reads, centres in f32 without a centred copy,
    and sums in blocks with compensated, fixed-order folds, where one
    cuBLAS product over all N columns of a mostly-zero ReLU map drifts
    by 1e-3 at relu1_1. The reference's bf16 route is the uncentred
    ``(x xᵀ − n·μμᵀ)/(n−1)`` (``wct_tpu/ops/wct.py:190-205``), which
    avoids rounding a centred copy back to bf16; the kernel makes no
    such copy, so the centred form keeps that contract with less
    cancellation.
    """
    n = x.shape[-1]
    gram_sum, mean = gram.centered_gram_cn(x.contiguous())
    return gram_sum / (n - 1), mean


def _gram(f_flat: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``_gram_cn`` on one image's ``f_flat [N, C]``."""
    cov, mean = _gram_cn(f_flat.mT[None])
    return cov[0], mean[0]


def _sqrt_kernels(
    cov: torch.Tensor, power: float, trunc: float, method: Method,
    soft: bool = False, ns_iters: int | None = None,
    topk: int | None = None, rel: float | None = None,
) -> torch.Tensor:
    """cov^{power} for power = ±1/2 on ``cov [B, C, C]`` by ``method``, in
    the span ``wct.op.sqrt``."""
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
        with span("wct.op.sqrt"):
            return _sym_pow(cov, power, trunc, soft=soft, topk=topk, rel=rel)
    if method in ("newton_schulz", "newton_schulz_fast", "newton_schulz_pallas"):
        with span("wct.op.sqrt"):
            sq, inv = sqrtm.newton_schulz_sqrtm(
                cov,
                num_iters=sqrtm.DEFAULT_ITERS if ns_iters is None else ns_iters,
                use_kernel=method == "newton_schulz_pallas",
                precision="high" if method == "newton_schulz_fast" else "highest",
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


def whitening_kernel_cn(
    x: torch.Tensor, *, eps: float = DEFAULT_EPS, trunc: float = DEFAULT_TRUNC,
    method: Method = "eigh", groups: int = 1, soft_trunc: bool = False,
    ns_iters: int | None = None, trunc_topk: int | None = None,
    rel_trunc: float | None = None, power: float = -0.5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Whitening matrices + means of ``x [B, C, N]``: ``([B, C, C], [B, C])``,
    or with ``groups = G > 1`` block-diagonal ``([B, G, C/G, C/G], [B, C])``.

    ``power=+0.5`` gives the coloring matrices instead (``style_stats``).
    ``ns_iters`` overrides the Newton–Schulz iteration count.
    ``rel_trunc`` applies within each group's spectrum.
    """
    _check_trunc_modes(soft_trunc, trunc_topk, rel_trunc, groups)
    cov, mean = _grouped_gram_cn(x, groups) if groups != 1 else _gram_cn(x)
    return _kernel_from_cov(
        cov, mean, eps=eps, trunc=trunc, method=method, groups=groups,
        soft_trunc=soft_trunc, ns_iters=ns_iters, trunc_topk=trunc_topk,
        rel_trunc=rel_trunc, power=power,
    )


def whitening_kernel_from_cov(
    cov: torch.Tensor, mean: torch.Tensor, *, eps: float = DEFAULT_EPS,
    trunc: float = DEFAULT_TRUNC, method: Method = "eigh", groups: int = 1,
    soft_trunc: bool = False, ns_iters: int | None = None,
    trunc_topk: int | None = None, rel_trunc: float | None = None,
    power: float = -0.5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``whitening_kernel_cn`` from covariances already computed:
    ``cov [B·G, C/G, C/G]`` (N − 1 normalised, no ε) and ``mean [B·G, C/G]``,
    as ``_gram_cn`` (G = 1) or ``_grouped_gram_cn`` gives them. The
    height-sharded cascade (``parallel.mesh``) combines per-shard Grams
    into these and takes the kernel from here."""
    _check_trunc_modes(soft_trunc, trunc_topk, rel_trunc, groups)
    return _kernel_from_cov(
        cov, mean, eps=eps, trunc=trunc, method=method, groups=groups,
        soft_trunc=soft_trunc, ns_iters=ns_iters, trunc_topk=trunc_topk,
        rel_trunc=rel_trunc, power=power,
    )


def _kernel_from_cov(
    cov, mean, *, eps, trunc, method, groups, soft_trunc, ns_iters, trunc_topk,
    rel_trunc, power,
) -> tuple[torch.Tensor, torch.Tensor]:
    b = cov.shape[0] // groups
    cov = cov + eps * torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    kernel = _sqrt_kernels(
        cov, power, trunc, method, soft=soft_trunc, ns_iters=ns_iters,
        topk=trunc_topk, rel=rel_trunc,
    )
    if groups != 1:
        kernel = kernel.reshape(b, groups, *kernel.shape[-2:])
    return kernel, mean.reshape(b, -1)


def _grouped_gram_cn(x: torch.Tensor, groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-group covariances of ``x [B, C, N]``: ``([B·G, C/G, C/G], mean [B·G, C/G])``.

    Group g holds channels g·C/G … (g+1)·C/G − 1, so the groups of a
    contiguous map are the contiguous view ``[B·G, C/G, N]``, and its
    per-"image" means are the per-channel means: one ``_gram_cn`` (one
    kernel launch on the card), and no centred copy
    (``wct_tpu/ops/wct.py::_grouped_gram``).
    """
    b, c, n = x.shape
    if c % groups:
        raise ValueError(f"channels {c} not divisible by groups {groups}")
    return _gram_cn(x.contiguous().reshape(b * groups, c // groups, n))


def _grouped_gram(f_flat: torch.Tensor, groups: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``_grouped_gram_cn`` on one image's ``f_flat [N, C]``: ``([G, C/G, C/G], mean [C])``."""
    cov, mean = _grouped_gram_cn(f_flat.mT[None], groups)
    return cov, mean.reshape(-1)


def whiten_color_kernels_cn(
    x: torch.Tensor, *, eps: float = DEFAULT_EPS, trunc: float = DEFAULT_TRUNC,
    method: Method = "eigh", soft_trunc: bool = False,
    rel_trunc: float | None = None, trunc_topk: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(whitening ``[B, C, C]``, coloring ``[B, C, C]``, mean ``[B, C]``) of
    ``x [B, C, N]`` from one decomposition (``wct_tpu/ops/wct.py:333-397``).

    Style-swap needs both powers of the style's covariance: ``eigh`` is
    factored once, and Newton–Schulz yields both from one coupled
    iteration (one kernel launch for ``newton_schulz_pallas``). The
    soft filter's coloring side is ``filt·S⁺^{1/2}`` without the floor,
    as the reference has it.
    """
    _check_trunc_modes(soft_trunc, trunc_topk, rel_trunc)
    cov, mean = _gram_cn(x)
    cov = cov + eps * torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
    if method == "auto":
        method = "eigh" if cov.shape[-1] <= _AUTO_EIGH_MAX_C else "newton_schulz"
    if rel_trunc is not None and method != "eigh":
        raise ValueError(
            f"rel_trunc requires the eigh path; method resolved to {method!r}"
        )
    if trunc_topk is not None and method != "eigh":
        raise ValueError(
            f"trunc_topk requires the eigh path; method resolved to {method!r}"
        )
    if method == "eigh":
        with span("wct.op.sqrt"):
            s, u = eigh.eigh_cn(cov)
            if soft_trunc:
                s_pos = s.clamp_min(0.0)
                filt = s_pos * s_pos / (s_pos * s_pos + trunc * trunc)
                inv_d = filt * s_pos.clamp_min(trunc * 1e-3) ** -0.5
                sq_d = filt * s_pos**0.5
            else:
                keep = keep_mask(s, trunc, topk=trunc_topk, rel=rel_trunc)
                safe = torch.where(keep, s, 1.0).abs()
                inv_d = torch.where(keep, safe**-0.5, 0.0)
                sq_d = torch.where(keep, safe**0.5, 0.0)
            inv = (u * inv_d[..., None, :]) @ u.mT
            sq = (u * sq_d[..., None, :]) @ u.mT
        return inv, sq, mean
    if method not in ("newton_schulz", "newton_schulz_fast", "newton_schulz_pallas"):
        raise ValueError(f"unknown WCT method: {method!r}")
    with span("wct.op.sqrt"):
        sq, inv = sqrtm.newton_schulz_sqrtm(
            cov, use_kernel=method == "newton_schulz_pallas",
            precision="high" if method == "newton_schulz_fast" else "highest",
        )
    return inv, sq, mean


def whiten_color_kernels(f: torch.Tensor, **kw) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``whiten_color_kernels_cn`` of one image's features ``f [H, W, C]``:
    ``(whitening [C, C], coloring [C, C], mean [C])``."""
    inv, sq, mean = whiten_color_kernels_cn(_cn(f), **kw)
    return inv[0], sq[0], mean[0]


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
    stays at its default: the style is computed once per style). With
    ``groups = G > 1`` the kernel is block-diagonal ``[G, C/G, C/G]``.
    """
    kernel, mean = whitening_kernel_cn(x, power=0.5, **kw)
    return StyleStats(kernel=kernel[0], mean=mean[0])


def style_stats(fs: torch.Tensor, **kw) -> StyleStats:
    """Cacheable coloring statistics of style features ``fs [H, W, C]``."""
    return style_stats_cn(_cn(fs), **kw)


def _apply_kernel(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """``x [B, N, C] @ kernel`` → f32, for a dense ``kernel [B, C, C]`` or a
    block-diagonal ``[B, G, C/G, C/G]``.

    Computed as ``(kernelᵀ xᵀ)ᵀ`` so that channel-major features (the
    cascade's, where ``xᵀ`` is the contiguous NCHW map) need no copy;
    G blocks are a batched product over the view ``[B·G, C/G, N]``
    (``wct_tpu/ops/wct.py:493-507``).

    bf16 ``x`` keeps both operands bf16 with an f32 sum and an f32
    result (``wct_tpu/ops/wct.py:472-481``): the kernel is rounded
    once per image, the products are exact, and the feature map is
    read at half the bytes. α = 0 stays an exact identity: I rounds to
    bf16 exactly and ``x·I`` sums single exact products.
    """
    b, n, c = x.shape
    xt = x.mT
    if kernel.dim() == 4:
        g, cg = kernel.shape[1], kernel.shape[2]
        xt = xt.reshape(b * g, cg, n)
        kernel = kernel.reshape(b * g, cg, cg)
    if x.dtype == torch.bfloat16:
        out = reductions.matmul_f32acc(kernel.to(torch.bfloat16).mT, xt)
    else:
        out = kernel.float().mT @ xt.float()
    return out.reshape(b, c, n).mT


def interpolate_stats(stats: list[StyleStats], weights) -> StyleStats:
    """Blend K styles' statistics with ``weights [K]``.

    Coloring is linear in (kernel, mean), so the blend of the stats is
    the reference's blend of the K recolored features
    (``wct_tpu/ops/wct.py:509-524``).
    """
    kernels = torch.stack([s.kernel for s in stats])  # [K, C, C] or [K, G, Cg, Cg]
    means = torch.stack([s.mean for s in stats])  # [K, C]
    w = values_on(weights, kernels.device, kernels.dtype)
    return StyleStats(kernel=torch.tensordot(w, kernels, 1), mean=torch.tensordot(w, means, 1))


def _affine_cn(
    x: torch.Tensor, stats: StyleStats, alpha, **kw
) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-image WCT affine of ``x [B, C, N]``: ``(M, bias [B, C])``, f32,
    with M dense ``[B, C, C]`` or, grouped, its blocks ``[B, G, C/G, C/G]``."""
    return _affine_from_kernel(*whitening_kernel_cn(x, **kw), stats, alpha)


def wct_affine_from_cov(
    cov: torch.Tensor, mean: torch.Tensor, stats: StyleStats, alpha, **kw
) -> tuple[torch.Tensor, torch.Tensor]:
    """The WCT affine ``(M, bias [B, C])`` of content whose covariances and
    means are given (``whitening_kernel_from_cov``'s inputs and keyword
    arguments); M as ``apply_affine_cn`` takes it."""
    return _affine_from_kernel(*whitening_kernel_from_cov(cov, mean, **kw), stats, alpha)


def _affine_from_kernel(
    w_c: torch.Tensor, mu_c: torch.Tensor, stats: StyleStats, alpha
) -> tuple[torch.Tensor, torch.Tensor]:
    k_s = stats.kernel.float()
    if w_c.dim() - 1 != k_s.dim():
        raise ValueError(
            "content whitening groups do not match cached style stats "
            f"(kernel ranks {w_c.dim() - 1} vs {k_s.dim()}) — precompute the "
            "style with the same `groups`"
        )
    alpha = scalar_on(alpha, w_c.device)
    mu_s = stats.mean.float()
    transform = w_c @ k_s
    eye = torch.eye(transform.shape[-1], dtype=torch.float32, device=w_c.device)
    b = w_c.shape[0]
    mu_c_t = reductions.vecmat(mu_c.reshape(transform.shape[:-1]), transform).reshape(b, -1)
    blended = alpha * transform + (1.0 - alpha) * eye
    bias = alpha * (mu_s - mu_c_t)
    return blended, bias


def wct_transform_cn(
    x: torch.Tensor, stats: StyleStats, alpha: torch.Tensor | float = 1.0, *,
    eps: float = DEFAULT_EPS, trunc: float = DEFAULT_TRUNC,
    method: Method = "eigh", groups: int = 1, soft_trunc: bool = False,
    ns_iters: int | None = None, trunc_topk: int | None = None,
    rel_trunc: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The WCT of content ``x [B, C, N]`` as per-image affines:
    ``(M [B, C, C], bias [B, C])``, both f32.

    Whitening, coloring and the α-blend fold into one C×C matrix:

        T    = W_c @ K_s
        M    = α·T + (1−α)·I
        bias = α·(μ_s − μ_c @ T)

    so that ``x_flat @ M + bias`` is the reference's
    ``α·((x − μ_c)·T + μ_s) + (1−α)·x`` (ops.py:~135), blended against
    the uncentred content. At α=0 the matrix is exactly I and the bias
    exactly 0. Exposed so that a consumer can fold the affine into the
    linear op that follows (the cascade folds it into the relu1_1
    decoder conv, ``models/decoder.py::fold_affine_into_conv``).
    Grouped blocks are expanded to the dense block-diagonal M.
    """
    blended, bias = _affine_cn(
        x, stats, alpha, eps=eps, trunc=trunc, method=method, groups=groups,
        soft_trunc=soft_trunc, ns_iters=ns_iters, trunc_topk=trunc_topk,
        rel_trunc=rel_trunc,
    )
    return dense_affine(blended), bias


def dense_affine(blended: torch.Tensor) -> torch.Tensor:
    """An affine's matrix as ``[B, C, C]``: grouped blocks ``[B, G, C/G,
    C/G]`` expanded to the dense block-diagonal, a dense one as it is."""
    if blended.dim() == 4:
        return torch.stack([torch.block_diag(*blocks) for blocks in blended])
    return blended


def wct_transform(
    fc: torch.Tensor, stats: StyleStats, alpha: torch.Tensor | float = 1.0, **kw
) -> tuple[torch.Tensor, torch.Tensor]:
    """The WCT of one image ``fc [H, W, C]`` as an explicit affine
    ``(M [C, C], bias [C])``: ``wct_from_stats(fc, …) == fc_flat @ M + bias``.

    Keyword arguments as ``wct_transform_cn``.
    """
    m, bias = wct_transform_cn(_cn(fc), stats, alpha, **kw)
    return m[0], bias[0]


def wct_from_stats_cn(
    x: torch.Tensor, stats: StyleStats, alpha: torch.Tensor | float = 1.0, **kw
) -> torch.Tensor:
    """WCT of content ``x [B, C, N]`` against cached style stats → ``[B, C, N]``:
    the affine of ``wct_transform_cn`` (same keyword arguments) applied
    to the feature map, block by block when grouped."""
    return apply_affine_cn(x, *_affine_cn(x, stats, alpha, **kw))


def apply_affine_cn(x: torch.Tensor, blended: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``x [B, C, N]`` through the per-image affine ``(M, bias)`` of
    ``_affine_cn`` (M dense or in blocks) → ``[B, C, N]`` in ``x``'s type."""
    out = _apply_kernel(x.mT, blended).mT + bias[..., :, None]
    return out.to(x.dtype)


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

    ``trunc_topk=(k_c, k_s)`` sets the top-k mask per side.
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


def wct_batched(
    fc: torch.Tensor, fs: torch.Tensor, alpha: torch.Tensor | float = 1.0, *,
    method: Method = "eigh",
) -> torch.Tensor:
    """WCT over a leading batch dim: content ``[B, H, W, C]``, styles
    ``[B, H', W', C]``, α a scalar or ``[B]`` (``wct_tpu/ops/wct.py:714``).

    Every image's statistics are its own (the Gram and the square roots
    run per matrix), so an image's result does not depend on its
    neighbours.
    """
    b = fc.shape[0]
    alpha = scalar_on(alpha, fc.device).expand(b)
    return torch.stack([
        wct(fc[i], fs[i], alpha[i], method=method) for i in range(b)
    ])
