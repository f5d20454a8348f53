"""Image-pair channel packing for the 64-channel cascade tier.

Counterpart of ``wct_tpu/ops/pack2.py``: image pairs are packed along
the channel dim (NCHW ``[B, C, H, W] → [B/2, 2C, H, W]``, image i with
image i + B/2) and every conv of the 64-channel tier runs on the pair
with block-diagonal weights ``[2Co, 2Ci, k, k]``. The off-diagonal
blocks are exact zeros, so each output is the same sum of products as
the unpacked conv; only the order of the sums, and so the rounding,
may differ. On the TPU this fills the MXU's 128 lanes; here it is a
layout of stock ops (PyTorch convs under ``convs.conv_by_shape``, whose
choice keys the packed 128-channel shapes on their own) and no kernel
of its own. ``CascadeConfig(pack2_junction=True)`` routes through it,
with the scopes ``pack2_tail_only`` and ``pack2_junction_only``; odd
batches take the unpacked path.

Statistics: the relu1_1 tail (``tail_pack2``) needs each image's
covariance and moments. A packed ``[B/2, 2C, H, W]`` map is, as it lies
in memory, the unpacked ``[B, C, H, W]`` with the images reordered
(pair j's halves are entries 2j and 2j + 1), so the per-image
statistics are taken on that view by ``gram.centered_gram_cn`` and
``gram.moments_cn`` (on the card, the hand-written Gram kernel) and
the cross blocks of the reference's ``[128, 128]`` pair Gram are never
computed. The reference takes its bf16 covariance uncentred
(``reductions.gram0_lowp``, ``wct_tpu/ops/pack2.py:153-159``); the
port's is the centred two-pass Gram for bf16 too, the departure the
port makes for every Gram (``ops/wct.py::_gram_cn``).
"""

from __future__ import annotations

import torch

from wct_tpu_torch.ops import adain as adain_ops
from wct_tpu_torch.ops import gram
from wct_tpu_torch.ops import wct as wct_ops
from wct_tpu_torch.ops.convs import (
    compose_1x1_into_conv,
    conv2d_reflect_nchw,
    conv2d_reflect_ring_nchw,
    maxpool2_nchw,
    upsample_nearest2_nchw,
)
from wct_tpu_torch.utils.profiling import span


def _blockdiag(w: torch.Tensor) -> torch.Tensor:
    """OIHW ``[co, ci, k, k]`` → ``[2co, 2ci, k, k]`` with two diagonal copies."""
    co, ci = w.shape[:2]
    z = w.new_zeros((2 * co, 2 * ci, *w.shape[2:]))
    z[:co, :ci] = w
    z[co:, ci:] = w
    return z


def _dup(b: torch.Tensor) -> torch.Tensor:
    return torch.cat([b, b])


def pair_weights(w: torch.Tensor, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """A conv's weights for image pairs: ``w [co, ci, k, k]``, ``b [co]`` →
    the block-diagonal ``[2co, 2ci, k, k]`` and ``[2co]``. A caller that
    runs the conv many times (``parallel.stylize_spatial``, per shard and
    level) makes them once."""
    return _blockdiag(w), _dup(b)


def pack(x: torch.Tensor) -> torch.Tensor:
    """``[B, C, H, W]`` → ``[B/2, 2C, H, W]``; image i pairs with image i + B/2."""
    b = x.shape[0]
    return torch.cat([x[: b // 2], x[b // 2 :]], dim=1)


def unpack(x: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack``."""
    c = x.shape[1] // 2
    return torch.cat([x[:, :c], x[:, c:]], dim=0)


def _conv(ring: bool):
    return conv2d_reflect_ring_nchw if ring else conv2d_reflect_nchw


def _packed_conv(conv, x, w, b):
    return conv(x, *pair_weights(w, b))


def _pre(enc_w0, enc_b0, enc_w11, enc_b11, compose_pre: bool):
    """conv1_1's weights, with the linear 1×1 conv0 composed in (before the
    block-diagonal copy) when ``compose_pre``."""
    if compose_pre:
        return compose_1x1_into_conv(enc_w0, enc_b0, enc_w11, enc_b11)
    return enc_w11, enc_b11


def junction_pack2(
    d: torch.Tensor,
    dec_w1, dec_b1, dec_w2, dec_b2,
    enc_w0, enc_b0, enc_w11, enc_b11,
    enc_w12=None, enc_b12=None,
    *,
    deep: bool = True,
    clip: bool = False,
    unpack_out: bool = True,
    ring: bool = False,
    compose_pre: bool = False,
) -> torch.Tensor:
    """The level junction on image pairs (``wct_tpu/ops/pack2.py:63-113``).

    ``d [B, 64, h, w]`` (the decoder's feature before its last upsample)
    → with ``deep`` the post-pool1 encoder state ``[B, 64, h, w]``, else
    the relu1_1 features ``[B, 64, 2h, 2w]``; ``unpack_out=False``
    (``deep=False`` only) keeps them packed, ``[B/2, 128, 2h, 2w]``, for
    ``tail_pack2``. ``clip`` clamps the RGB between the decoder and the
    encoder; ``compose_pre`` folds conv0 into conv1_1.
    """
    conv = _conv(ring)
    w11, b11 = _pre(enc_w0, enc_b0, enc_w11, enc_b11, compose_pre)
    u = upsample_nearest2_nchw(pack(d))
    m = torch.relu(_packed_conv(conv, u, dec_w1, dec_b1))
    rgb = _packed_conv(conv, m, dec_w2, dec_b2)
    if clip:
        rgb = rgb.clamp(0.0, 1.0)
    x = rgb if compose_pre else _packed_conv(conv, rgb, enc_w0, enc_b0)
    e1 = torch.relu(_packed_conv(conv, x, w11, b11))
    if not deep:
        return unpack(e1) if unpack_out else e1
    e2 = torch.relu(_packed_conv(conv, e1, enc_w12, enc_b12))
    return unpack(maxpool2_nchw(e2))


def _packed_relu1_1(img, enc_w0, enc_b0, enc_w11, enc_b11, conv, compose_pre: bool):
    w11, b11 = _pre(enc_w0, enc_b0, enc_w11, enc_b11, compose_pre)
    x = pack(img)
    if not compose_pre:
        x = _packed_conv(conv, x, enc_w0, enc_b0)
    return torch.relu(_packed_conv(conv, x, w11, b11))


def head_pack2_shallow(
    img: torch.Tensor, enc_w0, enc_b0, enc_w11, enc_b11, *, ring: bool = False,
    compose_pre: bool = False,
) -> torch.Tensor:
    """The first encode up to relu1_1 on image pairs, kept packed:
    ``[B, 3, H, W]`` → ``[B/2, 128, H, W]``, for ``tail_pack2``."""
    return _packed_relu1_1(img, enc_w0, enc_b0, enc_w11, enc_b11, _conv(ring), compose_pre)


def head_pack2(
    img: torch.Tensor, enc_w0, enc_b0, enc_w11, enc_b11, enc_w12, enc_b12, *,
    ring: bool = False, compose_pre: bool = False,
) -> torch.Tensor:
    """The first encode's full-resolution tier on image pairs: ``[B, 3, H,
    W]`` → the post-pool1 state ``[B, 64, H/2, W/2]``, unpacked."""
    conv = _conv(ring)
    e1 = _packed_relu1_1(img, enc_w0, enc_b0, enc_w11, enc_b11, conv, compose_pre)
    return unpack(maxpool2_nchw(torch.relu(_packed_conv(conv, e1, enc_w12, enc_b12))))


def images_view(xp: torch.Tensor) -> torch.Tensor:
    """Packed ``[B/2, 2C, H, W]`` → channel-major ``[B, C, N]`` of the same
    memory, pair j's halves at entries 2j and 2j + 1."""
    b2, c2 = xp.shape[:2]
    return xp.contiguous().reshape(2 * b2, c2 // 2, -1)


def _pair_gram(xp: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Each image's channel covariance and mean from packed ``xp [B/2, 2C,
    H, W]``: ``(cov [B/2, 2, C, C], mean [B/2, 2C])``, f32, N − 1
    normalised. Block ``cov[j, h]`` is the reference's diagonal block h of
    pair j's ``[2C, 2C]`` Gram (``wct_tpu/ops/pack2.py:139-160``); the cross
    blocks it discards are not computed. One ``centered_gram_cn`` over the
    images' view (module docstring)."""
    cov, mean = wct_ops._gram_cn(images_view(xp))
    b2, c2 = xp.shape[:2]
    return cov.reshape(b2, 2, c2 // 2, c2 // 2), mean.reshape(b2, c2)


def tail_pack2(
    e1p: torch.Tensor,
    stats: wct_ops.StyleStats | None,
    alpha,
    dec_w: torch.Tensor,
    dec_b: torch.Tensor,
    *,
    transform: str = "wct",
    adain_stats: adain_ops.AdainStats | None = None,
    eps: float = wct_ops.DEFAULT_EPS,
    trunc: float = wct_ops.DEFAULT_TRUNC,
    method: wct_ops.Method = "eigh",
    soft_trunc: bool = False,
    ns_iters: int | None = None,
    rel_trunc: float | None = None,
    ring: bool = False,
) -> torch.Tensor:
    """The relu1_1 level on packed features (``wct_tpu/ops/pack2.py:163-268``):
    each image's WCT (or AdaIN) at ``alpha`` and the final 64→3 conv, as a
    128→6 conv with block-diagonal weights.

    ``e1p [B/2, 128, H, W]`` (from ``junction_pack2(deep=False,
    unpack_out=False)`` or ``head_pack2_shallow``) → unpacked RGB ``[B, 3,
    H, W]``, unclipped. The statistics and the per-image affine run on the
    images' view of the packed map (one Gram launch, one matrix-root call
    for every image), and the affine is applied there, so the
    reference's ``[128, 128]`` block-diagonal transform and its zero
    blocks are never formed: the same products, without the zeros. The
    statistics, the affine and its apply run in the span ``wct.transform``.
    """
    view = images_view(e1p)
    with span("wct.transform"):
        if transform == "adain":
            mu, var = gram.moments_cn(view)
            scale, bias = adain_ops.adain_affine_from_moments(mu, var, adain_stats, alpha)
            out = (view.float() * scale[..., None] + bias[..., None]).to(e1p.dtype)
        else:
            cov, mean = wct_ops._gram_cn(view)
            blended, bias = wct_ops.wct_affine_from_cov(
                cov, mean, stats, alpha, eps=eps, trunc=trunc, method=method,
                soft_trunc=soft_trunc, ns_iters=ns_iters, rel_trunc=rel_trunc,
            )
            out = wct_ops.apply_affine_cn(view, blended, bias)
    rgb = _packed_conv(_conv(ring), out.reshape(e1p.shape), dec_w, dec_b)
    return unpack(rgb)
