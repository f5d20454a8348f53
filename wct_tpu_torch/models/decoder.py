"""Per-level mirror decoders (reluX_1 features → RGB pixels).

Counterpart of ``wct_tpu/models/decoder.py``: each relu target's
decoder mirrors the encoder from that layer back to pixels. Every max
pool becomes a 2× nearest-neighbour upsample, every conv a 3×3
reflect-padded conv + ReLU, and the final conv maps to 3 channels with
no activation. The spec is derived from ``vgg.ENCODER_LAYERS``.
"""

from __future__ import annotations

import math

import torch

from wct_tpu_torch.models import vgg
from wct_tpu_torch.ops.convs import (
    conv2d_reflect_nchw,
    conv2d_reflect_perimage_nchw,
    conv2d_reflect_ring_nchw,
    to_nchw,
    to_nhwc,
    upsample_nearest2_nchw,
)


def decoder_layers(target: str) -> tuple[tuple, ...]:
    """Mirror layer specs for ``target``: (kind, name, in_c, out_c, k)."""
    enc = vgg.layers_to(target)
    out: list[tuple] = []
    for spec in reversed(enc):
        if spec[0] == "pool":
            out.append(("upsample", f"up_{spec[1]}"))
        elif spec[0] == "conv":
            _, name, in_c, out_c, k = spec
            out.append(("conv", f"dec_{name}", out_c, in_c, k))
        # conv_pre (conv0) is not mirrored: decoders emit RGB directly.
    return tuple(out)


def init_decoder_params(
    generator: torch.Generator, target: str, device: str | torch.device = "cpu"
) -> dict:
    """He-normal random params for the ``target`` decoder."""
    params: dict = {}
    for spec in decoder_layers(target):
        if spec[0] != "conv":
            continue
        _, name, in_c, out_c, k = spec
        w = torch.randn(out_c, in_c, k, k, generator=generator)
        w = w * math.sqrt(2.0 / (k * k * in_c))
        params[name] = {"w": w.to(device), "b": torch.zeros(out_c, device=device)}
    return params


def decode_nchw(params: dict, f: torch.Tensor, target: str, ring: bool = False) -> torch.Tensor:
    """``decode`` on NCHW features; returns NCHW RGB. ``ring`` runs every
    conv as ``conv2d_reflect_ring_nchw`` (no reflect-padded copy)."""
    return _decode(params, f, decoder_layers(target), 0, ring)


def _decode(params: dict, x: torch.Tensor, layers: tuple, start: int, ring: bool) -> torch.Tensor:
    conv = conv2d_reflect_ring_nchw if ring else conv2d_reflect_nchw
    last = len(layers) - 1
    for i in range(start, len(layers)):
        spec = layers[i]
        if spec[0] == "upsample":
            x = upsample_nearest2_nchw(x)
            continue
        p = params[spec[1]]
        x = conv(x, p["w"], p["b"])
        if i != last:  # the final conv is linear (reference model.py:~135)
            x = torch.relu(x)
    return x


def decode_folded_nchw(
    params: dict, f: torch.Tensor, target: str, m: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """Decode with a per-image affine folded into the first conv
    (``wct_tpu/models/decoder.py:82-110``).

    ``decode_nchw(params, x ↦ x@M_b + β_b of f, target)`` without the
    transformed map: ``m`` is ``[B, C, C]`` dense (WCT) or ``[B, C]``
    diagonal (AdaIN), ``bias [B, C]``; ``fold_affine_into_conv`` makes
    per-image weights in f32 and the first conv runs per image
    (``conv2d_reflect_perimage_nchw``), then a ReLU unless it is the only
    conv, then the rest of the decoder with the plain reflect conv, as
    the reference's runs it.
    """
    layers = decoder_layers(target)
    p = params[layers[0][1]]
    w_fold, b_fold = fold_affine_into_conv(m, bias, p["w"], p["b"])
    x = conv2d_reflect_perimage_nchw(f, w_fold, b_fold)
    if len(layers) > 1:  # the final conv is linear
        x = torch.relu(x)
    return _decode(params, x, layers, 1, ring=False)


def decode_folded(
    params: dict, f: torch.Tensor, target: str, m: torch.Tensor, bias: torch.Tensor
) -> torch.Tensor:
    """``decode_folded_nchw`` on features ``[B, h, w, C]``; returns
    ``[B, H, W, 3]``."""
    return to_nhwc(decode_folded_nchw(params, to_nchw(f), target, m, bias))


def fold_affine_into_conv(
    m: torch.Tensor, bias: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold a per-image affine (x ↦ x@M_b + β_b) into a shared conv.

    ``m [B, C, C]`` dense or ``[B, C]`` diagonal, ``bias [B, C]``,
    ``w [Co, C, kh, kw]``, ``b [Co]`` → per-image
    ``(w' [B, Co, C, kh, kw], b' [B, Co])`` with
    conv'(x) = conv(x @ M + β): reflect padding commutes with a
    per-pixel affine. Folded in f32.
    """
    w32 = w.float()
    if m.dim() == 3:
        w_fold = torch.einsum("bij,ojyx->boiyx", m.float(), w32)
    else:
        w_fold = w32[None] * m.float()[:, None, :, None, None]
    b_fold = b.float()[None] + torch.einsum("bj,ojyx->bo", bias.float(), w32)
    return w_fold, b_fold


def has_standard_tail(target: str) -> bool:
    """True iff the decoder ends [upsample, conv 64→64, conv 64→3], the
    shape the fused junction kernel (``ops/junction.py``) replaces.
    Holds for every target deeper than relu1_1."""
    layers = decoder_layers(target)
    if len(layers) < 3:
        return False
    up, c1, c2 = layers[-3], layers[-2], layers[-1]
    return (
        up[0] == "upsample"
        and c1[0] == "conv" and c1[2] == 64 and c1[3] == 64
        and c2[0] == "conv" and c2[2] == 64 and c2[3] == 3
    )


def decode_partial_nchw(
    params: dict, f: torch.Tensor, target: str, ring: bool = False
) -> torch.Tensor:
    """``decode_partial`` on NCHW features; returns NCHW ``[B, 64, h, w]``."""
    if not has_standard_tail(target):
        raise ValueError(f"the {target} decoder has no [upsample, conv, conv] tail")
    conv = conv2d_reflect_ring_nchw if ring else conv2d_reflect_nchw
    x = f
    for spec in decoder_layers(target)[:-3]:
        if spec[0] == "upsample":
            x = upsample_nearest2_nchw(x)
            continue
        p = params[spec[1]]
        x = torch.relu(conv(x, p["w"], p["b"]))
    return x


def decode_partial(params: dict, f: torch.Tensor, target: str, ring: bool = False) -> torch.Tensor:
    """Run the decoder up to (excluding) its final [upsample, conv, conv]
    tail; the fused junction kernel finishes the job. Every conv here
    gets a ReLU (none is the final linear conv)."""
    return to_nhwc(decode_partial_nchw(params, to_nchw(f), target, ring))


def tail_weights(params: dict, target: str) -> tuple:
    """(w1, b1, w2, b2) of the decoder's final two convs (64→64, 64→3)."""
    layers = decoder_layers(target)
    n1, n2 = layers[-2][1], layers[-1][1]
    return (
        params[n1]["w"], params[n1]["b"],
        params[n2]["w"], params[n2]["b"],
    )


def decode(params: dict, f: torch.Tensor, target: str, ring: bool = False) -> torch.Tensor:
    """Decode features ``[B, h, w, C]`` at ``target`` to ``[B, H, W, 3]``.

    The output is raw (unclipped) RGB in ≈[0, 1]; callers clip.
    """
    return to_nhwc(decode_nchw(params, to_nchw(f), target, ring))
