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


def decode_nchw(params: dict, f: torch.Tensor, target: str) -> torch.Tensor:
    """``decode`` on NCHW features; returns NCHW RGB."""
    layers = decoder_layers(target)
    last = len(layers) - 1
    x = f
    for i, spec in enumerate(layers):
        if spec[0] == "upsample":
            x = upsample_nearest2_nchw(x)
            continue
        p = params[spec[1]]
        x = conv2d_reflect_nchw(x, p["w"], p["b"])
        if i != last:  # the final conv is linear (reference model.py:~135)
            x = torch.relu(x)
    return x


def decode(params: dict, f: torch.Tensor, target: str) -> torch.Tensor:
    """Decode features ``[B, h, w, C]`` at ``target`` to ``[B, H, W, 3]``.

    The output is raw (unclipped) RGB in ≈[0, 1]; callers clip.
    """
    return to_nhwc(decode_nchw(params, to_nchw(f), target))
