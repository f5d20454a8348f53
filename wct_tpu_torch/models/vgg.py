"""VGG-19 encoder (normalised VGG, truncated per relu target).

Counterpart of ``wct_tpu/models/vgg.py``: a 1×1 preprocessing conv0
(RGB [0,1] → scaled BGR minus the ImageNet means), then reflect-padded
3×3 convs + ReLU with 2×2 max pools, up to relu5_1. Parameters are a
plain dict ``{layer: {"w": [out, in, kh, kw], "b": [out]}}``.

The public functions take and return ``[B, H, W, C]``; the cascade
calls the NCHW forms (``encode_multi_nchw``).
"""

from __future__ import annotations

import math

import torch

from wct_tpu_torch.ops.convs import (
    compose_1x1_into_conv,
    conv2d_reflect_nchw,
    maxpool2_nchw,
    to_nchw,
    to_nhwc,
)

# (kind, name, in_c, out_c, ksize); order = data flow. relu targets are
# the activations AFTER the correspondingly named conv's ReLU.
ENCODER_LAYERS: tuple[tuple, ...] = (
    ("conv_pre", "conv0", 3, 3, 1),  # preprocessing 1×1, linear
    ("conv", "conv1_1", 3, 64, 3),
    ("conv", "conv1_2", 64, 64, 3),
    ("pool", "pool1"),
    ("conv", "conv2_1", 64, 128, 3),
    ("conv", "conv2_2", 128, 128, 3),
    ("pool", "pool2"),
    ("conv", "conv3_1", 128, 256, 3),
    ("conv", "conv3_2", 256, 256, 3),
    ("conv", "conv3_3", 256, 256, 3),
    ("conv", "conv3_4", 256, 256, 3),
    ("pool", "pool3"),
    ("conv", "conv4_1", 256, 512, 3),
    ("conv", "conv4_2", 512, 512, 3),
    ("conv", "conv4_3", 512, 512, 3),
    ("conv", "conv4_4", 512, 512, 3),
    ("pool", "pool4"),
    ("conv", "conv5_1", 512, 512, 3),
)

RELU_TARGETS = ("relu1_1", "relu2_1", "relu3_1", "relu4_1", "relu5_1")

# relu target → index of its conv in ENCODER_LAYERS (inclusive).
_TARGET_TO_IDX = {
    f"relu{name[4]}_1": i
    for i, spec in enumerate(ENCODER_LAYERS)
    if spec[0] == "conv" and (name := spec[1]).endswith("_1")
}

# Channel count of each relu target's feature map.
TARGET_CHANNELS = {
    t: ENCODER_LAYERS[i][3] for t, i in _TARGET_TO_IDX.items()
}

# Spatial downscale factor of each relu target (pools before it).
TARGET_SCALE = {
    t: 2 ** sum(1 for s in ENCODER_LAYERS[:i] if s[0] == "pool")
    for t, i in _TARGET_TO_IDX.items()
}

_POOL1_IDX = next(
    i for i, s in enumerate(ENCODER_LAYERS) if s[1:2] == ("pool1",)
)


def layers_to(target: str) -> tuple[tuple, ...]:
    """Encoder layer specs truncated at ``target`` (inclusive)."""
    if target not in _TARGET_TO_IDX:
        raise ValueError(f"unknown relu target {target!r}; one of {RELU_TARGETS}")
    return ENCODER_LAYERS[: _TARGET_TO_IDX[target] + 1]


def init_encoder_params(
    generator: torch.Generator, device: str | torch.device = "cpu"
) -> dict:
    """He-normal random encoder params; conv0 is the canonical preprocessing.

    ``conv0`` scales [0,1] RGB by 255, swaps to BGR and subtracts the
    ImageNet means, as the t7 file bakes into its first conv. Weights
    are drawn on the CPU from ``generator``, then moved to ``device``.
    """
    params: dict = {}
    for spec in ENCODER_LAYERS:
        if spec[0] == "pool":
            continue
        _, name, in_c, out_c, k = spec
        if name == "conv0":
            w = torch.zeros(3, 3, 1, 1)
            for o, i in enumerate((2, 1, 0)):
                w[o, i, 0, 0] = 255.0
            b = -torch.tensor([103.939, 116.779, 123.68])
            params[name] = {"w": w.to(device), "b": b.to(device)}
            continue
        w = torch.randn(out_c, in_c, k, k, generator=generator)
        w = w * math.sqrt(2.0 / (k * k * in_c))
        params[name] = {"w": w.to(device), "b": torch.zeros(out_c, device=device)}
    return params


def _run(params: dict, x: torch.Tensor, layers, want: dict, composed=None) -> dict:
    out: dict[str, torch.Tensor] = {}
    for i, spec in layers:
        kind = spec[0]
        if kind == "pool":
            x = maxpool2_nchw(x)
            continue
        name = spec[1]
        if composed is not None and name == "conv0":
            continue  # folded into conv1_1
        p = composed if (composed is not None and name == "conv1_1") else params[name]
        x = conv2d_reflect_nchw(x, p["w"], p["b"])
        if kind == "conv":  # conv0 (conv_pre) is linear
            x = torch.relu(x)
        if i in want:
            out[want[i]] = x
    return out


def encode_multi_nchw(
    params: dict, x: torch.Tensor, targets: tuple[str, ...],
    compose_pre: bool = False,
) -> dict[str, torch.Tensor]:
    """One trunk pass over NCHW ``x``, returning every requested target.

    ``compose_pre`` folds the linear 1×1 conv0 into conv1_1
    (``convs.compose_1x1_into_conv``): the same math, one conv fewer.
    """
    deepest = max(_TARGET_TO_IDX[t] for t in targets)
    want = {_TARGET_TO_IDX[t]: t for t in targets}
    composed = None
    if compose_pre:
        wc, bc = compose_1x1_into_conv(
            params["conv0"]["w"], params["conv0"]["b"],
            params["conv1_1"]["w"], params["conv1_1"]["b"],
        )
        composed = {"w": wc, "b": bc}
    layers = list(enumerate(ENCODER_LAYERS[: deepest + 1]))
    return _run(params, x, layers, want, composed)


def encode_multi(
    params: dict, x: torch.Tensor, targets: tuple[str, ...],
    compose_pre: bool = False,
) -> dict[str, torch.Tensor]:
    """Encode ``[B, H, W, 3]`` (RGB in [0,1]); features ``[B, h, w, C]`` per target."""
    feats = encode_multi_nchw(params, to_nchw(x), targets, compose_pre)
    return {t: to_nhwc(f) for t, f in feats.items()}


def encode(
    params: dict, x: torch.Tensor, target: str, compose_pre: bool = False
) -> torch.Tensor:
    """Encode ``[B, H, W, 3]`` to ``target`` features ``[B, h, w, C]``."""
    return encode_multi(params, x, (target,), compose_pre)[target]


def encode_from_pool1(
    params: dict, x: torch.Tensor, target: str
) -> torch.Tensor:
    """Resume encoding from the post-pool1 state ``x [B, H/2, W/2, 64]``.

    ``target`` must be relu2_1 or deeper.
    """
    idx = _TARGET_TO_IDX[target]
    if idx <= _POOL1_IDX:
        raise ValueError(f"{target} is before pool1; nothing to resume")
    layers = [
        (i, ENCODER_LAYERS[i]) for i in range(_POOL1_IDX + 1, idx + 1)
    ]
    return to_nhwc(_run(params, to_nchw(x), layers, {idx: target})[target])
