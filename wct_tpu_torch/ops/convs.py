"""Convolution primitives: reflect-padded conv, NN-upsample, maxpool.

Counterpart of ``wct_tpu/ops/convs.py``. Every encoder and decoder conv
is reflect-padded, pools are 2×2 max with a floor, and decoder
upsampling is 2× nearest-neighbour.

The public functions keep the JAX package's layout: ``x`` is
``[B, H, W, C]``. Weights are the port's OIHW (``[out, in, kh, kw]``,
see ``train.checkpoint.params_from_numpy``). The models run NCHW
internally, through the ``*_nchw`` forms, so a cascade never pays a
layout copy per conv.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

from wct_tpu_torch.utils.device import cuda_ms


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def pad_reflect_nchw(x: torch.Tensor, pad: int = 1) -> torch.Tensor:
    if pad == 0:
        return x
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


# On the card, (conv shape → use cuDNN), decided once per shape by
# ``_cudnn_ok``. cuDNN's heuristics pick an FFT algorithm for a few of
# the cascade's shapes that runs 100-200× slower than PyTorch's own
# conv (256→128 channels at 128² and batch 4: 260 ms against 1.3 ms on
# an H100; PERF.md), and its autotuner picks the same one.
_CUDNN_OK: dict[tuple, bool] = {}


@contextlib.contextmanager
def _cudnn(enabled: bool):
    prev = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = prev


def _cudnn_ok(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> bool:
    """Time cuDNN and PyTorch's own conv once; keep cuDNN unless it is
    more than 2× slower. The margin keeps the choice stable from run
    to run: where both are sane they are within 2× of each other."""
    times = []
    for enabled in (True, False):
        with _cudnn(enabled):
            times.append(cuda_ms(lambda: F.conv2d(x, w, b), iters=1, warmup=1))
    return times[0] <= 2.0 * times[1]


def conv2d_reflect_nchw(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Reflect pad + VALID conv + bias; 1×1 convs get no pad."""
    kh, kw = w.shape[2], w.shape[3]
    if kh != kw:
        raise ValueError(f"square kernels only, got {kh}×{kw}")
    x = pad_reflect_nchw(x, (kh - 1) // 2)
    w, b = w.to(x.dtype), b.to(x.dtype)
    if x.device.type != "cuda":
        return F.conv2d(x, w, b)
    key = (tuple(x.shape), tuple(w.shape), x.dtype, x.device)
    if key not in _CUDNN_OK:
        _CUDNN_OK[key] = _cudnn_ok(x, w, b)
    with _cudnn(_CUDNN_OK[key]):
        return F.conv2d(x, w, b)


def maxpool2_nchw(x: torch.Tensor) -> torch.Tensor:
    """2×2 / stride-2 max pool, VALID (odd sizes floor)."""
    return F.max_pool2d(x, kernel_size=2, stride=2)


def upsample_nearest2_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def pad_reflect(x: torch.Tensor, pad: int = 1) -> torch.Tensor:
    """Reflect-pad the spatial dims of ``[B, H, W, C]``."""
    return to_nhwc(pad_reflect_nchw(to_nchw(x), pad))


def conv2d_reflect(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """``conv2d_reflect_nchw`` on ``[B, H, W, C]``."""
    return to_nhwc(conv2d_reflect_nchw(to_nchw(x), w, b))


def maxpool2(x: torch.Tensor) -> torch.Tensor:
    """``maxpool2_nchw`` on ``[B, H, W, C]``."""
    return to_nhwc(maxpool2_nchw(to_nchw(x)))


def upsample_nearest2(x: torch.Tensor) -> torch.Tensor:
    """2× nearest-neighbour upsample of ``[B, H, W, C]``."""
    return to_nhwc(upsample_nearest2_nchw(to_nchw(x)))


def compose_1x1_into_conv(
    w0: torch.Tensor, b0: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold a preceding linear 1×1 conv into the following conv.

    ``conv(w, b)(conv1x1(w0, b0)(x)) == conv(w', b')(x)`` with
    ``w'[:, :, y, x] = w[:, :, y, x] · W0`` and ``b' = b + Σ_taps w · b0``:
    a per-pixel affine commutes with reflect padding. Composed in f32.
    """
    if w0.shape[2] != 1 or w0.shape[3] != 1:
        raise ValueError("first conv must be 1×1")
    m = w0[:, :, 0, 0].float()  # [c, i]
    w32 = w.float()  # [o, c, y, x]
    wc = torch.einsum("ci,ocyx->oiyx", m, w32)
    bc = b.float() + torch.einsum("c,ocyx->o", b0.float(), w32)
    return wc, bc
