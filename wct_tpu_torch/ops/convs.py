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
from torch.autograd.function import once_differentiable

from wct_tpu_torch.utils.device import cuda_ms


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2).contiguous()


def to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


def _fold_reflect(g: torch.Tensor, pad: int, dim: int) -> torch.Tensor:
    """Adjoint of reflect padding along ``dim``: the interior of ``g``
    plus each border slice added onto the rows it mirrors, top then
    bottom."""
    n = g.shape[dim] - 2 * pad
    out = g.narrow(dim, pad, n).clone()
    out.narrow(dim, 1, pad).add_(g.narrow(dim, 0, pad).flip(dim))
    out.narrow(dim, n - 1 - pad, pad).add_(g.narrow(dim, n + pad, pad).flip(dim))
    return out


class _PadReflect(torch.autograd.Function):
    """``F.pad(mode="reflect")`` with a backward in a fixed order.

    PyTorch's CUDA ``reflection_pad2d_backward`` adds with ``atomicAdd``
    (a corner pixel sums four contributions in varying order), so its
    gradients differ in the last bits from run to run. This backward
    folds the border rows back, then the columns, with slice adds.
    """

    @staticmethod
    def forward(ctx, x, pad):
        ctx.pad = pad
        return F.pad(x, (pad, pad, pad, pad), mode="reflect")

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        return _fold_reflect(_fold_reflect(g, ctx.pad, 2), ctx.pad, 3), None


def pad_reflect_nchw(x: torch.Tensor, pad: int = 1) -> torch.Tensor:
    if pad == 0:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _PadReflect.apply(x, pad)
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


# On the card, (conv shape → use cuDNN), decided once per shape by
# ``_cudnn_ok``. cuDNN's heuristics pick an FFT algorithm for a few of
# the cascade's shapes that runs 100-200× slower than PyTorch's own
# conv (256→128 channels at 128² and batch 4: 260 ms against 1.3 ms on
# an H100; PERF.md), and its autotuner picks the same one. The training
# route has a table of its own, ``CONV_TIMES``: each shape chosen on its
# forward and backward timed one by one (``_cudnn_ok_train``).
_CUDNN_OK: dict[tuple, bool] = {}
CONV_TIMES: dict[tuple, dict] = {}


@contextlib.contextmanager
def _cudnn(enabled: bool):
    prev = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = prev


def _cudnn_ok(conv) -> bool:
    """Time cuDNN and PyTorch's own conv once; keep cuDNN unless it is
    more than 2× slower. The margin keeps the choice stable from run
    to run: where both are sane they are within 2× of each other."""
    times = []
    for enabled in (True, False):
        with _cudnn(enabled):
            times.append(cuda_ms(conv, iters=1, warmup=1))
    return times[0] <= 2.0 * times[1]


def conv_by_shape(key: tuple, conv):
    """``conv()``, a conv on the card, under cuDNN or under PyTorch's own
    conv, whichever ``_cudnn_ok`` chose for ``key`` (its shapes, dtype and
    device) the first time it met it."""
    if key not in _CUDNN_OK:
        _CUDNN_OK[key] = _cudnn_ok(conv)
    with _cudnn(_CUDNN_OK[key]):
        return conv()


def _conv_backward(gy, x, w, mask):
    """(dx, dw, db) of the VALID stride-1 ``F.conv2d(x, w, b)``; an entry
    whose ``mask`` is False comes back None."""
    return torch.ops.aten.convolution_backward(
        gy, x, w, [w.shape[0]], [1, 1], [0, 0], [1, 1], False, [0, 0], 1, mask
    )


def _cudnn_ok_train(x, w, b) -> dict:
    """The forward and the backward (all three gradients) timed under
    each implementation, each a mean of 3 calls, and chosen one by one.
    The forward takes ``_cudnn_ok``'s rule. The backward keeps the
    forward's implementation unless it is more than 2× slower than the
    other there. Chosen on their sum, a fast backward kept cuDNN's
    forward where it was 5× slower (256→128 channels at 64², batch 8);
    chosen alone, cuDNN's backward after an FFT-path forward missed the
    card test's weight-gradient bound (PERF.md). Returns both
    implementations' times and the two choices."""
    mask = [True, True, True]
    row = {}
    with torch.no_grad():
        for name, enabled in (("cudnn", True), ("native", False)):
            with _cudnn(enabled):
                y = F.conv2d(x, w, b)
                row[f"{name}_fwd_ms"] = cuda_ms(lambda: F.conv2d(x, w, b), iters=3, warmup=1)
                row[f"{name}_bwd_ms"] = cuda_ms(lambda: _conv_backward(y, x, w, mask),
                                                iters=3, warmup=1)
    row["cudnn_fwd"] = row["cudnn_fwd_ms"] <= 2.0 * row["native_fwd_ms"]
    keep, other = ("cudnn", "native") if row["cudnn_fwd"] else ("native", "cudnn")
    row["cudnn_bwd"] = row["cudnn_fwd"] != (row[f"{keep}_bwd_ms"] > 2.0 * row[f"{other}_bwd_ms"])
    return row


class _ConvByShape(torch.autograd.Function):
    """VALID conv whose forward and backward each run under their own
    per-shape choice.

    ATen's ``convolution_backward`` reads ``torch.backends.cudnn.enabled``
    again when the backward runs, so setting the flag around the forward
    alone would leave every backward on cuDNN, pathological shapes too.
    """

    @staticmethod
    def forward(ctx, x, w, b, fwd_cudnn, bwd_cudnn):
        ctx.save_for_backward(x, w)
        ctx.use_cudnn = bwd_cudnn
        with _cudnn(fwd_cudnn):
            return F.conv2d(x, w, b)

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        with _cudnn(ctx.use_cudnn):
            dx, dw, db = _conv_backward(gy.contiguous(), x, w, list(ctx.needs_input_grad[:3]))
        return dx, dw, db, None, None


def _conv_train(x, w, b):
    """The conv on the card when gradients flow through it: the forward
    and the backward each under ``CONV_TIMES``'s choice for its shape."""
    key = (tuple(x.shape), tuple(w.shape), x.dtype, x.device)
    if key not in CONV_TIMES:
        CONV_TIMES[key] = _cudnn_ok_train(x.detach(), w.detach(), b.detach())
    t = CONV_TIMES[key]
    return _ConvByShape.apply(x, w, b, t["cudnn_fwd"], t["cudnn_bwd"])


def conv2d_reflect_nchw(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> torch.Tensor:
    """Reflect pad + VALID conv + bias; 1×1 convs get no pad.

    Weights and bias are cast to ``x``'s dtype and the output has that
    dtype (``wct_tpu/ops/convs.py:39-63``). A bf16 conv sums exact
    bf16 × bf16 products in f32, rounds the sum to bf16 once, and adds
    the bf16 bias: cuDNN's bf16 conv followed by PyTorch's bias add on
    the card, and the same three steps written out on the CPU, whose
    own bf16 conv depends on the machine's ISA.

    On the card a conv that gradients flow through takes the training
    route (``_conv_train``), whose forward and backward run under their
    own choices; every other call keeps the forward-only choice of
    ``conv_by_shape``, so inference gives the bits it gave before.
    """
    kh, kw = w.shape[2], w.shape[3]
    if kh != kw:
        raise ValueError(f"square kernels only, got {kh}×{kw}")
    x = pad_reflect_nchw(x, (kh - 1) // 2)
    w, b = w.to(x.dtype), b.to(x.dtype)
    if x.device.type != "cuda":
        if x.dtype == torch.bfloat16:
            return F.conv2d(x.float(), w.float()).to(x.dtype) + b[:, None, None]
        return F.conv2d(x, w, b)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad or b.requires_grad):
        return _conv_train(x, w, b)
    key = (tuple(x.shape), tuple(w.shape), x.dtype, x.device)
    return conv_by_shape(key, lambda: F.conv2d(x, w, b))


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
    a per-pixel affine commutes with reflect padding. Composed in f32
    and returned in f32; a bf16 conv casts the composed weights once.
    """
    if w0.shape[2] != 1 or w0.shape[3] != 1:
        raise ValueError("first conv must be 1×1")
    m = w0[:, :, 0, 0].float()  # [c, i]
    w32 = w.float()  # [o, c, y, x]
    wc = torch.einsum("ci,ocyx->oiyx", m, w32)
    bc = b.float() + torch.einsum("c,ocyx->o", b0.float(), w32)
    return wc, bc
