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
import fcntl
import json
import os
from pathlib import Path

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from wct_tpu_torch.utils.device import cuda_ms
from wct_tpu_torch.utils.profiling import span


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

# The two implementations round differently, so a choice made by timing
# would let two processes write different bits from the same inputs.
# Every choice is therefore kept in one JSON file, read when a process
# meets a shape it has not chosen and written when it makes a new
# choice: ``{card key: {"inference": {shape: bool}, "training": {shape:
# row}}}``, the card key naming the card, torch's version and cuDNN's
# (``_card_key``), so a file from another card or version is simply not
# read. Writes go through a temporary file and ``os.replace`` under a
# lock, and a choice another process wrote first is the one taken.
# Deleting the file makes the next process time afresh. ``None``:
# choose in this process only (``tools/train_precision.py`` forces
# choices that must not be kept).
CHOICES_PATH: Path | None = Path(__file__).resolve().parents[2] / "build" / "conv_choices.json"


def _card_key(device: torch.device) -> str:
    return (f"{torch.cuda.get_device_name(device)} | torch {torch.__version__} | "
            f"cudnn {torch.backends.cudnn.version()}")


def _shape_key(key: tuple) -> str:
    """A table key (shapes, dtype, ..., device last) as the file keeps it:
    the device's card is in the card key."""
    return " ".join(str(list(k)) if isinstance(k, tuple) else str(k).removeprefix("torch.")
                    for k in key[:-1])


def _read_choices(path: Path) -> dict:
    """The choice file's contents, ``{}`` if there is none; raises on a
    file that is not a JSON object (delete it to time afresh)."""
    try:
        text = path.read_text()
    except FileNotFoundError:
        return {}
    try:
        data = json.loads(text)
    except ValueError as e:
        raise RuntimeError(f"unreadable conv-choice file {path} ({e}); delete it to time "
                           "the convs afresh") from e
    if not isinstance(data, dict):
        raise RuntimeError(f"conv-choice file {path} holds no JSON object; delete it")
    return data


def _choice(table: dict, section: str, key: tuple, decide):
    """``table[key]``: from this process, else from the choice file, else
    ``decide()``, which is then written to the file (unless another
    process wrote that shape first: its choice is taken). ``decide()``
    runs in the span ``wct.conv_choice``."""
    if key in table:
        return table[key]
    if CHOICES_PATH is None:
        with span("wct.conv_choice"):
            table[key] = decide()
        return table[key]
    card, shape = _card_key(key[-1]), _shape_key(key)
    found = _read_choices(CHOICES_PATH).get(card, {}).get(section, {})
    if shape in found:
        table[key] = found[shape]
        return table[key]
    with span("wct.conv_choice"):
        value = decide()
    CHOICES_PATH.parent.mkdir(parents=True, exist_ok=True)
    with open(CHOICES_PATH.with_name(CHOICES_PATH.name + ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        data = _read_choices(CHOICES_PATH)
        entries = data.setdefault(card, {}).setdefault(section, {})
        value = entries.setdefault(shape, value)
        tmp = CHOICES_PATH.with_name(f"{CHOICES_PATH.name}.{os.getpid()}.tmp")
        tmp.write_text(json.dumps(data, indent=1, sort_keys=True))
        os.replace(tmp, CHOICES_PATH)
    table[key] = value
    return value


@contextlib.contextmanager
def _cudnn(enabled: bool):
    prev = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = prev


def _cudnn_ok(conv, device) -> bool:
    """Time cuDNN and PyTorch's own conv once; keep cuDNN unless it is
    more than 2× slower. The margin keeps the choice stable from run
    to run: where both are sane they are within 2× of each other. The
    card is drained first, so that no other stream's work (a mesh's other
    shards) runs inside the timing."""
    torch.cuda.synchronize(device)
    times = []
    for enabled in (True, False):
        with _cudnn(enabled):
            times.append(cuda_ms(conv, iters=1, warmup=1))
    return times[0] <= 2.0 * times[1]


def conv_by_shape(key: tuple, conv):
    """``conv()``, a conv on the card, under cuDNN or under PyTorch's own
    conv, whichever ``_cudnn_ok`` chose for ``key`` (its shapes, dtype and
    device) the first time this card, torch and cuDNN met it (the choice
    file, ``CHOICES_PATH``)."""
    use = _choice(_CUDNN_OK, "inference", key, lambda: _cudnn_ok(conv, key[-1]))
    with _cudnn(use):
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
    implementations' times and the two choices. Times on a drained card,
    as ``_cudnn_ok``."""
    mask = [True, True, True]
    row = {}
    torch.cuda.synchronize(x.device)
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
    t = _choice(CONV_TIMES, "training", key,
                lambda: _cudnn_ok_train(x.detach(), w.detach(), b.detach()))
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

    Each conv entry of this module runs in the span ``wct.op.conv`` (the
    pad, the casts, the conv and its bias); one that calls another
    records one range (``utils.profiling.span``).
    """
    with span("wct.op.conv"):
        kh, kw = w.shape[2], w.shape[3]
        if kh != kw:
            raise ValueError(f"square kernels only, got {kh}×{kw}")
        return conv2d_valid_nchw(pad_reflect_nchw(x, (kh - 1) // 2), w, b)


def conv2d_valid_nchw(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """VALID conv + bias of an already padded ``x``: what
    ``conv2d_reflect_nchw`` runs after its pad, on the same routes.
    ``parallel.mesh`` pads a height shard with its neighbours' rows and
    calls this."""
    with span("wct.op.conv"):
        w, b = w.to(x.dtype), b.to(x.dtype)
        if x.device.type == "cuda" and torch.is_grad_enabled() and (
                x.requires_grad or w.requires_grad or b.requires_grad):
            return _conv_train(x, w, b)
        return _stock_conv(x, w, b)


def _stock_conv(x, w, b=None, padding: int | tuple[int, int] = 0, groups: int = 1):
    """``F.conv2d(x, w, b, padding=padding, groups=groups)`` on the port's
    routes, ``w`` and ``b`` already in ``x``'s dtype (``b`` may be None).

    On the CPU a bf16 conv is an f32 conv, one rounding, then the bf16
    bias. On the card the conv runs under ``conv_by_shape``. Its key is
    ``(x, w, dtype, device)`` for a VALID ungrouped conv, the key every
    earlier route has; a zero-padded or grouped conv adds ``padding=p``
    (or ``padding=(ph, pw)``) and ``groups=g`` before the device, so it
    never shares a choice with a VALID conv of the same tensor shapes.
    """
    if x.device.type != "cuda":
        if x.dtype == torch.bfloat16:
            y = F.conv2d(x.float(), w.float(), padding=padding, groups=groups).to(x.dtype)
            return y if b is None else y + b[:, None, None]
        return F.conv2d(x, w, b, padding=padding, groups=groups)
    extra = ((f"padding={padding}",) if padding else ()) + ((f"groups={groups}",) if groups != 1 else ())
    key = (tuple(x.shape), tuple(w.shape), x.dtype, *extra, x.device)
    return conv_by_shape(key, lambda: F.conv2d(x, w, b, padding=padding, groups=groups))


def conv2d_reflect_ring_nchw(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Reflect conv without the reflect-padded copy
    (``wct_tpu/ops/convs.py:66-132``).

    The bulk runs as a zero-padded SAME conv, so the ``[B, C, H+2p,
    W+2p]`` copy never exists. The p-pixel border is then recomputed
    from four thin reflect-padded strips, top and bottom of height 2p and
    left and right of full height (the side strips own the corners), and
    spliced in; the bias is added last. A 1×1 kernel has no border, and a
    map with H or W below 2p has no room for the strips: both take
    ``conv2d_reflect_nchw``, as the reference does.
    """
    with span("wct.op.conv"):
        k = w.shape[2]
        if k != w.shape[3]:
            raise ValueError(f"square kernels only, got {k}×{w.shape[3]}")
        p = (k - 1) // 2
        h, wd = x.shape[2], x.shape[3]
        if p == 0 or h < 2 * p or wd < 2 * p:
            return conv2d_reflect_nchw(x, w, b)
        w, b = w.to(x.dtype), b.to(x.dtype)
        out = _stock_conv(x, w, padding=p)
        # Output rows [0, p) read input rows [-p, 2p): the first 2p rows,
        # reflected upwards by p, reflect-padded sideways, VALID.
        top = F.pad(F.pad(x[:, :, : 2 * p], (0, 0, p, 0), mode="reflect"), (p, p, 0, 0), mode="reflect")
        bot = F.pad(F.pad(x[:, :, -2 * p :], (0, 0, 0, p), mode="reflect"), (p, p, 0, 0), mode="reflect")
        left = F.pad(F.pad(x[..., : 2 * p], (p, 0, 0, 0), mode="reflect"), (0, 0, p, p), mode="reflect")
        right = F.pad(F.pad(x[..., -2 * p :], (0, p, 0, 0), mode="reflect"), (0, 0, p, p), mode="reflect")
        out[:, :, :p] = _stock_conv(top, w)
        out[:, :, h - p :] = _stock_conv(bot, w)
        out[..., :p] = _stock_conv(left, w)
        out[..., wd - p :] = _stock_conv(right, w)
        return out + b[:, None, None]


def conv2d_ring_rows_nchw(
    xh: torch.Tensor, w: torch.Tensor, b: torch.Tensor, top_edge: bool, bottom_edge: bool
) -> torch.Tensor:
    """``conv2d_reflect_ring_nchw``'s math on a band of rows of a taller
    map, for a height shard (``parallel.mesh``): ``xh [B, C, r + 2, W]`` is
    the band with one row above and below it, the neighbours' rows, or at
    the image's top (``top_edge``) and bottom (``bottom_edge``) the rows a
    reflect pad would put there; a 3×3 ``w`` gives ``[B, Co, r, W]``.

    The bulk is a conv VALID over the rows and zero-padded over the width,
    so no reflect-padded copy of the band is made. An image edge the band
    holds is recomputed from the ring's row strip, the two rows next to it
    reflected outwards and padded sideways, and the two columns from the
    ring's side strips (which own the corners); the bias is added last.
    """
    with span("wct.op.conv"):
        k = w.shape[2]
        if k != 3 or w.shape[3] != 3:
            raise ValueError(f"a band of rows takes a 3×3 conv, got {k}×{w.shape[3]}")
        r, wd = xh.shape[2] - 2, xh.shape[3]
        w, b = w.to(xh.dtype), b.to(xh.dtype)
        out = _stock_conv(xh, w, padding=(0, 1))
        sideways = lambda t: F.pad(t, (1, 1, 0, 0), mode="reflect")  # noqa: E731
        if top_edge:
            out[:, :, :1] = _stock_conv(sideways(xh[:, :, :3]), w)
        if bottom_edge:
            out[:, :, r - 1:] = _stock_conv(sideways(xh[:, :, -3:]), w)
        out[..., :1] = _stock_conv(F.pad(xh[..., :2], (1, 0, 0, 0), mode="reflect"), w)
        out[..., wd - 1:] = _stock_conv(F.pad(xh[..., -2:], (0, 1, 0, 0), mode="reflect"), w)
        return out + b[:, None, None]


def conv2d_reflect_perimage_nchw(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Reflect conv where every image has its own weights
    (``wct_tpu/ops/convs.py:135-171``): ``x [B, Ci, H, W]``,
    ``w [B, Co, Ci, k, k]``, ``b [B, Co]`` → ``[B, Co, H, W]``: the
    reflect pad, then ``conv2d_valid_perimage_nchw``.
    """
    with span("wct.op.conv"):
        k = w.shape[3]
        if k != w.shape[4]:
            raise ValueError(f"square kernels only, got {k}×{w.shape[4]}")
        return conv2d_valid_perimage_nchw(pad_reflect_nchw(x, (k - 1) // 2), w, b)


def conv2d_valid_perimage_nchw(xp: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """VALID conv + bias with per-image weights of an already padded ``xp``
    (a height shard pads with its neighbours' rows, ``parallel.mesh``).

    One grouped conv (``groups=B``) over the map seen as
    ``[1, B·Ci, ·, ·]``: output group g, channels ``[g·Co, (g+1)·Co)``,
    is image g's. Weights and bias are cast to ``xp``'s dtype (the
    transform fold makes them in f32), the bias added after the conv.
    """
    with span("wct.op.conv"):
        nb, ci = xp.shape[:2]
        co, k = w.shape[1], w.shape[3]
        w, b = w.to(xp.dtype), b.to(xp.dtype)
        y = _stock_conv(xp.reshape(1, nb * ci, *xp.shape[2:]), w.reshape(nb * co, ci, k, k), groups=nb)
        return y.reshape(nb, co, *y.shape[2:]) + b[:, :, None, None]


def oihw_from_hwio(w) -> torch.Tensor:
    """A conv weight in the JAX package's HWIO layout (an array or a
    tensor) as the port's OIHW tensor, the same values."""
    return torch.as_tensor(w).permute(3, 2, 0, 1).contiguous()


def quantize_weight_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 quantization of OIHW weights
    (``wct_tpu/ops/convs.py:201-214``): ``(wq int8 [co, ci, kh, kw],
    scale f32 [co])`` with ``wq·scale ≈ w``.

    The scale is ``max|w| / 127`` per output channel, floored at 1e-12;
    ``wq = clip(round(w / scale), ±127)``, rounding half to even as
    ``jnp.round`` does, so the JAX package's HWIO result, transposed, is
    the same bits (``oihw_from_hwio``).
    """
    scale = (w.float().abs().amax(dim=(1, 2, 3)) / 127.0).clamp_min(1e-12)
    wq = torch.round(w.float() / scale[:, None, None, None]).clamp(-127, 127)
    return wq.to(torch.int8), scale


def quantize_act_int8(x: torch.Tensor, act_scale=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8 quantization of an activation:
    ``(xq int8, sx f32 scalar)``, ``sx`` the static ``act_scale`` or
    ``max|x| / 127`` (the dynamic default), floored at 1e-12."""
    if act_scale is None:
        sx = x.float().abs().amax() / 127.0
    else:
        sx = torch.as_tensor(act_scale, dtype=torch.float32, device=x.device)
    sx = sx.clamp_min(1e-12)
    return torch.round(x.float() / sx).clamp(-127, 127).to(torch.int8), sx


def conv2d_int8_sums_nchw(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The exact int32 sums of a VALID stride-1 conv of int8 ``xq [B, Ci,
    H, W]`` with int8 OIHW ``wq``: ``[B, Co, H−k+1, W−k+1]``.

    The JAX package accumulates in int32 (``preferred_element_type``); an
    f32 conv would not be exact (9·512·127² ≈ 7.4e7 > 2²⁴). On the card
    the taps are gathered into patches ``[B·H·W, k·k·Ci]`` and multiplied
    by the weights ``[k·k·Ci, Co]`` in ``torch._int_mm`` (cuBLASLt's int8
    product, int32 sums), both sides zero-padded to the multiples of 8
    it needs; on the CPU a float64 conv, exact at these sizes (|sum| <
    2⁵³), rounded back to int32.
    """
    if xq.device.type != "cuda":
        return F.conv2d(xq.double(), wq.double()).round().to(torch.int32)
    return _int8_sums_by_patches(xq, wq, torch._int_mm)


def _int8_sums_by_patches(xq: torch.Tensor, wq: torch.Tensor, int_mm) -> torch.Tensor:
    """``conv2d_int8_sums_nchw`` as the card computes it, with the int8 ×
    int8 → int32 product ``int_mm`` passed in (the tests give the CPU an
    exact stand-in for ``torch._int_mm``)."""
    k = wq.shape[2]
    b, ci, h, w = xq.shape
    ho, wo = h - k + 1, w - k + 1
    xn = xq.permute(0, 2, 3, 1)
    patches = torch.stack(
        [xn[:, dy:dy + ho, dx:dx + wo] for dy in range(k) for dx in range(k)], dim=3
    ).reshape(b * ho * wo, k * k * ci)
    wm = wq.permute(2, 3, 1, 0).reshape(k * k * ci, -1)
    co = wm.shape[1]
    pk, pn = -(k * k * ci) % 8, -co % 8
    if pk:
        patches = F.pad(patches, (0, pk))
    if pk or pn:
        wm = F.pad(wm, (0, pn, 0, pk))
    rows = patches.shape[0]
    if rows <= 16:  # cuBLASLt's int8 product needs more than 16 rows
        patches = F.pad(patches, (0, 0, 0, 17 - rows))
    y = int_mm(patches.contiguous(), wm.contiguous())[:rows, :co]
    return y.reshape(b, ho, wo, co).permute(0, 3, 1, 2)


def conv2d_reflect_int8_nchw(
    x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor, b: torch.Tensor, act_scale=None,
) -> torch.Tensor:
    """Reflect conv with int8 weights and activations
    (``wct_tpu/ops/convs.py:217-257``): ``x [B, Ci, H, W]``, ``wq`` int8
    OIHW with its per-output-channel ``w_scale`` (``quantize_weight_int8``).

    The reflect-padded ``x`` is quantized per tensor (``quantize_act_int8``:
    the dynamic max, or a static calibrated ``act_scale``), the conv sums
    exactly in int32 (``conv2d_int8_sums_nchw``), and the result is
    dequantized in the reference's order, ``yq·(sx·w_scale)`` then ``+ b``,
    in f32, and returned in ``x``'s dtype.
    """
    xp = pad_reflect_nchw(x, (wq.shape[2] - 1) // 2)
    xq, sx = quantize_act_int8(xp, act_scale)
    yq = conv2d_int8_sums_nchw(xq, wq)
    y = yq.float() * (sx * w_scale.float())[:, None, None]
    return (y + b.float()[:, None, None]).to(x.dtype)


def conv2d_reflect_int8(
    x: torch.Tensor, wq: torch.Tensor, w_scale: torch.Tensor, b: torch.Tensor, act_scale=None,
) -> torch.Tensor:
    """``conv2d_reflect_int8_nchw`` on ``[B, H, W, C]``; ``wq`` stays OIHW."""
    return to_nhwc(conv2d_reflect_int8_nchw(to_nchw(x), wq, w_scale, b, act_scale))


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


def conv2d_reflect_ring(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``conv2d_reflect_ring_nchw`` on ``[B, H, W, C]``."""
    return to_nhwc(conv2d_reflect_ring_nchw(to_nchw(x), w, b))


def conv2d_reflect_perimage(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``conv2d_reflect_perimage_nchw`` on ``[B, H, W, Ci]``; the weights
    stay the port's per-image OIHW ``[B, Co, Ci, k, k]``."""
    return to_nhwc(conv2d_reflect_perimage_nchw(to_nchw(x), w, b))


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
