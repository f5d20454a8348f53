"""The fused cascade junction: encoder head, decoder tail, junction.

Counterpart of ``wct_tpu/ops/junction_pallas.py``. Between two cascade
levels the unfused path runs, at full image resolution, the decoder's
last [upsample, conv 64→64, conv 64→3] and the encoder's first
[conv0, conv1_1, conv1_2, pool1], each through device memory. Three
functions fuse those segments, every conv reflect-padding its own input:

- ``encoder_head``: RGB → post-pool1 state (conv0∘conv1_1 + ReLU,
  conv1_2 + ReLU, 2×2 max pool);
- ``junction``: decoder state ``d`` → upsample, dec conv 64→64 + ReLU,
  dec conv 64→3 (optional clip), conv0∘conv1_1 + ReLU, then
  ``deep=True``: conv1_2 + ReLU + pool (the next level's post-pool1
  state) or ``deep=False``: the relu1_1 features;
- ``decoder_tail``: the relu1_1 decoder's single conv 64→3 with
  per-image weights (the cascade folds each image's WCT affine into it).

Each computes in the operand type of its map, f32 or bf16, as the TPU
kernels do (``junction_pallas.py:386``, ``:486``, ``:556``). Each has a
plain PyTorch version (``_encoder_head_plain``, ``_junction_plain``,
``_decoder_tail_plain``) and a hand-written CUDA kernel per operand type
(``csrc/encoder_head.cu``, ``csrc/junction.cu`` and
``csrc/decoder_tail.cu``, each one source for both types; the designs
and bounds are in the sources). A CUDA tensor
launches the kernel of its type or raises, a CPU tensor takes the plain
version, any other device raises; there is no fallback from kernel to
plain or from one type to the other. ``encoder_head_cuda.launches``
etc. count the launches, and ``.launches_by_dtype`` counts them per
operand type.

f32 maps run the unfused chain of ``ops/convs.py``. bf16 maps follow
the TPU kernels' rule, which is not the unfused bf16 conv's: every conv
sums exact bf16 × bf16 products in f32, adds the f32 bias, applies the
ReLU, and rounds once to bf16 (``_cs_conv``); conv0 is folded into
conv1_1 and the tail's per-image weights are folded in f32 and then
rounded to bf16; biases stay f32; every intermediate map is bf16.

The public functions take and return ``[B, H, W, C]`` as the JAX
package's do; the cascade calls the ``*_nchw`` forms. Weights are the
port's OIHW.
"""

from __future__ import annotations

import ctypes
import functools
import weakref

import torch
import torch.nn.functional as F

from wct_tpu_torch.ops import _build
from wct_tpu_torch.ops.convs import (
    compose_1x1_into_conv,
    conv2d_reflect_nchw,
    maxpool2_nchw,
    pad_reflect_nchw,
    to_nchw,
    to_nhwc,
    upsample_nearest2_nchw,
)
from wct_tpu_torch.utils.profiling import span

# The kernels work on 16×16 tiles of the full-resolution image.
TILE = 16
CHANNELS = 64
# The operand types the kernels take, by the name of their C entry points.
DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def fold_conv0(w0, b0, w11, b11):
    """Fold the 1×1 preprocessing conv into conv1_1 (both linear).

    ``w0 [3, 3, 1, 1]``, ``w11 [64, 3, 3, 3]`` → ``(w' [64, 3, 3, 3],
    b' [64])`` in f32 with conv'(x) = conv1_1(conv0(x)); exact because a
    per-pixel affine commutes with reflect padding.
    """
    return compose_1x1_into_conv(w0, b0, w11, b11)


# ---------------------------------------------------------------- plain


def _cs_conv(xp, w, bias, relu: bool, acc: torch.dtype = torch.float32):
    """The TPU kernels' conv (``junction_pallas.py::_cs_conv``), VALID on
    an input that already carries its halo.

    ``xp [B, Ci, R, W+2]``, OIHW ``w [Co, Ci, 3, 3]`` (or per image
    ``[B, Co, Ci, 3, 3]``), f32 ``bias [Co]`` (or ``[B, Co]``) →
    ``[B, Co, R−2, W]`` in ``xp``'s type: the weights rounded to that
    type, the exact products summed in f32, the f32 bias added, then the
    ReLU, then one rounding. ``acc=torch.float64`` sums in float64
    instead: the reference the card's checks hold the kernels to.
    """
    x = xp.to(acc)
    wt = w.to(xp.dtype).to(acc)
    if wt.dim() == 5:  # one weight set per image: a grouped conv
        b, co = wt.shape[:2]
        y = F.conv2d(x.reshape(1, -1, *x.shape[2:]), wt.flatten(0, 1), groups=b)
        y = y.reshape(b, co, *y.shape[2:]) + bias.to(acc)[:, :, None, None]
    else:
        y = F.conv2d(x, wt) + bias.to(acc)[:, None, None]
    return (torch.relu(y) if relu else y).to(xp.dtype)


def _conv(x, w, b, relu: bool, acc: torch.dtype = torch.float32):
    """Reflect-padded 3×3 conv in the operand type of ``x``: f32 as the
    unfused chain, bf16 by the kernels' one-rounding rule, summed in
    ``acc``."""
    if x.dtype == torch.bfloat16:
        return _cs_conv(pad_reflect_nchw(x), w, b, relu, acc)
    y = conv2d_reflect_nchw(x, w, b)
    return torch.relu(y) if relu else y


def _encoder_head_plain(x, we1, be1, w12, b12, acc=torch.float32):
    """``x [B, 3, H, W]`` → ``[B, 64, H/2, W/2]``; ``we1, be1`` folded.
    ``acc``: what a bf16 map's convs sum in (``_cs_conv``)."""
    e1 = _conv(x, we1, be1, True, acc)
    return maxpool2_nchw(_conv(e1, w12, b12, True, acc))


def _junction_plain(d, wd1, bd1, wd2, bd2, we1, be1, w12, b12, deep, clip, acc=torch.float32):
    """``d [B, 64, h, w]`` → ``[B, 64, h, w]`` (deep) or ``[B, 64, 2h, 2w]``."""
    m = _conv(upsample_nearest2_nchw(d), wd1, bd1, True, acc)
    rgb = _conv(m, wd2, bd2, False, acc)
    if clip:  # commutes with the rounding: 0 and 1 are bf16 values
        rgb = rgb.clamp(0.0, 1.0)
    e1 = _conv(rgb, we1, be1, True, acc)
    if not deep:
        return e1
    return maxpool2_nchw(_conv(e1, w12, b12, True, acc))


def _decoder_tail_plain(f, w, b, clip, acc=torch.float32):
    """``f [B, 64, H, W]``, ``w [B, 3, 64, 3, 3]``, ``b [B, 3]`` →
    ``[B, 3, H, W]``: one grouped conv, a group per image."""
    out = _cs_conv(pad_reflect_nchw(f), w, b, False, acc)
    return out.clamp(0.0, 1.0) if clip else out


# -------------------------------------------------------------- kernels


def _taps(w: torch.Tensor, pad_co: int | None = None,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """OIHW ``[..., co, ci, 3, 3]`` → the FFMA stages' ``[..., ci, tap, co]``,
    f32 contiguous, ``co`` zero-padded to ``pad_co``; the values rounded
    to ``dtype`` first (bf16: what the bf16 kernels multiply by)."""
    t = w.to(dtype).float().movedim(-4, -1).flatten(-3, -2)
    if pad_co is not None:
        t = F.pad(t, (0, pad_co - t.shape[-1]))
    return t.contiguous()


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 → the nearest TF32 value (10 mantissa bits, ties away from
    zero: ``cvt.rna.tf32.f32``), as f32."""
    i = x.float().contiguous().view(torch.int32)
    mag = ((i & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000
    return (mag | (i & -0x80000000)).view(torch.float32)


def _wgmma_weights(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """OIHW ``[64, 64, 3, 3]`` → the ``wgmma`` B operand of the junction's and
    the head's 64→64 convs.

    Per tap (``tap = 3·ky + kx``) the weights as N = 64 output-channel
    rows of K-major input channels, 128 bytes a row, eight rows to a
    1 KB swizzle atom, the 16-byte chunk ``c`` of row ``co`` stored at
    chunk ``c ^ (co % 8)`` (``csrc/conv_wgmma.cuh``). bf16: ``[9, 4096]``,
    a tap's 64 channels per row (8 KB a tap), the weights rounded to
    bf16. f32: ``[9, 2, 2, 2048]``, ``[tap][half][hi, lo]``, 32 channels
    of the half per row, ``hi = tf32(w)``, ``lo = tf32(w − hi)`` (16 KB a
    half tap: hi's 8 KB, then lo's).
    """
    per_row = 64 if dtype == torch.bfloat16 else 32  # elements in 128 bytes
    per_chunk = per_row // 8  # elements in 16 bytes
    co = torch.arange(64, device=w.device)[:, None]
    k = torch.arange(per_row, device=w.device)[None, :]
    idx = ((co // 8) * 8 * per_row + (co % 8) * per_row
           + ((k // per_chunk) ^ (co % 8)) * per_chunk + k % per_chunk).flatten()
    t = w.permute(2, 3, 0, 1).reshape(9, 64, 64 // per_row, per_row).transpose(1, 2)
    if dtype == torch.bfloat16:
        src = t.to(torch.bfloat16).reshape(9, 64 * per_row)
    else:
        hi = _tf32(t)
        src = torch.stack([hi, _tf32(t - hi)], dim=2).reshape(9, 2, 2, 64 * per_row)
    out = torch.empty_like(src)
    out[..., idx] = src
    return out.contiguous()


def _b_frags_bf16(w2d: torch.Tensor, n_tiles: int) -> torch.Tensor:
    """``w2d [8·n_tiles, K]`` (K a multiple of 16) → ``mma.m16n8k16`` B
    fragments ``[K/16, n_tiles, 32, 4]`` bf16: lane ``4g + t`` of n-tile
    ``nt`` at k-step ``s`` holds ``w2d[8nt + g, 16s + 2t + {0, 1, 8, 9}]``
    (registers b0, b1, low half first)."""
    k = w2d.shape[1]
    t = w2d.to(torch.bfloat16).reshape(n_tiles, 8, k // 16, 2, 4, 2)  # nt, g, s, r, t, e
    return t.permute(2, 0, 1, 4, 3, 5).reshape(k // 16, n_tiles, 32, 4).contiguous()


def _rgb_frags_bf16(w: torch.Tensor) -> torch.Tensor:
    """The decoder's 64→3 conv OIHW ``[3, 64, 3, 3]`` → the bf16 junction's
    ``mma.sync`` B fragments for it: ``[36, 32, 4]`` bf16, k-step
    ``4·tap + q`` taking input channels ``16q .. 16q + 15`` of tap
    ``3·ky + kx``, output channels 3..7 of the n-tile zero (9,216 bytes)."""
    t = F.pad(w.permute(0, 2, 3, 1).reshape(3, 9 * 64), (0, 0, 0, 5))  # [8, tap·64 + ci]
    return _b_frags_bf16(t, 1).reshape(36, 32, 4)


def _e1_frags_bf16(w: torch.Tensor) -> torch.Tensor:
    """conv0∘conv1_1 OIHW ``[64, 3, 3, 3]`` → the bf16 junction's
    ``mma.sync`` B fragments: ``[2, 8, 32, 4]`` bf16 over ``k = 9·ci + tap``,
    zero-padded from 27 to 32 (4,096 bytes)."""
    return _b_frags_bf16(F.pad(w.reshape(64, 27), (0, 5)), 8)


def _check_input(name: str, x: torch.Tensor, channels: int, scale: int = 1) -> None:
    """What both routes need of the map ``x [B, channels, H/scale, W/scale]``."""
    if x.dim() != 4 or x.shape[1] != channels:
        raise ValueError(f"{name} needs [B, {channels}, H, W], got {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"{name} needs float32 or bfloat16, got {x.dtype}")
    h, w = scale * x.shape[2], scale * x.shape[3]
    if h <= 0 or w <= 0 or h % TILE or w % TILE:
        raise ValueError(
            f"{name} needs a full-resolution H and W that are multiples of "
            f"{TILE}, got {h}×{w}"
        )


def _check_on_card(name: str, x: torch.Tensor, weights: dict) -> None:
    """What the kernel needs beyond ``_check_input``; ``weights`` maps a
    description to ``(tensor, shape)``."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous tensor")
    if not 0 < x.shape[0] <= 65535:
        raise ValueError(f"{name} takes 1..65535 images, got {x.shape[0]}")
    for what, (t, shape) in weights.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} needs {what} {list(shape)}, got {list(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} needs {what} on {x.device}, got {t.device}")


_PTR, _INT = ctypes.c_void_p, ctypes.c_int


def _counted(fn, x: torch.Tensor) -> None:
    fn.launches += 1
    fn.launches_by_dtype[DTYPES[x.dtype]] += 1


def _counter(fn) -> None:
    fn.launches = 0
    fn.launches_by_dtype = {name: 0 for name in DTYPES.values()}


# The junction's and the head's weights in their kernels' layouts, per set of
# weight tensors: the cascade calls each with the same parameters every microbatch,
# and packing them (a dozen small ops) took about a tenth of a bf16 launch.
# An entry holds its source tensors by weak reference (an entry goes when
# one of them does) and their versions, which an in-place update bumps. On
# the card it also holds the stream that packed and an event recorded after
# the packing: a call on another stream waits for the event and marks the
# packed tensors as in use on its stream (``record_stream``), so that the
# caching allocator does not hand their memory out again, once the entry is
# replaced or evicted, before that stream's kernels have read them.
_PACKED: dict[tuple, tuple] = {}
_PACKED_MAX = 32


def _drop_packed(key: tuple, ref: weakref.ref) -> None:
    entry = _PACKED.get(key)
    if entry is not None and any(r is ref for r in entry[0]):
        del _PACKED[key]


def _packed(lib: str, dtype: torch.dtype, weights: tuple, pack) -> tuple:
    """``pack()`` for these weight tensors, once per (library, operand type,
    tensors and their versions). ``pack`` returns new tensors only."""
    key = (lib, dtype, *(id(t) for t in weights))
    versions = tuple(t._version for t in weights)
    hit = _PACKED.get(key)
    if hit is not None and hit[1] == versions and all(r() is t for r, t in zip(hit[0], weights)):
        _, _, out, stream, event = hit
        if event is not None:
            current = torch.cuda.current_stream(out[0].device)
            if current != stream:
                current.wait_event(event)
                for t in out:
                    t.record_stream(current)
        return out
    if len(_PACKED) >= _PACKED_MAX:
        _PACKED.pop(next(iter(_PACKED)))
    out = pack()
    stream = event = None
    if out[0].is_cuda:
        stream = torch.cuda.current_stream(out[0].device)
        event = torch.cuda.Event()
        event.record(stream)
    refs = tuple(weakref.ref(t, functools.partial(_drop_packed, key)) for t in weights)
    _PACKED[key] = (refs, versions, out, stream, event)
    return out


def _check_aligned(name: str, x: torch.Tensor) -> None:
    """The bf16 head copies rows of its image in 16-byte pieces, and the
    tail's TMA tensor map needs a base on a 16-byte boundary."""
    if x.data_ptr() % 16:
        raise ValueError(f"{name} needs a map on a 16-byte boundary")


def _head_weights(we1, be1, w12, b12, dtype: torch.dtype) -> tuple:
    """The head's weights in its kernel's layouts: conv1_1 as the 3→64
    stage takes it (f32 ``[3, 9, 64]`` taps, bf16 ``mma.sync`` fragments),
    conv1_2 in the ``wgmma`` layout, the biases f32."""
    t1 = _taps(we1) if dtype == torch.float32 else _e1_frags_bf16(we1)
    return t1, be1.float().clone(), _wgmma_weights(w12, dtype), b12.float().clone()


def _head_launch(name, x, we1, be1, w12, b12, defines=()) -> torch.Tensor:
    """Check the head's inputs and launch ``csrc/encoder_head.cu``'s entry of
    ``x``'s type (built with ``defines``: ``tools/head_stages`` builds it with
    ``WCT_STAGE_TIMES``)."""
    _check_input(name, x, 3)
    _check_on_card(name, x, {
        "conv1_1": (we1, (CHANNELS, 3, 3, 3)), "conv1_1's bias": (be1, (CHANNELS,)),
        "conv1_2": (w12, (CHANNELS, CHANNELS, 3, 3)), "conv1_2's bias": (b12, (CHANNELS,)),
    })
    if x.dtype == torch.bfloat16:  # f32 copies each value on its own
        _check_aligned(name, x)
    b, _, h, w = x.shape
    out = torch.empty((b, CHANNELS, h // 2, w // 2), dtype=x.dtype, device=x.device)
    t1, c1, t2, c2 = _packed("encoder_head", x.dtype, (we1, be1, w12, b12),
                             lambda: _head_weights(we1, be1, w12, b12, x.dtype))
    _build.launch(name, "encoder_head", f"encoder_head_{DTYPES[x.dtype]}", [_PTR] * 6 + [_INT] * 3,
                  (x.data_ptr(), t1.data_ptr(), c1.data_ptr(), t2.data_ptr(), c2.data_ptr(),
                   out.data_ptr(), b, h, w), x.device, defines)
    return out


def encoder_head_cuda(x, we1, be1, w12, b12) -> torch.Tensor:
    """The CUDA kernel of ``x``'s type on ``x [B, 3, H, W]`` (f32 or bf16,
    contiguous, on the card, bf16 on a 16-byte boundary; H and W multiples
    of 16) → ``[B, 64, H/2, W/2]`` of the same type.

    ``we1 [64, 3, 3, 3], be1`` is the folded conv0∘conv1_1. Launches on
    the current stream and does not synchronise; raises on any input
    the kernel does not take, and if the launch fails.
    """
    out = _head_launch("encoder_head_cuda", x, we1, be1, w12, b12)
    _counted(encoder_head_cuda, x)
    return out


_counter(encoder_head_cuda)


def _junction_launch(name, d, wd1, bd1, wd2, bd2, we1, be1, w12, b12, deep, clip,
                     defines=()) -> torch.Tensor:
    """Check the junction's inputs and launch ``csrc/junction.cu``'s entry
    of ``d``'s type (built with ``defines``), the 64→64 convs in the
    ``wgmma`` layout (``_wgmma_weights``)."""
    _check_input(name, d, CHANNELS, scale=2)
    weights = {
        "the decoder's 64→64 conv": (wd1, (CHANNELS, CHANNELS, 3, 3)),
        "the 64→64 conv's bias": (bd1, (CHANNELS,)),
        "the decoder's 64→3 conv": (wd2, (3, CHANNELS, 3, 3)),
        "the 64→3 conv's bias": (bd2, (3,)),
        "conv1_1": (we1, (CHANNELS, 3, 3, 3)), "conv1_1's bias": (be1, (CHANNELS,)),
    }
    if deep:
        if w12 is None or b12 is None:
            raise ValueError(f"{name}(deep=True) needs conv1_2's weights")
        weights.update({"conv1_2": (w12, (CHANNELS, CHANNELS, 3, 3)),
                        "conv1_2's bias": (b12, (CHANNELS,))})
    _check_on_card(name, d, weights)
    b, _, h, w = d.shape
    shape = (b, CHANNELS, h, w) if deep else (b, CHANNELS, 2 * h, 2 * w)
    out = torch.empty(shape, dtype=d.dtype, device=d.device)
    def pack():
        if d.dtype == torch.bfloat16:
            t2, t3 = _rgb_frags_bf16(wd2), _e1_frags_bf16(we1)
        else:
            t2, t3 = _taps(wd2, pad_co=4), _taps(we1)
        t1 = _wgmma_weights(wd1, d.dtype)
        c1, c2, c3 = (t.float().clone() for t in (bd1, bd2, be1))
        t4, c4 = (_wgmma_weights(w12, d.dtype), b12.float().clone()) if deep else (t1, c1)
        return t1, c1, t2, c2, t3, c3, t4, c4  # t4, c4 never read when shallow

    src = (wd1, bd1, wd2, bd2, we1, be1) + ((w12, b12) if deep else ())
    t1, c1, t2, c2, t3, c3, t4, c4 = _packed("junction", d.dtype, src, pack)
    _build.launch(name, "junction", f"junction_{DTYPES[d.dtype]}", [_PTR] * 10 + [_INT] * 5,
            (d.data_ptr(), t1.data_ptr(), c1.data_ptr(), t2.data_ptr(), c2.data_ptr(),
             t3.data_ptr(), c3.data_ptr(), t4.data_ptr(), c4.data_ptr(), out.data_ptr(),
             b, h, w, int(deep), int(clip)), d.device, defines)
    return out


def junction_cuda(d, wd1, bd1, wd2, bd2, we1, be1, w12=None, b12=None,
                  deep: bool = True, clip: bool = False) -> torch.Tensor:
    """The CUDA kernel of ``d``'s type on ``d [B, 64, h, w]`` (f32 or bf16,
    contiguous, on the card; 2h and 2w multiples of 16) → ``[B, 64, h, w]``
    (deep) or ``[B, 64, 2h, 2w]`` of the same type. Conditions as
    ``encoder_head_cuda``."""
    out = _junction_launch("junction_cuda", d, wd1, bd1, wd2, bd2, we1, be1, w12, b12, deep,
                           clip)
    _counted(junction_cuda, d)
    return out


_counter(junction_cuda)


def decoder_tail_cuda(f, w, b, clip: bool = False) -> torch.Tensor:
    """The CUDA kernel of ``f``'s type (``csrc/decoder_tail.cu``, one source
    for both) on ``f [B, 64, H, W]`` (f32 or bf16, contiguous, on the card,
    on a 16-byte boundary; H and W multiples of 16) with per-image
    ``w [B, 3, 64, 3, 3]``, ``b [B, 3]`` → ``[B, 3, H, W]`` of the same
    type. Otherwise as ``encoder_head_cuda``."""
    name = "decoder_tail_cuda"
    _check_input(name, f, CHANNELS)
    bsz, _, h, wd = f.shape
    _check_on_card(name, f, {"per-image weights": (w, (bsz, 3, CHANNELS, 3, 3)),
                             "per-image biases": (b, (bsz, 3))})
    _check_aligned(name, f)
    out = torch.empty((bsz, 3, h, wd), dtype=f.dtype, device=f.device)
    # OIHW and f32 as the cascade folds them: the kernel lays them out (and,
    # under bf16, rounds them) as it loads them.
    t, c = w.float().contiguous(), b.float().contiguous()
    _build.launch(name, "decoder_tail", f"decoder_tail_{DTYPES[f.dtype]}", [_PTR] * 4 + [_INT] * 4,
            (f.data_ptr(), t.data_ptr(), c.data_ptr(), out.data_ptr(), bsz, h, wd, int(clip)),
            f.device)
    _counted(decoder_tail_cuda, f)
    return out


_counter(decoder_tail_cuda)


def kernel_plan(kernel: str, dtype: torch.dtype) -> tuple[int, int]:
    """``(shared memory bytes per block, blocks per SM)`` of the
    ``encoder_head`` or ``junction`` kernel of ``dtype`` on the current
    card, as its source plans them."""
    if kernel not in ("encoder_head", "junction"):
        raise ValueError(f"no shared-memory plan for {kernel!r}")
    smem, blocks = ctypes.c_int(), ctypes.c_int()
    fn = getattr(_build.load(kernel), f"{kernel}_plan")
    fn.argtypes = [_INT, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    err = fn(int(dtype == torch.bfloat16), ctypes.byref(smem), ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"{kernel}_plan failed: CUDA error {err}")
    return smem.value, blocks.value


# ------------------------------------------------------------- wrappers


_SPANS = {"encoder_head": "wct.op.head", "junction": "wct.op.junction",
          "decoder_tail": "wct.op.tail"}


def _route(name: str, x: torch.Tensor, kernel, plain, *args):
    """The kernel for a CUDA tensor, the plain version for a CPU tensor,
    either in the operation's span (``_SPANS``)."""
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no {name} kernel for device {x.device}")
    with span(_SPANS[name]):
        return (kernel if x.device.type == "cuda" else plain)(x, *args)


def encoder_head_nchw(x, enc_w0, enc_b0, enc_w11, enc_b11, enc_w12, enc_b12):
    """``encoder_head`` on NCHW ``x [B, 3, H, W]`` → ``[B, 64, H/2, W/2]``."""
    _check_input("encoder_head", x, 3)
    # Folded once per set of parameters, so that the kernel's packed
    # weights (_packed) are found again on the next call.
    we1, be1 = _packed("fold_conv0", torch.float32, (enc_w0, enc_b0, enc_w11, enc_b11),
                       lambda: fold_conv0(enc_w0, enc_b0, enc_w11, enc_b11))
    return _route("encoder_head", x, encoder_head_cuda, _encoder_head_plain,
                  we1, be1, enc_w12, enc_b12)


def encoder_head(img, enc_w0, enc_b0, enc_w11, enc_b11, enc_w12, enc_b12):
    """Fused [conv0∘conv1_1 → relu → conv1_2 → relu → pool1] on RGB.

    ``img [B, H, W, 3]`` → the post-pool1 encoder state
    ``[B, H/2, W/2, 64]`` (feed ``vgg.encode_from_pool1`` for deeper
    targets). Requires H % 16 == 0 and W % 16 == 0.
    """
    return to_nhwc(encoder_head_nchw(
        to_nchw(img), enc_w0, enc_b0, enc_w11, enc_b11, enc_w12, enc_b12))


def junction_nchw(d, dec_w1, dec_b1, dec_w2, dec_b2, enc_w0, enc_b0, enc_w11, enc_b11,
                  enc_w12=None, enc_b12=None, *, deep: bool = True, clip: bool = False):
    """``junction`` on NCHW ``d [B, 64, h, w]``; returns NCHW."""
    _check_input("junction", d, CHANNELS, scale=2)
    if deep and (enc_w12 is None or enc_b12 is None):
        raise ValueError("junction(deep=True) needs conv1_2's weights")
    # Folded once per set of parameters, so that the kernel's packed
    # weights (_packed) are found again on the next call.
    we1, be1 = _packed("fold_conv0", torch.float32, (enc_w0, enc_b0, enc_w11, enc_b11),
                       lambda: fold_conv0(enc_w0, enc_b0, enc_w11, enc_b11))
    return _route("junction", d, junction_cuda, _junction_plain, dec_w1, dec_b1, dec_w2,
                  dec_b2, we1, be1, enc_w12, enc_b12, deep, clip)


def junction(d, dec_w1, dec_b1, dec_w2, dec_b2, enc_w0, enc_b0, enc_w11, enc_b11,
             enc_w12=None, enc_b12=None, *, deep: bool = True, clip: bool = False):
    """Fused [upsample → dec conv 64→64 → dec conv 64→3 → (clip) →
    enc conv0∘conv1_1 → (conv1_2 → pool)] on ``d [B, h, w, 64]``.

    ``deep=True`` → the pooled relu-conv1_2 output ``[B, h, w, 64]``
    (the encoder state right after pool1, for the next cascade level);
    ``deep=False`` → the relu1_1 features ``[B, 2h, 2w, 64]``. Requires
    2h % 16 == 0 and 2w % 16 == 0.
    """
    return to_nhwc(junction_nchw(
        to_nchw(d), dec_w1, dec_b1, dec_w2, dec_b2, enc_w0, enc_b0, enc_w11, enc_b11,
        enc_w12, enc_b12, deep=deep, clip=clip))


def decoder_tail_nchw(f, w, b, clip: bool = False):
    """``decoder_tail`` on NCHW ``f [B, 64, H, W]`` → ``[B, 3, H, W]``."""
    _check_input("decoder_tail", f, CHANNELS)
    return _route("decoder_tail", f, decoder_tail_cuda, _decoder_tail_plain, w, b, clip)


def decoder_tail(f, w, b, clip: bool = False):
    """Final 64→3 decoder conv with per-image weights, RGB out.

    ``f [B, H, W, 64]`` relu1_1-level features, ``w [B, 3, 64, 3, 3]``
    (OIHW per image, as ``decoder.fold_affine_into_conv`` returns),
    ``b [B, 3]`` → RGB ``[B, H, W, 3]``, clipped to [0, 1] if ``clip``.
    Requires H % 16 == 0, W % 16 == 0 and 64 channels.
    """
    return to_nhwc(decoder_tail_nchw(to_nchw(f), w, b, clip))
