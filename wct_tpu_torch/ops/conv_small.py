"""Small-channel 3×3 reflect conv in bf16: the plain version and the CUDA kernel.

Counterpart of ``wct_tpu/ops/conv_pallas.py`` and of the two layout
experiments in ``scripts/exp_nchw_conv.py``; all three TPU kernels
compute one function:

    out = bf16(act(bias + Σ_{ci,dy,dx} x[reflect(y+dy−1), reflect(x+dx−1), ci] · w[o, ci, dy, dx]))

on bf16 ``x`` with at most 64 channels in and out, every bf16 × bf16
product exact, the sum in f32 and rounded once, ``act`` ReLU or nothing.

- ``conv3x3_reflect_small(x [B, H, W, C], w, b, relu)`` is the NHWC
  form (``conv3x3_reflect_pallas``, ``conv3x3_reflect_nhwc_io``),
  ``conv3x3_reflect_small_nchw(x [B, C, H, W], …)`` the NCHW form
  (``conv3x3_reflect_nchw``) on the port's native layout. One kernel
  body, ``csrc/conv3x3_small.cu`` (``wgmma`` from TMA-staged tiles),
  reads and writes either layout in place and lays the OIHW weights out
  itself, so a call launches that kernel and nothing else; its design
  and bound are in the source.
- ``_conv3x3_small_plain`` is the plain PyTorch version. A CUDA tensor
  launches the kernel or raises, a CPU tensor takes the plain version,
  any other device raises; there is no fallback from kernel to plain.
  ``conv3x3_small_cuda.launches`` counts the launches, and
  ``.launches_by_layout`` counts them per entry.
- ``conv2d_reflect_fused(x, w, b, relu, impl)`` keeps the JAX package's
  dispatcher: ``impl='pallas_small'`` (the name the JAX package gives
  the kernel route) sends an eligible conv to the kernel, everything
  else and ``impl='xla'`` to the stock conv + ReLU. Eligibility is a
  rule on shape and dtype alone.

Weights are the port's OIHW ``[C_out, C_in, 3, 3]``;
``weights_from_hwio`` turns the JAX package's ``[3, 3, C_in, C_out]``
numpy array into that operand. No cascade configuration calls these
functions, as none does in the JAX package.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from wct_tpu_torch.ops import _build
from wct_tpu_torch.ops.convs import conv2d_reflect, pad_reflect_nchw, to_nchw, to_nhwc
from wct_tpu_torch.utils.device import resolve_device

MAX_CHANNELS = 64
# H and W must be multiples of 8: the TPU kernel's row tile
# (``conv_pallas.py:74``), kept as the gate so both packages route the
# same shapes; the CUDA kernel's tile rows and its 8-pixel segments use it.
ALIGN = 8


def weights_from_hwio(w, b, device: str | torch.device = "cuda"):
    """JAX-layout conv parameters → the port's: ``w [3, 3, C_in, C_out]``
    (numpy, f32 or bf16-valued) → OIHW f32 tensor, ``b`` → f32 tensor,
    on ``device`` (the card unless the caller asks for the CPU)."""
    device = resolve_device(device)
    w = np.asarray(w, dtype=np.float32).transpose(3, 2, 0, 1)
    return (torch.tensor(np.ascontiguousarray(w), device=device),
            torch.tensor(np.asarray(b, dtype=np.float32), device=device))


def _eligible(x: torch.Tensor, w: torch.Tensor) -> bool:
    """Whether NHWC ``x [B, H, W, C_in]`` with OIHW ``w`` takes the kernel.

    The JAX package's gate (``conv_pallas.py:116-126``) on the port's
    layouts: 3×3, bf16, at most 64 channels in and out, H and W at
    least 8 and multiples of 8. Its last clause, an estimate of the
    TPU's scratch memory, is dropped: the CUDA kernel's tile does not
    grow with W.
    """
    if w.dim() != 4 or w.shape[2] != 3 or w.shape[3] != 3:
        return False
    if x.dtype != torch.bfloat16:
        return False
    _, h, wd, cin = x.shape
    cout = w.shape[0]
    return not (
        cin > MAX_CHANNELS or cout > MAX_CHANNELS
        or h < ALIGN or h % ALIGN or wd < ALIGN or wd % ALIGN
    )


def _conv3x3_small_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, relu: bool):
    """NCHW ``x [B, C_in, H, W]`` bf16 → ``[B, C_out, H, W]`` bf16: the
    weights rounded to bf16, both upcast, one f32 conv on the
    reflect-padded map with the f32 bias, ReLU, one rounding."""
    out = F.conv2d(pad_reflect_nchw(x.float()), w.to(torch.bfloat16).float(), b.float())
    return (torch.relu(out) if relu else out).to(torch.bfloat16)


def _check(name: str, x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, nhwc: bool) -> None:
    if x.dim() != 4:
        raise ValueError(f"{name} needs a 4-D map, got {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name} needs bfloat16, got {x.dtype}")
    if not _eligible(x if nhwc else x.permute(0, 2, 3, 1), w):
        raise ValueError(
            f"{name} needs a 3×3 conv with at most {MAX_CHANNELS} channels in and out "
            f"and H, W multiples of {ALIGN}; got x {tuple(x.shape)} "
            f"({'NHWC' if nhwc else 'NCHW'}), w {tuple(w.shape)}"
        )
    cin = x.shape[3] if nhwc else x.shape[1]
    if w.shape[1] != cin or tuple(b.shape) != (w.shape[0],):
        raise ValueError(
            f"{name}: w {tuple(w.shape)} and b {tuple(b.shape)} do not fit {cin} input channels"
        )


def _weight_layout(w: torch.Tensor) -> np.ndarray:
    """The bytes ``csrc/conv3x3_small.cu`` lays out in shared memory from
    OIHW ``w``, as bf16 bit patterns (``uint16``); its plain statement,
    which the tests read back as ``wgmma``'s descriptor does.

    K-group ``kg = tap·G + g`` (``G = ⌈C_in/8⌉`` rounded up to 1, 2, 4 or
    8, the tile's 16-byte groups a pixel; tap = 3·dy + dx) holds
    ``w[n, 8g:8g+8, dy, dx]`` of output channel ``n`` in chunk ``kg // 8``
    (``C_pad`` rows of 128 bytes, ``C_pad`` = 8 for C_out ≤ 8, else 64),
    16-byte unit ``kg % 8`` of row ``n``, stored at unit ``(kg % 8) ^ (n %
    8)`` (the 128-byte swizzle), rows in 1 KB atoms of 8. Everything else,
    channels past C_in and rows past C_out included, is zero.
    """
    cout, cin = w.shape[:2]
    groups = 1 << (-(-cin // 8) - 1).bit_length()
    co_pad = 8 if cout <= 8 else MAX_CHANNELS
    out = np.zeros(-(-9 * groups // 8) * co_pad * 64, np.uint16)
    bits = w.detach().cpu().to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    n, ci, dy, dx = np.meshgrid(*(np.arange(k) for k in bits.shape), indexing="ij")
    kg = (3 * dy + dx) * groups + ci // 8
    byte = ((kg // 8) * co_pad * 128 + (n // 8) * 1024 + (n % 8) * 128
            + 16 * ((kg % 8) ^ (n % 8)) + 2 * (ci % 8))
    out[byte.ravel() // 2] = bits.ravel()
    return out


def _launch(name: str, x, w, b, relu: bool, nhwc: bool, defines: tuple[str, ...] = ()):
    """Check ``x`` and launch ``csrc/conv3x3_small.cu`` (built with
    ``defines``) on it; the output, as ``conv3x3_small_cuda`` returns it."""
    _check(name, x, w, b, nhwc)
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got {x.device}")
    if w.device != x.device or b.device != x.device:
        raise ValueError(f"{name} needs weights on {x.device}, got {w.device}, {b.device}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} needs a contiguous tensor on a 16-byte boundary")
    if x.shape[0] == 0:
        raise ValueError(f"{name} needs at least one image")
    cout, cin = w.shape[0], w.shape[1]
    bsz = x.shape[0]
    h, wd = (x.shape[1], x.shape[2]) if nhwc else (x.shape[2], x.shape[3])
    shape = (bsz, h, wd, cout) if nhwc else (bsz, cout, h, wd)
    out = torch.empty(shape, dtype=torch.bfloat16, device=x.device)
    # The kernel lays the OIHW f32 weights out itself; weights of another
    # type are rounded to bf16 first, as the plain version rounds them.
    if w.dtype != torch.float32:
        w = w.to(torch.bfloat16).float()
    w, b = w.contiguous(), b.float().contiguous()
    ptr, integer = ctypes.c_void_p, ctypes.c_int
    _build.launch(name, "conv3x3_small", "conv3x3_small_bf16", [ptr] * 4 + [integer] * 7,
                  (x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                   bsz, h, wd, cin, cout, int(relu), int(nhwc)), x.device, defines)
    return out


def conv3x3_small_cuda(x, w, b, relu: bool = False, nhwc: bool = False) -> torch.Tensor:
    """The CUDA kernel on ``x`` (bf16, contiguous, on the card):
    ``[B, C_in, H, W]``, or ``[B, H, W, C_in]`` with ``nhwc``; the
    output has the same layout. Launches on the current stream and does
    not synchronise; raises on any input the kernel does not take, and
    if the launch fails."""
    out = _launch("conv3x3_small_cuda", x, w, b, relu, nhwc)
    conv3x3_small_cuda.launches += 1
    conv3x3_small_cuda.launches_by_layout["nhwc" if nhwc else "nchw"] += 1
    return out


conv3x3_small_cuda.launches = 0
conv3x3_small_cuda.launches_by_layout = {"nchw": 0, "nhwc": 0}


def conv3x3_reflect_small_nchw(x, w, b, relu: bool = False) -> torch.Tensor:
    """3×3 reflect conv + bias (+ ReLU) on NCHW bf16 ``x [B, C_in, H, W]``
    → ``[B, C_out, H, W]`` bf16; the caller has checked ``_eligible``."""
    if x.device.type == "cuda":
        return conv3x3_small_cuda(x, w, b, relu, nhwc=False)
    if x.device.type != "cpu":
        raise ValueError(f"no conv3x3_small kernel for device {x.device}")
    _check("conv3x3_reflect_small_nchw", x, w, b, nhwc=False)
    return _conv3x3_small_plain(x, w, b, relu)


def conv3x3_reflect_small(x, w, b, relu: bool = False) -> torch.Tensor:
    """The same on NHWC bf16 ``x [B, H, W, C_in]`` → ``[B, H, W, C_out]``.
    On the card the kernel reads and writes NHWC in place."""
    if x.device.type == "cuda":
        return conv3x3_small_cuda(x, w, b, relu, nhwc=True)
    if x.device.type != "cpu":
        raise ValueError(f"no conv3x3_small kernel for device {x.device}")
    _check("conv3x3_reflect_small", x, w, b, nhwc=True)
    return to_nhwc(_conv3x3_small_plain(to_nchw(x), w, b, relu))


def conv2d_reflect_fused(x, w, b, relu: bool = False, impl: str = "xla") -> torch.Tensor:
    """Reflect conv + bias (+ ReLU) on ``x [B, H, W, C_in]``, dispatching
    to the kernel.

    ``impl='pallas_small'`` routes eligible 3×3 small-channel bf16
    convs through ``conv3x3_reflect_small``; everything else, and
    ``impl='xla'``, uses the stock ``convs.conv2d_reflect`` followed by
    the optional ReLU (``conv_pallas.py:205-221``). The kernel route
    rounds once, after bias and ReLU; the stock bf16 conv rounds the
    sum and then adds the bias, so the two agree to an ulp or two.
    """
    if impl == "pallas_small" and _eligible(x, w):
        return conv3x3_reflect_small(x, w, b, relu)
    out = conv2d_reflect(x, w, b)
    return torch.relu(out) if relu else out
