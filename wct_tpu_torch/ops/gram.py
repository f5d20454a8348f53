"""Channel mean and centred Gram in two passes: the plain version and the CUDA kernel.

Counterpart of ``wct_tpu/ops/gram_pallas.py``. For a feature matrix
``x [N, C]`` the WCT needs ``mean(x) [C]`` and the un-normalised
``(x−μ)ᵀ(x−μ) [C, C]`` (the caller divides by N − 1, as
``ops.wct._gram`` does). The kernel reads ``x`` twice, never writes a
centred copy, computes only the tiles on and above the diagonal and
mirrors them (the Gram is exactly symmetric), and adds its partial sums
in a fixed order (atomics only count the blocks that have finished), so
an image's result is the same bits alone and in any batch.

- ``centered_gram(x [N, C]) → (gram [C, C], mean [C])`` keeps the JAX
  package's signature and return order.
- ``centered_gram_cn(x [B, C, N]) → (gram [B, C, C], mean [B, C])`` is
  the form the kernel runs on: the port's channel-major feature maps
  (an NCHW map with its spatial dims flattened, ``ops/wct.py::_cn``),
  batched over a grid dimension as ``vmap`` lifts the TPU kernel's
  grid. f32 or bf16 input (bf16 is upcast as it is read), f32 results.
- ``_centered_gram_plain`` is the plain PyTorch version and
  ``centered_gram_cuda`` the kernel ``csrc/centered_gram.cu`` (design
  and bound in the source). A CUDA tensor launches the kernel or
  raises, a CPU tensor takes the plain version, any other device
  raises. ``centered_gram_cuda.launches`` counts the launches.

Every covariance of the cascade comes from here: ``ops.wct._gram_cn``
divides ``centered_gram_cn``'s Gram by N − 1, for the content batch and
for the style, at every level and on every route (the JAX package's
cascade keeps its own contractions and reaches the TPU kernel only
from its tests).
"""

from __future__ import annotations

import ctypes

import torch

from wct_tpu_torch.ops import _build, reductions
from wct_tpu_torch.utils.profiling import span

# Columns of x per split of the sum over N: 1,024, or the multiple of 1,024
# that keeps a tile to at most MAX_SPLITS partials (a 1280 x 720 frame's
# relu1_1, N = 921,600: 225 splits of 4,096). It depends on N alone, never
# on the batch, so the summation order is the image's own.
SPLIT = 1024
MAX_SPLITS = 256


def split_columns(n: int) -> int:
    """Columns per split for a map of ``n`` columns."""
    return SPLIT * -(-n // (SPLIT * MAX_SPLITS))


def _centered_gram_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x [B, C, N]`` → ``(gram [B, C, C], mean [B, C])``: f32 mean, a
    centred copy, one product per image (a batched product may block
    its sums by the batch size, and an image's result must not depend
    on the batch)."""
    f32 = x.float()
    mean = reductions.mean0(f32.mT)
    centered = f32 - mean[..., :, None]
    return torch.stack([c @ c.mT for c in centered]), mean


def centered_gram_cuda(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The CUDA kernel on ``x [B, C, N]`` (f32 or bf16, contiguous, on
    the card) → ``(gram [B, C, C], mean [B, C])`` f32. Launches on the
    current stream and does not synchronise; raises on any input the
    kernel does not take, and if a launch fails."""
    name = "centered_gram_cuda"
    if x.dim() != 3 or 0 in x.shape:
        raise ValueError(f"{name} needs a non-empty x [B, C, N], got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} needs float32 or bfloat16, got {x.dtype}")
    if x.device.type != "cuda":
        raise ValueError(f"{name} needs a CUDA tensor, got {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous tensor")
    b, c, n = x.shape
    if b > 65535 or c > 16384 or n >= 2**31 // 2:
        raise ValueError(f"{name} takes at most 65535 images, 16384 channels and 2^30 columns")
    split = split_columns(n)
    ptr, integer = ctypes.c_void_p, ctypes.c_int
    workspace_floats = _build.load("centered_gram").centered_gram_workspace_floats
    workspace_floats.argtypes, workspace_floats.restype = [integer] * 4, ctypes.c_longlong
    mean = torch.empty((b, c), dtype=torch.float32, device=x.device)
    gram = torch.empty((b, c, c), dtype=torch.float32, device=x.device)
    work = torch.empty(workspace_floats(b, c, n, split), dtype=torch.float32, device=x.device)
    _build.launch(name, "centered_gram", "centered_gram_cn",
                  [ptr, integer, ptr, ptr, ptr] + [integer] * 4,
                  (x.data_ptr(), int(x.dtype == torch.bfloat16), mean.data_ptr(),
                   gram.data_ptr(), work.data_ptr(), b, c, n, split), x.device)
    centered_gram_cuda.launches += 1
    return gram, mean


centered_gram_cuda.launches = 0


def centered_gram_cn(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(Σ(x−μ)(x−μ)ᵀ [B, C, C], mean [B, C])`` of channel-major ``x [B, C, N]``,
    in the span ``wct.op.gram``."""
    if x.device.type == "cuda":
        with span("wct.op.gram"):
            return centered_gram_cuda(x)
    if x.device.type != "cpu":
        raise ValueError(f"no centered_gram kernel for device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"centered_gram_cn needs x [B, C, N], got {tuple(x.shape)}")
    with span("wct.op.gram"):
        return _centered_gram_plain(x)


def moments_cn(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(mean [B, C], population variance [B, C])`` of channel-major ``x [B, C, N]``, f32.

    AdaIN's statistics (``wct_tpu/ops/reductions.py::moments0``). On the
    card they are the mean and the diagonal of ``centered_gram_cuda``
    over N: the kernel's sums are compensated, in a fixed order that
    depends on N alone, and it takes bf16 as it lies, so an image's
    moments are the same bits alone and in any batch and a long sum of
    a mostly-zero ReLU map does not drift with its count (PERF.md §6),
    which a reduction of PyTorch's, blocked by the batch shape,
    does not promise. The off-diagonal entries cost little beside it:
    ``chip_smoke.py`` times the route against the plain two-pass at
    relu1_1. A CPU tensor takes the plain two-pass
    ``reductions.moments0``. Both run in the span ``wct.op.gram``.
    """
    if x.dim() != 3:
        raise ValueError(f"moments_cn needs x [B, C, N], got {tuple(x.shape)}")
    if x.device.type == "cuda":
        with span("wct.op.gram"):
            gram, mean = centered_gram_cuda(x.contiguous())
            return mean, gram.diagonal(dim1=-2, dim2=-1) / x.shape[-1]
    if x.device.type != "cpu":
        raise ValueError(f"no centered_gram kernel for device {x.device}")
    with span("wct.op.gram"):
        return reductions.moments0(x.mT)


def centered_gram(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(un-normalised centred Gram [C, C], mean [C])`` of ``x [N, C]``.

    The kernel runs on channel-major maps, so on the card this form
    pays one transposed copy of ``x``; the cascade's features are
    channel-major already and go to ``centered_gram_cn``.
    """
    if x.dim() != 2:
        raise ValueError(f"centered_gram needs x [N, C], got {tuple(x.shape)}")
    gram, mean = centered_gram_cn(x.mT.contiguous()[None])
    return gram[0], mean[0]
