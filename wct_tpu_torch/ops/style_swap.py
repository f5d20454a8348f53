"""Style-swap: patch-level nearest-neighbour substitution in whitened space.

Counterpart of ``wct_tpu/ops/style_swap.py`` (Chen & Schmidt 2016, the
reference's ``--swap5`` at relu5_1):

1. whiten content and style features (one shared whitened space),
2. cut the whitened style into patches and L2-normalise them as filters,
3. correlate every content location with every patch (a conv),
4. take the hard argmax over patches,
5. rebuild the chosen un-normalised patches with a transposed conv and
   divide by the number of patches covering each pixel,
6. blend with the whitened content by ``ss_alpha``; the caller colours
   with the style's statistics and α-blends as usual.

The correlation and the transposed conv are stock f32 convs, as the
reference leaves them to XLA outside any Pallas kernel. They run
without TF32 (``utils/device.py::set_fp32_numerics``): TF32 rounding
flips the argmax between near-tied patches. Each goes through
``ops/convs.py::conv_by_shape``, which keeps PyTorch's own conv for a
shape where cuDNN's choice is more than 2× slower (PERF.md §6).
The swap runs image by image, as the reference's ``vmap`` does, so an
image's convs have the same shapes alone and in any batch.

The public functions keep the JAX package's ``[H, W, C]`` layout;
``style_swap_nchw`` is the cascade's batched NCHW form.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from wct_tpu_torch.ops import reductions
from wct_tpu_torch.ops import wct as wct_ops
from wct_tpu_torch.ops.convs import conv_by_shape
from wct_tpu_torch.utils.device import scalar_on, set_fp32_numerics


def _patches_nchw(f: torch.Tensor, patch_size: int, stride: int) -> torch.Tensor:
    """Patches of one map ``f [1, C, H, W]`` → filters ``[P, C, ps, ps]``,
    P = Hp·Wp in row-major order (pure data movement)."""
    ps = patch_size
    cols = F.unfold(f, ps, stride=stride)  # [1, C·ps·ps, P], P row-major
    return cols[0].mT.reshape(-1, f.shape[1], ps, ps)


def extract_patches(f: torch.Tensor, patch_size: int, stride: int) -> torch.Tensor:
    """Patches of ``f [H, W, C]`` → filter bank ``[ps, ps, C, P]``, P = Hp·Wp
    in row-major order, Hp = (H − ps)//stride + 1: the reference's layout."""
    filters = _patches_nchw(f.permute(2, 0, 1)[None], patch_size, stride)
    return filters.permute(2, 3, 1, 0)


def _deconv_nchw(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """Transposed conv ``x [1, P, Hc', Wc']`` × ``w [P, C, ps, ps]`` →
    ``[1, C, (Hc'−1)·stride + ps, (Wc'−1)·stride + ps]``:
    out[c, y·s+i, x·s+j] += x[p, y, x] · w[p, c, i, j]."""
    key = ("conv_transpose2d", tuple(x.shape), tuple(w.shape), stride, x.dtype, x.device)
    conv = lambda: F.conv_transpose2d(x, w, stride=stride)  # noqa: E731
    return conv_by_shape(key, conv) if x.device.type == "cuda" else conv()


def _deconv_patches(one_hot: torch.Tensor, filters: torch.Tensor, stride: int) -> torch.Tensor:
    """Transposed conv of ``one_hot [1, Hc', Wc', P]`` with ``filters
    [ps, ps, C, P]`` → ``[1, H', W', C]``: out[x+di, y+dj, c] +=
    one_hot[x, y, p] · patch_p[di, dj, c] (the reference's layout)."""
    out = _deconv_nchw(one_hot.permute(0, 3, 1, 2), filters.permute(3, 2, 0, 1), stride)
    return out.permute(0, 2, 3, 1)


def _check_sizes(hw: tuple, hw_s: tuple, ps: int) -> None:
    if min(*hw, *hw_s) < ps:
        raise ValueError(
            f"style_swap needs feature maps ≥ patch_size={ps}; got content "
            f"{tuple(hw)}, style {tuple(hw_s)} — use a larger image or "
            f"smaller ss_patch_size"
        )


def _filters(fs_white: torch.Tensor, patch_size: int, stride: int):
    """The whitened style's patches ``[P, C, ps, ps]`` f32, and the same
    normalised to unit L2 norm, the correlation's filters."""
    filters = _patches_nchw(fs_white.float(), patch_size, stride)
    # Patch norms from a sum over the fixed shape [ps²·C, P]: they depend
    # on the style alone, never on the batch (the reference's reason for
    # its fixed-order sum, wct_tpu/ops/style_swap.py:102-108: a flipped
    # ULP can swing the argmax between near-tied patches).
    norms = torch.sqrt(reductions.sum0((filters * filters).reshape(filters.shape[0], -1).mT))
    return filters, filters / norms.clamp_min(1e-8)[:, None, None, None]


def _best_patches(x: torch.Tensor, filters_n: torch.Tensor, stride: int) -> torch.Tensor:
    """The patch each location of one whitened map ``x [1, C, H, W]`` takes:
    the argmax of the correlation, ``[1, Hc', Wc']`` (the first of equal
    maxima, as the reference's)."""
    key = ("conv2d", tuple(x.shape), tuple(filters_n.shape), stride, x.device)
    conv = lambda: F.conv2d(x, filters_n, stride=stride)  # noqa: E731
    corr = conv_by_shape(key, conv) if x.device.type == "cuda" else conv()
    return corr.argmax(1)


def style_swap_nchw(
    fc_white: torch.Tensor, fs_white: torch.Tensor, ss_alpha: torch.Tensor | float = 0.6,
    patch_size: int = 3, stride: int = 1,
) -> torch.Tensor:
    """``style_swap`` on whitened NCHW maps: content ``[B, C, H, W]``, style
    ``[1, C, Hs, Ws]`` → ``[B, C, H, W]`` f32, one image at a time."""
    set_fp32_numerics()
    b, c, h, w = fc_white.shape
    ps = patch_size
    _check_sizes((h, w), fs_white.shape[2:], ps)
    filters, filters_n = _filters(fs_white, ps, stride)
    hc, wc = (h - ps) // stride + 1, (w - ps) // stride + 1
    # How many chosen patches cover each pixel does not depend on which
    # were chosen: a transposed conv of ones (small integers, exact).
    ones = torch.ones((1, 1, hc, wc), device=fc_white.device)
    counts = _deconv_nchw(ones, torch.ones((1, 1, ps, ps), device=fc_white.device), stride)
    ss_alpha = scalar_on(ss_alpha, fc_white.device)
    outs = []
    for x in fc_white.float().split(1):
        best = _best_patches(x, filters_n, stride)
        one_hot = F.one_hot(best, filters.shape[0]).permute(0, 3, 1, 2).float()
        recon = _deconv_nchw(one_hot, filters, stride) / counts.clamp_min(1.0)
        # The patches cover (Hc'−1)·stride + ps rows; edge-pad back to H×W
        # where the stride does not tile the map exactly.
        pad_h, pad_w = h - recon.shape[2], w - recon.shape[3]
        if pad_h or pad_w:
            recon = F.pad(recon, (0, pad_w, 0, pad_h), mode="replicate")
        outs.append(ss_alpha * recon + (1.0 - ss_alpha) * x)
    return torch.cat(outs)


def style_swap(
    fc_white: torch.Tensor, fs_white: torch.Tensor, ss_alpha: torch.Tensor | float = 0.6,
    patch_size: int = 3, stride: int = 1,
) -> torch.Tensor:
    """Swap whitened content patches for their nearest whitened style patches.

    ``fc_white [H, W, C]``, ``fs_white [Hs, Ws, C]`` (already whitened) →
    ``[H, W, C]`` blended by ``ss_alpha`` (the reference's ``--ss-alpha``),
    in ``fc_white``'s type.
    """
    out = style_swap_nchw(
        fc_white.permute(2, 0, 1)[None], fs_white.permute(2, 0, 1)[None],
        ss_alpha, patch_size, stride,
    )
    return out[0].permute(1, 2, 0).to(fc_white.dtype)


def whiten_cn(x: torch.Tensor, kernel: torch.Tensor, mean: torch.Tensor) -> torch.Tensor:
    """``(x − mean) @ kernel`` on channel-major ``x [B, C, N]`` → f32 ``[B, C, N]``."""
    return kernel.float().mT @ (x.float() - mean[..., None])


def wct_style_swap(
    fc: torch.Tensor, fs: torch.Tensor, alpha: torch.Tensor | float = 1.0,
    ss_alpha: torch.Tensor | float = 0.6, patch_size: int = 3, stride: int = 1, *,
    eps: float = wct_ops.DEFAULT_EPS, trunc: float = wct_ops.DEFAULT_TRUNC,
    method: wct_ops.Method = "eigh",
) -> torch.Tensor:
    """WCT with style-swap on raw features ``fc [H, W, C]``, ``fs [Hs, Ws, C]``
    (``wct_tpu/ops/style_swap.py:142``): whiten both, swap, colour with the
    style's statistics, α-blend against the content."""
    h, w, c = fc.shape
    x = wct_ops._cn(fc)
    w_c, mu_c = wct_ops.whitening_kernel_cn(x, eps=eps, trunc=trunc, method=method)
    # One Gram and one decomposition give the style's whitening and
    # coloring kernels.
    s = wct_ops._cn(fs)
    w_s, k_s, mu_s = wct_ops.whiten_color_kernels_cn(s, eps=eps, trunc=trunc, method=method)
    fc_white = whiten_cn(x, w_c, mu_c).reshape(1, c, h, w)
    fs_white = whiten_cn(s, w_s, mu_s).reshape(1, c, *fs.shape[:2])
    swapped = style_swap_nchw(fc_white, fs_white, ss_alpha, patch_size, stride)
    colored = k_s.mT @ swapped.reshape(1, c, h * w) + mu_s[..., None]
    alpha = scalar_on(alpha, fc.device)
    out = alpha * colored + (1.0 - alpha) * x.float()
    return out[0].mT.reshape(h, w, c).to(fc.dtype)
