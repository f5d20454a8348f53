"""Pure-numpy float64 implementation of the pipeline — the executable spec.

The port of ``wct_tpu/tools/oracle.py``: reflect-pad convs, 2×2
maxpool, nearest-neighbour upsample, WCT with eps on the Gram and the
hard 1e-5 truncation, the style-swap, AdaIN, per-level decode and one
final clip, in numpy float64, independent of ``wct_tpu_torch.ops``. It
reads only the port's layer tables (``vgg.ENCODER_LAYERS``,
``decoder.decoder_layers``), runs nothing on a device, and takes
parameters in the JAX package's numpy HWIO layout (``load_pytree`` of a
bundle, or ``train.checkpoint.params_to_numpy`` of the port's), so it
is the same judge the JAX package's tests use, available where JAX is
not (``chip_smoke.py`` on the card).
"""

from __future__ import annotations

import numpy as np

from wct_tpu_torch.models import decoder as dec_lib
from wct_tpu_torch.models import vgg


def conv2d_reflect_np(x: np.ndarray, w: np.ndarray, b: np.ndarray) -> np.ndarray:
    """x [H,W,Cin], w [kh,kw,Cin,Cout] HWIO, reflect pad, valid conv."""
    kh = w.shape[0]
    p = (kh - 1) // 2
    if p:
        x = np.pad(x, ((p, p), (p, p), (0, 0)), mode="reflect")
    h, wd = x.shape[0] - kh + 1, x.shape[1] - kh + 1
    out = np.zeros((h, wd, w.shape[3]), np.float64)
    for di in range(kh):
        for dj in range(kh):
            out += np.tensordot(
                x[di : di + h, dj : dj + wd, :].astype(np.float64),
                w[di, dj].astype(np.float64),
                axes=([2], [0]),
            )
    return out + b.astype(np.float64)


def maxpool2_np(x: np.ndarray) -> np.ndarray:
    h, w, c = x.shape
    return x[: h // 2 * 2, : w // 2 * 2].reshape(h // 2, 2, w // 2, 2, c).max((1, 3))


def upsample2_np(x: np.ndarray) -> np.ndarray:
    return np.repeat(np.repeat(x, 2, axis=0), 2, axis=1)


def encode_np(enc_params: dict, img: np.ndarray, target: str) -> np.ndarray:
    x = img.astype(np.float64)
    for spec in vgg.layers_to(target):
        if spec[0] == "pool":
            x = maxpool2_np(x)
            continue
        _, name, *_ = spec
        p = enc_params[name]
        x = conv2d_reflect_np(x, np.asarray(p["w"]), np.asarray(p["b"]))
        if spec[0] == "conv":
            x = np.maximum(x, 0.0)
    return x


def decode_np(dec_params: dict, f: np.ndarray, target: str) -> np.ndarray:
    layers = dec_lib.decoder_layers(target)
    x = f
    for i, spec in enumerate(layers):
        if spec[0] == "upsample":
            x = upsample2_np(x)
            continue
        _, name, *_ = spec
        p = dec_params[name]
        x = conv2d_reflect_np(x, np.asarray(p["w"]), np.asarray(p["b"]))
        if i != len(layers) - 1:
            x = np.maximum(x, 0.0)
    return x


def _sym_pow_np(
    flat: np.ndarray,
    power: float,
    eps: float = 1e-8,
    trunc: float = 1e-5,
    k: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """(cov^power via eigh with truncation, mean) of ``flat [N, C]``.

    ``k``: top-k index truncation instead of the 1e-5 value threshold —
    the oracle counterpart of ``ops.wct``'s ``trunc_topk``
    (matched-mask gates; mechanism in DESIGN §2b).
    """
    c = flat.shape[-1]
    mu = flat.mean(0)
    centered = flat - mu
    cov = centered.T @ centered / (flat.shape[0] - 1) + eps * np.eye(c)
    s, u = np.linalg.eigh(cov)
    if k is not None:
        keep = np.arange(c) >= c - k
        s_pow = np.where(keep, np.sign(s) * np.abs(s) ** power, 0.0)
    else:
        s_pow = np.where(s > trunc, np.sign(s) * np.abs(s) ** power, 0.0)
    return (u * s_pow) @ u.T, mu


def wct_np(
    fc: np.ndarray,
    fs: np.ndarray,
    alpha: float,
    eps: float = 1e-8,
    trunc: float = 1e-5,
    force_k: tuple[int, int] | None = None,
) -> np.ndarray:
    """WCT per SURVEY §A.2 in float64 (blend vs UNCENTERED content).

    ``force_k=(k_c, k_s)``: top-k index truncation instead of the value
    threshold — the oracle counterpart of ``ops.wct``'s ``trunc_topk``
    (matched-mask gates; mechanism in DESIGN §2b).
    """
    c = fc.shape[-1]
    fc_flat = fc.reshape(-1, c)
    fs_flat = fs.reshape(-1, c)

    kc, ks = force_k if force_k is not None else (None, None)
    w_c, mu_c = _sym_pow_np(fc_flat, -0.5, eps, trunc, kc)
    k_s, mu_s = _sym_pow_np(fs_flat, +0.5, eps, trunc, ks)
    colored = (fc_flat - mu_c) @ w_c @ k_s + mu_s
    return (alpha * colored + (1 - alpha) * fc_flat).reshape(fc.shape)


def wct_ranks_np(
    fc: np.ndarray, fs: np.ndarray, eps: float = 1e-8, trunc: float = 1e-5
) -> tuple[int, int]:
    """Float64 keep-counts (k_c, k_s) under the 1e-5 value threshold —
    the ground-truth ranks the matched-mask gates force into both
    implementations."""

    def rank(flat):
        c = flat.shape[-1]
        mu = flat.mean(0)
        centered = flat - mu
        cov = centered.T @ centered / (flat.shape[0] - 1) + eps * np.eye(c)
        s = np.linalg.eigvalsh(cov)
        return int((s > trunc).sum())

    return rank(fc.reshape(-1, fc.shape[-1])), rank(fs.reshape(-1, fs.shape[-1]))


def extract_patches_np(f: np.ndarray, patch_size: int, stride: int) -> np.ndarray:
    """Patches of ``f [H, W, C]`` → filter bank ``[ps, ps, C, P]``.

    Same row-major patch ordering as ``ops.style_swap.extract_patches``
    so argmax indices are directly comparable across implementations.
    """
    h, w, c = f.shape
    ps = patch_size
    hp = (h - ps) // stride + 1
    wp = (w - ps) // stride + 1
    out = np.zeros((ps, ps, c, hp * wp), np.float64)
    for i in range(hp):
        for j in range(wp):
            out[:, :, :, i * wp + j] = f[
                i * stride : i * stride + ps, j * stride : j * stride + ps, :
            ]
    return out


def style_swap_np(
    fc_white: np.ndarray,
    fs_white: np.ndarray,
    ss_alpha: float = 0.6,
    patch_size: int = 3,
    stride: int = 1,
) -> np.ndarray:
    """Float64 patch swap — the executable spec for ``ops.style_swap``.

    Mirrors reference ``wct_style_swap``'s inner swap (ops.py:~145–230,
    reconstructed; Chen & Schmidt 2016): L2-normalized style patches as
    match filters, hard argmax per content location, overlap-normalized
    reconstruction from the UN-normalized patches, blend by
    ``ss_alpha``. Direct loops — correctness over speed.
    """
    h, w, c = fc_white.shape
    ps = patch_size
    fc64 = fc_white.astype(np.float64)
    filters = extract_patches_np(fs_white.astype(np.float64), ps, stride)
    p = filters.shape[-1]
    norms = np.sqrt((filters**2).sum(axis=(0, 1, 2)))
    filters_n = filters / np.maximum(norms, 1e-8)[None, None, None, :]

    hp = (h - ps) // stride + 1
    wp = (w - ps) // stride + 1
    best = np.zeros((hp, wp), np.int64)
    for i in range(hp):
        for j in range(wp):
            patch = fc64[i * stride : i * stride + ps, j * stride : j * stride + ps]
            best[i, j] = np.tensordot(
                patch, filters_n, axes=([0, 1, 2], [0, 1, 2])
            ).argmax()

    hr, wr = (hp - 1) * stride + ps, (wp - 1) * stride + ps
    recon = np.zeros((hr, wr, c), np.float64)
    counts = np.zeros((hr, wr, 1), np.float64)
    for i in range(hp):
        for j in range(wp):
            sl = np.s_[i * stride : i * stride + ps, j * stride : j * stride + ps]
            recon[sl] += filters[:, :, :, best[i, j]]
            counts[sl] += 1.0
    recon = recon / np.maximum(counts, 1.0)
    if (hr, wr) != (h, w):
        recon = np.pad(recon, ((0, h - hr), (0, w - wr), (0, 0)), mode="edge")
    return ss_alpha * recon + (1.0 - ss_alpha) * fc64


def wct_style_swap_np(
    fc: np.ndarray,
    fs: np.ndarray,
    alpha: float = 1.0,
    ss_alpha: float = 0.6,
    patch_size: int = 3,
    stride: int = 1,
    eps: float = 1e-8,
    trunc: float = 1e-5,
    force_k: tuple[int, int] | None = None,
) -> np.ndarray:
    """Full whiten → patch swap → color → alpha-blend in float64.

    The oracle for ``ops.style_swap.wct_style_swap`` / the cascade's
    swap5 level (reference ops.py:~145, reconstructed). ``force_k``
    matches the matched-mask gate mechanism (DESIGN §2b) for the
    rank-deficient relu5_1 whitening.
    """
    c = fc.shape[-1]
    fc_flat = fc.reshape(-1, c).astype(np.float64)
    fs_flat = fs.reshape(-1, c).astype(np.float64)
    kc, ks = force_k if force_k is not None else (None, None)
    w_c, mu_c = _sym_pow_np(fc_flat, -0.5, eps, trunc, kc)
    w_s, mu_s = _sym_pow_np(fs_flat, -0.5, eps, trunc, ks)
    k_s, _ = _sym_pow_np(fs_flat, +0.5, eps, trunc, ks)
    fc_white = ((fc_flat - mu_c) @ w_c).reshape(fc.shape)
    fs_white = ((fs_flat - mu_s) @ w_s).reshape(fs.shape)
    swapped = style_swap_np(fc_white, fs_white, ss_alpha, patch_size, stride)
    colored = swapped.reshape(-1, c) @ k_s + mu_s
    out = alpha * colored + (1.0 - alpha) * fc_flat
    return out.reshape(fc.shape)


def adain_np(fc: np.ndarray, fs: np.ndarray, alpha: float, eps: float = 1e-5):
    c = fc.shape[-1]
    cf = fc.reshape(-1, c).astype(np.float64)
    sf = fs.reshape(-1, c).astype(np.float64)
    out = (
        np.sqrt(sf.var(0) + eps) * (cf - cf.mean(0)) / np.sqrt(cf.var(0) + eps)
        + sf.mean(0)
    )
    return (alpha * out + (1 - alpha) * cf).reshape(fc.shape)


def cascade_np(
    params: dict,
    content: np.ndarray,
    style: np.ndarray,
    alpha: float,
    targets: tuple[str, ...],
    transform: str = "wct",
    swap5: bool = False,
    ss_alpha: float = 0.6,
    ss_patch_size: int = 3,
    ss_stride: int = 1,
) -> np.ndarray:
    """Full multi-level cascade; ONE clip before save (stylize.py:~150).

    ``swap5``: style-swap at relu5_1 instead of plain WCT — the
    reference's ``--swap5`` composition (stylize.py:~100, ops.py:~145,
    reconstructed).
    """
    img = content.astype(np.float64)
    for t in targets:
        fc = encode_np(params["encoder"], img, t)
        fs = encode_np(params["encoder"], style, t)
        if swap5 and t == "relu5_1":
            f = wct_style_swap_np(
                fc, fs, alpha, ss_alpha, ss_patch_size, ss_stride
            )
        else:
            f = (wct_np if transform == "wct" else adain_np)(fc, fs, alpha)
        img = decode_np(params["decoders"][t], f, t)
    return np.clip(img, 0.0, 1.0)
