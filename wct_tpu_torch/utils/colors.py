"""Colour control on the host: luminance-only transfer and CORAL.

A copy of ``wct_tpu/utils/colors.py`` (importing that module would load
JAX through ``wct_tpu``): numpy only, with the ITU-R BT.601 YCbCr
matrices written out so that nothing needs cv2. Both run on the host,
before (CORAL recolours the style) or after (``preserve_colors_np``)
the cascade.
"""

from __future__ import annotations

import numpy as np

# ITU-R BT.601 full-range RGB↔YCbCr.
_RGB2YCC = np.array(
    [
        [0.299, 0.587, 0.114],
        [-0.168736, -0.331264, 0.5],
        [0.5, -0.418688, -0.081312],
    ],
    dtype=np.float64,
)
_YCC2RGB = np.linalg.inv(_RGB2YCC)
_YCC_OFFSET = np.array([0.0, 0.5, 0.5], dtype=np.float64)


def rgb_to_ycc(rgb: np.ndarray) -> np.ndarray:
    """[H, W, 3] RGB in [0, 1] → YCbCr (Y in [0, 1], chroma centred at 0.5)."""
    return rgb.astype(np.float64) @ _RGB2YCC.T + _YCC_OFFSET


def ycc_to_rgb(ycc: np.ndarray) -> np.ndarray:
    return (ycc.astype(np.float64) - _YCC_OFFSET) @ _YCC2RGB.T


def preserve_colors_np(content_rgb: np.ndarray, stylized_rgb: np.ndarray) -> np.ndarray:
    """Luminance-only style transfer (``--keep-colors``): Y from the
    stylized output, CbCr from the content."""
    if content_rgb.shape != stylized_rgb.shape:
        raise ValueError(
            f"shape mismatch {content_rgb.shape} vs {stylized_rgb.shape}"
        )
    ycc_out = rgb_to_ycc(np.clip(stylized_rgb, 0, 1))
    ycc_content = rgb_to_ycc(np.clip(content_rgb, 0, 1))
    ycc_out[..., 1:] = ycc_content[..., 1:]
    return np.clip(ycc_to_rgb(ycc_out), 0.0, 1.0).astype(np.float32)


def coral_numpy(source: np.ndarray, target: np.ndarray, eps: float = 1e-5) -> np.ndarray:
    """CORAL (Sun et al. 2016): give ``source``'s pixel colours the mean and
    covariance of ``target``'s. Whitens the source's colours with the
    Cholesky factor of their covariance and recolours with the target's."""
    src = source.reshape(-1, 3).astype(np.float64)
    tgt = target.reshape(-1, 3).astype(np.float64)

    mu_s, mu_t = src.mean(0), tgt.mean(0)
    cov_s = np.cov(src, rowvar=False) + eps * np.eye(3)
    cov_t = np.cov(tgt, rowvar=False) + eps * np.eye(3)

    chol_s = np.linalg.cholesky(cov_s)
    chol_t = np.linalg.cholesky(cov_t)

    out = (src - mu_s) @ np.linalg.inv(chol_s).T @ chol_t.T + mu_t
    return np.clip(out, 0.0, 1.0).reshape(source.shape).astype(np.float32)
