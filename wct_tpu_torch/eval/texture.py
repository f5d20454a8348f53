"""Pixel-space texture statistics — the evaluator-free quality metrics.

A copy of ``wct_tpu/eval/texture.py`` (numpy only), kept in the port so
that it imports nothing of the JAX package. These metrics have no
learned component: they compare a stylized output with the style image
in pixel space, using classical texture descriptors.

Three families, all float64, all deterministic, no tunable weights:

- **radial FFT log-power spectrum** — texture energy per spatial
  frequency band. Brush scale, stroke granularity, and repetition
  period live here; a stylization that transfers texture scale moves
  the output's spectrum toward the style's.
- **color distribution** — per-channel quantile functions (inverse
  CDFs). WCT explicitly matches feature covariance; in pixel space the
  visible effect is the color palette, and the quantile-function L1 is
  the 1-D earth-mover distance, robust to binning.
- **multi-scale local contrast** — distributions of local standard
  deviation at 3/9/27-px box scales. Captures stroke contrast and the
  flat-vs-busy balance that Gram statistics encode implicitly.

Distances are symmetric, zero iff the statistics match, and comparable
across bundles because nothing in them depends on any model weights.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "radial_spectrum",
    "spectrum_distance",
    "color_quantiles",
    "color_distance",
    "local_std",
    "contrast_quantiles",
    "contrast_distance",
    "texture_distances",
    "aggregate_score",
]

_QUANTS = np.linspace(0.005, 0.995, 100)


def _gray(img: np.ndarray) -> np.ndarray:
    """BT.601 luminance of ``[H, W, 3]`` in [0,1] (utils/colors.py)."""
    img = np.asarray(img, np.float64)
    return 0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2]


def radial_spectrum(img: np.ndarray, nbins: int = 24) -> np.ndarray:
    """Radially averaged log10 power spectrum of the luminance.

    Returns ``[nbins]`` log-power in log-spaced frequency bins from
    2/min(H,W) cycles/px up to Nyquist; DC is excluded. The window
    (Hann, separable) suppresses the spectral leakage of the image
    borders so the measured spectrum is the texture's, not the frame's.
    """
    g = _gray(img)
    h, w = g.shape
    win = np.outer(np.hanning(h), np.hanning(w))
    f = np.fft.fftshift(np.fft.fft2((g - g.mean()) * win))
    power = np.abs(f) ** 2
    fy = np.fft.fftshift(np.fft.fftfreq(h))[:, None]
    fx = np.fft.fftshift(np.fft.fftfreq(w))[None, :]
    r = np.sqrt(fy * fy + fx * fx)  # cycles/px in [0, ~0.707]
    lo, hi = 2.0 / min(h, w), 0.5
    edges = np.geomspace(lo, hi, nbins + 1)
    out = np.empty(nbins, np.float64)
    total = power.sum()
    for i in range(nbins):
        m = (r >= edges[i]) & (r < edges[i + 1])
        # normalised by total power: the spectrum SHAPE, not the
        # image's overall contrast (contrast has its own metric below)
        out[i] = np.log10(power[m].sum() / total + 1e-12)
    return out


def spectrum_distance(a: np.ndarray, b: np.ndarray, nbins: int = 24) -> float:
    """Mean |Δ log10 band power| between two images' radial spectra."""
    return float(np.abs(radial_spectrum(a, nbins) - radial_spectrum(b, nbins)).mean())


def color_quantiles(img: np.ndarray) -> np.ndarray:
    """Per-channel quantile function: ``[3, len(_QUANTS)]``."""
    img = np.asarray(img, np.float64)
    return np.stack(
        [np.quantile(img[..., c].ravel(), _QUANTS) for c in range(3)]
    )


def color_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Mean per-channel 1-D earth-mover distance (quantile-function L1).

    In units of the [0,1] pixel range; 0 iff the marginal color
    distributions match.
    """
    return float(np.abs(color_quantiles(a) - color_quantiles(b)).mean())


def local_std(img: np.ndarray, scale: int) -> np.ndarray:
    """Local standard deviation of luminance over ``scale``×``scale`` boxes.

    Non-overlapping boxes (a strided partition): each output value is
    one patch's std, so the returned sample is i.i.d.-ish across the
    image and its DISTRIBUTION is the texture descriptor.
    """
    g = _gray(img)
    h, w = g.shape
    hs, ws = h // scale, w // scale
    if hs == 0 or ws == 0:
        raise ValueError(f"image {g.shape} smaller than scale {scale}")
    p = g[: hs * scale, : ws * scale].reshape(hs, scale, ws, scale)
    return p.std(axis=(1, 3)).ravel()


def contrast_quantiles(img: np.ndarray, scales=(3, 9, 27)) -> np.ndarray:
    """Quantile functions of local std at each scale: ``[S, Q]``."""
    return np.stack(
        [np.quantile(local_std(img, s), _QUANTS) for s in scales]
    )


def contrast_distance(a: np.ndarray, b: np.ndarray, scales=(3, 9, 27)) -> float:
    """Mean EMD between local-contrast distributions across scales."""
    return float(
        np.abs(contrast_quantiles(a, scales) - contrast_quantiles(b, scales)).mean()
    )


def texture_distances(out_img: np.ndarray, style_img: np.ndarray) -> dict:
    """All pixel-space style distances of ``out_img`` vs ``style_img``.

    Returns ``{"spectrum": ..., "color": ..., "contrast": ...}`` plus
    the unweighted aggregate under ``"pixel_agg"``. Images are clipped
    to [0,1] first — the save path clips, so judge what ships.
    """
    o = np.clip(np.asarray(out_img, np.float64), 0.0, 1.0)
    s = np.clip(np.asarray(style_img, np.float64), 0.0, 1.0)
    d = {
        "spectrum": spectrum_distance(o, s),
        "color": color_distance(o, s),
        "contrast": contrast_distance(o, s),
    }
    d["pixel_agg"] = aggregate_score(d)
    return d


def aggregate_score(d: dict) -> float:
    """Single headline number: the unweighted mean of the three
    families after fixed scale normalisation.

    The normalisers are NOT tuned per bundle — they are the rough
    dynamic ranges of each metric between unrelated natural images
    (spectrum |Δlog10| ~ O(1); color and contrast EMD ~ O(0.1) on
    [0,1] pixels), fixed here once so the aggregate is comparable
    across rounds.
    """
    return float(
        np.mean([d["spectrum"] / 1.0, d["color"] / 0.1, d["contrast"] / 0.1])
    )
