"""Frozen never-trained random evaluator encoder for Gram scoring.

Counterpart of ``wct_tpu/eval/frozen.py``: a CReLU-paired
semi-orthogonal encoder of the VGG trunk's shape (``vgg.ENCODER_LAYERS``),
generated from a pinned seed and never trained, so no bundle under
evaluation is favoured by construction. Each conv's ±-paired orthonormal
patch directions make ReLU lossless (relu(x) − relu(−x) = x), so the
features of the 16-conv random trunk stay non-degenerate to relu5_1.

The weights are built in numpy exactly as the JAX package builds them
(``numpy.random.default_rng(SEED)``, a QR canonicalised to diag(R) > 0),
in its HWIO layout: ``fingerprint`` hashes those bytes and must equal
``FINGERPRINT``, the value the JAX package pins. ``evaluator_params``
hands them to the port's encoder as OIHW tensors on a device.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np
import torch

from wct_tpu_torch.models import vgg
from wct_tpu_torch.train import checkpoint
from wct_tpu_torch.utils.device import resolve_device

SEED = 20260819  # pinned; changing it invalidates every recorded distance

# Pinned by the JAX package (``wct_tpu/eval/frozen.py``).
FINGERPRINT = "96f81337d03c18bb3ccd92782c32e7297e1655e3ea584c8901f33826b43562fb"

_TARGETS = ("relu1_1", "relu2_1", "relu3_1", "relu4_1", "relu5_1")


def _semi_orth(rng: np.random.Generator, d_in: int, d_out: int) -> np.ndarray:
    """[d_in, d_out] with orthonormal columns, canonicalised (unique Q)."""
    a = rng.standard_normal((max(d_in, d_out), min(d_in, d_out)))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diag(r))[None, :]  # diag(R) > 0 → Q unique
    return (q if d_in >= d_out else q.T).astype(np.float32)


@functools.lru_cache(maxsize=1)
def evaluator_numpy() -> dict:
    """The frozen evaluator's weights as numpy, HWIO (cached; a few
    seconds to generate): the canonical conv0 preprocessing and
    CReLU-paired semi-orthogonal 3×3 convs, all biases zero."""
    rng = np.random.default_rng(SEED)
    params: dict = {}
    for spec in vgg.ENCODER_LAYERS:
        if spec[0] == "pool":
            continue
        _, name, in_c, out_c, k = spec
        if name == "conv0":
            w = np.zeros((1, 1, 3, 3), np.float32)
            for o, i in enumerate((2, 1, 0)):
                w[0, 0, i, o] = 255.0
            b = -np.array([103.939, 116.779, 123.68], np.float32)
        else:
            u = _semi_orth(rng, k * k * in_c, out_c // 2)
            w = np.concatenate([u, -u], axis=1).reshape(k, k, in_c, out_c)
            b = np.zeros((out_c,), np.float32)
        params[name] = {"w": w, "b": b}
    return params


@functools.lru_cache(maxsize=4)
def evaluator_params(device: str | torch.device = "cuda") -> dict:
    """The frozen evaluator as the port's encoder parameters (OIHW
    tensors) on ``device``."""
    return checkpoint.params_from_numpy(evaluator_numpy(), device)


def fingerprint() -> str:
    """SHA-256 over every weight tensor's HWIO bytes, layer-name order."""
    h = hashlib.sha256()
    params = evaluator_numpy()
    for name in sorted(params):
        for k in sorted(params[name]):
            h.update(np.ascontiguousarray(params[name][k]).tobytes())
    return h.hexdigest()


@torch.no_grad()
def gram_stats(
    img: np.ndarray, targets: tuple[str, ...] = _TARGETS, device: str | torch.device = "cuda"
) -> dict:
    """Per-level Gram ``fᵀf/N``, channel mean and (population) std of
    ``img [H, W, 3]`` under the frozen evaluator: f32 on ``device``,
    float64 numpy out."""
    dev = resolve_device(device)  # also sets the f32 numerics (no TF32)
    x = torch.as_tensor(np.asarray(img), dtype=torch.float32, device=dev)
    feats = vgg.encode_multi_nchw(evaluator_params(dev), x.permute(2, 0, 1)[None], targets)
    out = {}
    for t in targets:
        f = feats[t][0].flatten(1)  # [C, N]
        stats = {"gram": f @ f.T / f.shape[1], "mean": f.mean(1),
                 "std": f.std(1, unbiased=False)}
        out[t] = {k: v.double().cpu().numpy() for k, v in stats.items()}
    return out


def _rel(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def gram_distance(
    out_img: np.ndarray, style_stats: dict, targets: tuple[str, ...] = _TARGETS,
    device: str | torch.device = "cuda",
) -> dict:
    """Relative Gram and mean/std distances of ``out_img`` against
    precomputed ``gram_stats(style)`` under the frozen evaluator."""
    o = gram_stats(np.clip(out_img, 0.0, 1.0), targets, device)
    gram = {t: _rel(o[t]["gram"], style_stats[t]["gram"]) for t in targets}
    meanstd = {
        t: 0.5 * (_rel(o[t]["mean"], style_stats[t]["mean"])
                  + _rel(o[t]["std"], style_stats[t]["std"]))
        for t in targets
    }
    return {
        "frozen_gram_rel": float(np.mean(list(gram.values()))),
        "frozen_gram_rel_per_level": gram,
        "frozen_meanstd_rel": float(np.mean(list(meanstd.values()))),
    }
