"""Port WCT core against ``wct_tpu.ops.wct`` on full-rank features.

Same numpy features through both packages, for ``eigh`` (hard 1e-5
mask) and ``newton_schulz_pallas`` (the JAX Pallas kernel in interpret
mode; the port's plain Newton–Schulz on the CPU). Full rank (N ≫ C)
keeps every eigenvalue far from the mask's threshold, so the
comparison is smooth. Bound 2e-5 relative to each output's largest
|value|; measured ≤ 3.2e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wct_tpu.ops import wct as jwct
from wct_tpu_torch.ops import wct as twct

METHODS = ["eigh", "newton_schulz_pallas", "newton_schulz", "auto"]
BOUND = 2e-5


def _feats(c, seed):
    """Correlated, relu-like content [24, 20, C] and style [18, 16, C]."""
    rng = np.random.default_rng(seed)
    mix = rng.standard_normal((c, c)) / np.sqrt(c)
    fc = np.maximum(rng.standard_normal((24 * 20, c)) @ mix + 0.3, 0) + 0.05
    fs = np.maximum(rng.standard_normal((18 * 16, c)) @ mix * 2 + 0.5, 0) + 0.05
    return (fc.reshape(24, 20, c).astype(np.float32),
            fs.reshape(18, 16, c).astype(np.float32))


def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= BOUND * np.abs(ref).max(), f"max err {err:.3e}, scale {np.abs(ref).max():.3e}"


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("c", [16, 64])
def test_stats_and_transform_match_reference(method, c):
    fc, fs = _feats(c, seed=c)
    j_stats = jwct.style_stats(jnp.asarray(fs), method=method)
    t_stats = twct.style_stats(torch.from_numpy(fs), method=method)
    _close(t_stats.kernel.numpy(), j_stats.kernel)
    _close(t_stats.mean.numpy(), j_stats.mean)
    j_w, j_mu = jwct.whitening_kernel(jnp.asarray(fc), method=method)
    t_w, t_mu = twct.whitening_kernel(torch.from_numpy(fc), method=method)
    _close(t_w.numpy(), j_w)
    _close(t_mu.numpy(), j_mu)
    for alpha in (0.6, 1.0):
        ref = jwct.wct_from_stats(jnp.asarray(fc), j_stats, alpha, method=method)
        got = twct.wct_from_stats(torch.from_numpy(fc), t_stats, alpha, method=method)
        _close(got.numpy(), ref)
    _close(
        twct.wct(torch.from_numpy(fc), torch.from_numpy(fs), 0.8, method=method).numpy(),
        jwct.wct(jnp.asarray(fc), jnp.asarray(fs), 0.8, method=method),
    )


@pytest.mark.parametrize("method", ["eigh", "newton_schulz_pallas"])
def test_whitening_whitens(method):
    """(x − μ) @ W has identity covariance on full-rank features."""
    fc, _ = _feats(32, seed=1)
    w, mu = twct.whitening_kernel(torch.from_numpy(fc), method=method)
    x = torch.from_numpy(fc).reshape(-1, 32) - mu
    white = x @ w
    cov = white.T @ white / (x.shape[0] - 1)
    np.testing.assert_allclose(cov.numpy(), np.eye(32), atol=2e-3)


@pytest.mark.parametrize("method", ["eigh", "newton_schulz_pallas"])
def test_alpha0_is_identity(method):
    fc, fs = _feats(64, seed=2)
    stats = twct.style_stats(torch.from_numpy(fs), method=method)
    out = twct.wct_from_stats(torch.from_numpy(fc), stats, 0.0, method=method)
    np.testing.assert_array_equal(out.numpy(), fc)


def test_gram_matches_reference():
    fc, _ = _feats(48, seed=3)
    flat = fc.reshape(-1, 48)
    j_cov, j_mean = jwct._gram(jnp.asarray(flat))
    t_cov, t_mean = twct._gram(torch.from_numpy(flat))
    _close(t_cov.numpy(), j_cov)
    _close(t_mean.numpy(), j_mean)


ILLEGAL = [
    dict(soft_trunc=True, trunc_topk=4),
    dict(soft_trunc=True, rel_trunc=1e-3),
    dict(trunc_topk=4, groups=2),
    dict(rel_trunc=1.5),
    dict(rel_trunc=0.0),
    dict(method="newton_schulz", trunc_topk=4),
    dict(method="newton_schulz_pallas", rel_trunc=1e-3),
    dict(method="auto", trunc_topk=4),  # C=128 resolves to newton_schulz
    dict(method="qr"),
]


@pytest.mark.parametrize("kw", ILLEGAL, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_same_value_errors_as_reference(kw):
    fc, _ = _feats(128, seed=4)
    with pytest.raises(ValueError) as ref:
        jwct.whitening_kernel(jnp.asarray(fc), **kw)
    with pytest.raises(ValueError) as got:
        twct.whitening_kernel(torch.from_numpy(fc), **kw)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize(
    "kw",
    [dict(soft_trunc=True), dict(trunc_topk=8), dict(rel_trunc=1e-3), dict(groups=2),
     dict(method="newton_schulz_fast")],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()),
)
def test_unported_modes_raise_not_implemented(kw):
    fc, fs = _feats(16, seed=5)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item"):
        twct.style_stats(torch.from_numpy(fs), **kw)
