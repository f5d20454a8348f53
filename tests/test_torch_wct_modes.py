"""The port's truncation modes and grouped WCT against ``wct_tpu``.

The same numpy features through both packages; the JAX side uses
``eigh`` or its plain ``newton_schulz``, never interpret-mode Pallas
(the port's plain Newton–Schulz is the CUDA kernel's twin either way).
Statistics are held to 1e-5 of each output's largest |value| under
``eigh`` and 5e-5 under Newton–Schulz (measured ≤ 2.7e-6 under both; the
affine's bias, a difference of two near-equal terms, ≤ 1.0e-5 against
2e-5);
``rel_trunc=1e-3`` keep masks are held identical to JAX's and to a
float64 evaluation's on a rank-deficient Gram. The cascade's levels
with each mode run on the trained bundle at 128 px, teacher-forced, at
tests/test_torch_cascade.py's per-level bounds (q99 ≤ 1e-4, max ≤ 1e-3).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wct_tpu.models import cascade as jcascade
from wct_tpu.ops import wct as jwct
from wct_tpu.tools import oracle
from wct_tpu.train import checkpoint as jck
from wct_tpu_torch.models import cascade as tcascade
from wct_tpu_torch.ops import wct as twct
from wct_tpu_torch.train import checkpoint as tck

BOUND = {"eigh": 1e-5, "newton_schulz": 5e-5}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite runs in
    parallel workers, and torch's OpenMP threads spinning on a loaded
    machine made a 30-step test take 150 s instead of 1."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _feats(c, seed, n_c=24 * 20, n_s=18 * 16):
    """Correlated, relu-like content ``[n_c, C]`` and style ``[n_s, C]`` as maps."""
    rng = np.random.default_rng(seed)
    mix = rng.standard_normal((c, c)) / np.sqrt(c)
    fc = np.maximum(rng.standard_normal((n_c, c)) @ mix + 0.3, 0) + 0.05
    fs = np.maximum(rng.standard_normal((n_s, c)) @ mix * 2 + 0.5, 0) + 0.05
    return (fc.reshape(n_c // 4, 4, c).astype(np.float32),
            fs.reshape(n_s // 4, 4, c).astype(np.float32))


def _close(got, ref, bound):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= bound * np.abs(ref).max(), f"max err {err:.3e}, scale {np.abs(ref).max():.3e}"


MODES = [
    ("eigh", dict(soft_trunc=True)), ("eigh", dict(trunc_topk=12)),
    ("eigh", dict(rel_trunc=1e-3)), ("eigh", dict(groups=4)), ("eigh", dict(groups=8)),
    ("eigh", dict(groups=4, rel_trunc=1e-3)), ("newton_schulz", dict(groups=4)),
    ("auto", dict(groups=2)),
]


@pytest.mark.parametrize("method,kw", MODES, ids=lambda v: v if isinstance(v, str) else
                         "-".join(f"{k}={x}" for k, x in v.items()))
def test_stats_and_transform_match_reference(method, kw):
    """Style stats, whitening kernel, the applied WCT and its dense affine."""
    fc, fs = _feats(32, seed=len(kw) + kw.get("groups", 1))
    bound = BOUND["eigh" if method in ("eigh", "auto") else "newton_schulz"]
    j_stats = jwct.style_stats(jnp.asarray(fs), method=method, **kw)
    t_stats = twct.style_stats(torch.from_numpy(fs), method=method, **kw)
    _close(t_stats.kernel.numpy(), j_stats.kernel, bound)
    _close(t_stats.mean.numpy(), j_stats.mean, bound)
    j_w, j_mu = jwct.whitening_kernel(jnp.asarray(fc), method=method, **kw)
    t_w, t_mu = twct.whitening_kernel(torch.from_numpy(fc), method=method, **kw)
    _close(t_w.numpy(), j_w, bound)
    _close(t_mu.numpy(), j_mu, bound)
    apply_kw = {k: v for k, v in kw.items() if k != "trunc_topk"}
    ref = jwct.wct_from_stats(jnp.asarray(fc), j_stats, 0.7, method=method, **apply_kw)
    got = twct.wct_from_stats(torch.from_numpy(fc), t_stats, 0.7, method=method, **apply_kw)
    _close(got.numpy(), ref, bound)
    j_m, j_b = jwct.wct_transform(jnp.asarray(fc), j_stats, 0.7, method=method, **apply_kw)
    t_m, t_b = twct.wct_transform(torch.from_numpy(fc), t_stats, 0.7, method=method, **apply_kw)
    _close(t_m.numpy(), j_m, bound)
    _close(t_b.numpy(), j_b, 2e-5)  # a difference of two near-equal terms
    # The dense affine computes what the block-by-block apply does.
    applied = torch.from_numpy(fc).reshape(-1, 32) @ t_m + t_b
    _close(applied.reshape(fc.shape).numpy(), got.numpy(), 1e-5)


@pytest.mark.parametrize("kw", [dict(soft_trunc=True), dict(trunc_topk=40), dict(rel_trunc=1e-3)],
                         ids=["soft", "topk40", "rel1e-3"])
def test_modes_on_a_rank_deficient_gram(kw):
    """28 samples of 64 channels: rank ≤ 27, and the null space's eigenvalues
    are f32 noise, different in every solver (DESIGN.md §2b). ``rel`` cuts
    above that noise, so the kernels agree tightly (measured 1.8e-6). The
    soft filter and a top-k past the rank let noise modes in (measured 44 %
    and 81 % apart from JAX's), so they are held to the reference's
    guarantee instead: finite, with every power floored at ``trunc·1e-3``,
    so no entry beyond C·(trunc·1e-3)^{-1/2}."""
    fc, _ = _feats(64, seed=11, n_c=28, n_s=28)
    ref = jwct.whitening_kernel(jnp.asarray(fc), **kw)[0]
    got = twct.whitening_kernel(torch.from_numpy(fc), **kw)[0].numpy()
    assert np.isfinite(got).all()
    if "rel_trunc" in kw:
        _close(got, ref, 1e-5)
    else:
        assert np.abs(got).max() <= 64 * (twct.DEFAULT_TRUNC * 1e-3) ** -0.5


def _rank_deficient_cov(seed):
    """A Gram of 40 samples of 96 relu-like channels, f32 and float64."""
    rng = np.random.default_rng(seed)
    mix = rng.standard_normal((96, 96)) / np.sqrt(96)
    f = (np.maximum(rng.standard_normal((40, 96)) @ mix + 0.2, 0)).astype(np.float32)
    cov32, _ = twct._gram(torch.from_numpy(f))
    f64 = f.astype(np.float64)
    c64 = f64 - f64.mean(0)
    return (cov32 + twct.DEFAULT_EPS * torch.eye(96)), c64.T @ c64 / 39 + twct.DEFAULT_EPS * np.eye(96)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rel_trunc_keep_mask_equals_jax_and_float64(seed):
    """``rel_trunc=1e-3`` keeps the same modes as JAX's f32 ``eigh`` and as a
    float64 ``eigh`` (``wct_tpu/ops/wct.py:137-147``): the cut lies in a
    steep part of the spectrum, far from the f32 noise of the null space."""
    cov32, cov64 = _rank_deficient_cov(seed)
    s = torch.linalg.eigh(cov32)[0]
    got = twct.keep_mask(s, twct.DEFAULT_TRUNC, rel=1e-3).numpy()
    s_j = np.asarray(jnp.linalg.eigh(jnp.asarray(cov32.numpy()))[0])
    s64 = np.linalg.eigvalsh(cov64)
    np.testing.assert_array_equal(got, s_j > 1e-3 * s_j[-1])
    np.testing.assert_array_equal(got, s64 > 1e-3 * s64[-1])
    assert 0 < got.sum() < 40  # the mask cuts inside the spectrum


def test_whiten_color_kernels_match_reference():
    fc, fs = _feats(48, seed=7)
    for method, kw in (("eigh", {}), ("eigh", dict(soft_trunc=True)),
                       ("eigh", dict(rel_trunc=1e-3)), ("eigh", dict(trunc_topk=20)),
                       ("newton_schulz", {}), ("newton_schulz_pallas", {})):
        bound = BOUND["eigh" if method == "eigh" else "newton_schulz"]
        ref = jwct.whiten_color_kernels(jnp.asarray(fs), method=method, **kw)
        got = twct.whiten_color_kernels(torch.from_numpy(fs), method=method, **kw)
        for g, r in zip(got, ref):
            _close(g.numpy(), r, bound)
    # One decomposition gives what the two separate calls give.
    w, k, mu = twct.whiten_color_kernels(torch.from_numpy(fs))
    _close(w.numpy(), twct.whitening_kernel(torch.from_numpy(fs))[0].numpy(), 1e-6)
    _close(k.numpy(), twct.style_stats(torch.from_numpy(fs)).kernel.numpy(), 1e-6)
    with pytest.raises(ValueError) as ref_err:
        jwct.whiten_color_kernels(jnp.asarray(fs), method="newton_schulz", rel_trunc=1e-3)
    with pytest.raises(ValueError) as got_err:
        twct.whiten_color_kernels(torch.from_numpy(fs), method="newton_schulz", rel_trunc=1e-3)
    assert str(got_err.value) == str(ref_err.value)


def test_grouped_gram_is_the_per_group_covariance():
    fc, _ = _feats(32, seed=8)
    flat = fc.reshape(-1, 32)
    j_cov, j_mean = jwct._grouped_gram(jnp.asarray(flat), 4)
    t_cov, t_mean = twct._grouped_gram(torch.from_numpy(flat), 4)
    _close(t_cov.numpy(), j_cov, 1e-5)  # measured 1.2e-6: f32 sums in another order
    _close(t_mean.numpy(), j_mean, 1e-5)
    with pytest.raises(ValueError, match="not divisible by groups 3"):
        twct._grouped_gram(torch.from_numpy(flat), 3)


def test_apply_kernel_block_diagonal_in_f32_and_bf16():
    """G blocks applied as one batched product equal the dense block-diagonal
    matrix; bf16 features keep bf16 operands with f32 sums."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 50, 32)).astype(np.float32))
    blocks = torch.from_numpy(rng.standard_normal((2, 4, 8, 8)).astype(np.float32))
    dense = torch.stack([torch.block_diag(*b) for b in blocks])
    torch.testing.assert_close(twct._apply_kernel(x, blocks), x @ dense, rtol=1e-6, atol=1e-5)
    x16 = x.to(torch.bfloat16)
    got = twct._apply_kernel(x16, blocks)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, x16.float() @ dense.to(torch.bfloat16).float(),
                               rtol=1e-6, atol=1e-5)


def test_grouped_stats_must_match_content_groups():
    fc, fs = _feats(32, seed=9)
    j_stats = jwct.style_stats(jnp.asarray(fs), groups=2)
    t_stats = twct.style_stats(torch.from_numpy(fs), groups=2)
    with pytest.raises(ValueError) as ref:
        jwct.wct_transform(jnp.asarray(fc), j_stats, 0.5)
    with pytest.raises(ValueError) as got:
        twct.wct_transform(torch.from_numpy(fc), t_stats, 0.5)
    assert str(got.value) == str(ref.value)
    with pytest.raises(ValueError) as got:
        twct.wct_from_stats(torch.from_numpy(fc), t_stats, 0.5)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("groups", [1, 4])
def test_interpolate_stats_matches_reference(groups):
    fc, fs = _feats(32, seed=10)
    maps = [fs, fc[: fs.shape[0]], fs * 0.5 + 0.1]
    w = [0.2, 0.5, 0.3]
    ref = jwct.interpolate_stats([jwct.style_stats(jnp.asarray(m), groups=groups) for m in maps],
                                 jnp.asarray(w, jnp.float32))
    got = twct.interpolate_stats([twct.style_stats(torch.from_numpy(m), groups=groups)
                                  for m in maps], torch.tensor(w))
    _close(got.kernel.numpy(), ref.kernel, 1e-5)
    _close(got.mean.numpy(), ref.mean, 1e-5)


def test_wct_with_topk_pairs_and_batched_match_reference():
    fc, fs = _feats(32, seed=12)
    ref = jwct.wct(jnp.asarray(fc), jnp.asarray(fs), 0.8, trunc_topk=(20, 24))
    got = twct.wct(torch.from_numpy(fc), torch.from_numpy(fs), 0.8, trunc_topk=(20, 24))
    _close(got.numpy(), ref, 1e-5)
    fcb = np.stack([fc, fc * 1.2 + 0.1])
    fsb = np.stack([fs[: fc.shape[0] // 2], fs[1 : fc.shape[0] // 2 + 1]])
    alpha = np.array([0.4, 1.0], np.float32)
    for method in ("eigh", "newton_schulz"):
        ref = jwct.wct_batched(jnp.asarray(fcb), jnp.asarray(fsb), jnp.asarray(alpha), method=method)
        got = twct.wct_batched(torch.from_numpy(fcb), torch.from_numpy(fsb),
                               torch.from_numpy(alpha), method=method)
        _close(got.numpy(), ref, BOUND["eigh" if method == "eigh" else "newton_schulz"])
        alone = twct.wct_batched(torch.from_numpy(fcb[1:]), torch.from_numpy(fsb[1:]),
                                 torch.from_numpy(alpha[1:]), method=method)
        assert torch.equal(alone[0], got[1])


BUNDLE = Path(__file__).resolve().parent.parent / "weights" / "bundle.npz"
SIZE = 128
LEVEL_Q99, LEVEL_MAX = 1e-4, 1e-3
CASCADE_Q99, CASCADE_MAX = 5e-3, 3e-2


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(9)
    content = rng.random((SIZE, SIZE, 3)).astype(np.float32)
    style = rng.random((SIZE, SIZE, 3)).astype(np.float32)
    return (jck.load_pytree(BUNDLE), tck.params_from_numpy(tck.load_pytree(BUNDLE), "cpu"),
            content, style)


def _run(setup, level, kw, alpha=0.6):
    """One level on the content, both packages; the port's kernel method
    stands for the reference's plain Newton–Schulz."""
    jparams, tparams, content, style = setup
    jkw = {**kw, "method": "newton_schulz"} if kw.get("method") == "newton_schulz_pallas" else kw
    ref = np.asarray(jcascade.stylize_pair(
        jparams, jnp.asarray(content), jnp.asarray(style), alpha,
        jcascade.CascadeConfig(relu_targets=(level,), **jkw)), np.float64)
    got = tcascade.stylize_pair(tparams, content, style, alpha,
                                tcascade.CascadeConfig(relu_targets=(level,), **kw)).numpy()
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    return got.astype(np.float64), ref


def _diff(a, b):
    d = np.abs(a - b)
    return np.quantile(d, 0.99), d.max()


ALL = ("relu5_1", "relu4_1", "relu3_1", "relu2_1", "relu1_1")
GROUPS4 = dict(wct_groups=4, method="newton_schulz_pallas")
GROUPS8 = dict(wct_groups=8)
SOFT = dict(soft_trunc=True)
REL = dict(rel_trunc=1e-3)
# Measured port-vs-JAX q99 / max: 4 groups 2.4e-7–7.5e-7 / 4.8e-7–1.8e-6;
# 8 groups (eigh, C/G = 32 and 8) 2.7e-6 and 6.0e-7 / 3.1e-5 and 1.3e-6;
# soft 3.6e-7–2.7e-6 / 7.5e-7–1.2e-5; rel 3.6e-7–1.1e-5 / 6.6e-7–3.9e-5.
LEVEL_CASES = (
    [(GROUPS4, lv) for lv in ALL] + [(GROUPS8, lv) for lv in ("relu3_1", "relu1_1")]
    + [(SOFT, lv) for lv in ALL if lv != "relu2_1"] + [(REL, lv) for lv in ALL]
)


@pytest.mark.parametrize("kw,level", LEVEL_CASES, ids=lambda v: v if isinstance(v, str) else
                         "-".join(f"{k}={x}" for k, x in v.items()))
def test_cascade_level_matches_reference(setup, kw, level):
    q99, dmax = _diff(*_run(setup, level, kw))
    assert q99 <= LEVEL_Q99, q99
    assert dmax <= LEVEL_MAX, dmax


def _soft_level_float64(setup, level, alpha=0.6, trunc=1e-5, eps=1e-8):
    """One soft-truncated WCT level in float64 (oracle's encoder, decoder)."""
    jparams, _, content, style = setup

    def soft_pow(flat, power):
        mu = flat.mean(0)
        x = flat - mu
        cov = x.T @ x / (flat.shape[0] - 1) + eps * np.eye(flat.shape[1])
        s, u = np.linalg.eigh(cov)
        s_pos = np.maximum(s, 0.0)
        filt = s_pos**2 / (s_pos**2 + trunc**2)
        return (u * (filt * np.maximum(s_pos, trunc * 1e-3) ** power)) @ u.T, mu

    enc = jparams["encoder"]
    fc = oracle.encode_np(enc, content.astype(np.float64), level)
    fs = oracle.encode_np(enc, style.astype(np.float64), level)
    c = fc.shape[-1]
    w_c, mu_c = soft_pow(fc.reshape(-1, c), -0.5)
    k_s, mu_s = soft_pow(fs.reshape(-1, c), 0.5)
    flat = fc.reshape(-1, c)
    f = alpha * ((flat - mu_c) @ w_c @ k_s + mu_s) + (1 - alpha) * flat
    return np.clip(oracle.decode_np(jparams["decoders"][level], f.reshape(fc.shape), level), 0, 1)


def test_soft_trunc_relu2_1_decided_by_float64(setup):
    """At 128 px relu2_1's spectrum has eigenvalues at the 1e-5 threshold,
    where s^{-1/2} ≈ 316 amplifies f32 noise: the default hard mask's port
    and reference differ there by q99 1.5e-4, max 1.7e-3 too, and the
    soft filter is as sensitive (DESIGN.md §2b). The float64 oracle
    decides: the port is no further from it than the reference (measured
    q99 2.7e-4 against 3.2e-4, max 1.1e-3 against 1.9e-3), and the two
    are within the composed bounds of each other (q99 1.5e-4, max 1.7e-3)."""
    got, ref = _run(setup, "relu2_1", SOFT)
    q99, dmax = _diff(got, ref)
    assert q99 <= CASCADE_Q99 and dmax <= CASCADE_MAX, (q99, dmax)
    f64 = _soft_level_float64(setup, "relu2_1")
    port_q99, port_max = _diff(got, f64)
    ref_q99, ref_max = _diff(ref, f64)
    assert port_q99 <= ref_q99 and port_max <= ref_max, (port_q99, ref_q99, port_max, ref_max)
