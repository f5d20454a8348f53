"""The port's AdaIN and ``moments0`` against ``wct_tpu.ops.adain``.

The same numpy features through both packages. AdaIN is held to 1e-5
of each output's largest |value| (measured ≤ 7.4e-7); the moments the
card reads off the centred Gram are checked on the CPU against the
two-pass they replace.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wct_tpu.ops import adain as jadain
from wct_tpu.ops import reductions as jred
from wct_tpu_torch.ops import adain as tadain
from wct_tpu_torch.ops import gram, reductions

BOUND = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite runs in
    parallel workers, and torch's OpenMP threads spinning on a loaded
    machine made a 30-step test take 150 s instead of 1."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _feat(rng, h=12, w=10, c=8, scale=1.0, shift=0.0, relu=False):
    f = rng.standard_normal((h, w, c)) * scale + shift
    return (np.maximum(f, 0) if relu else f).astype(np.float32)


def _close(got, ref, bound=BOUND):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= bound * np.abs(ref).max(), f"max err {err:.3e}, scale {np.abs(ref).max():.3e}"


@pytest.mark.parametrize("shift", [0.0, 30.0], ids=["centred", "large_mean"])
def test_moments0_matches_reference(shift):
    """Two-pass: a large mean does not cancel the variance."""
    x = _feat(np.random.default_rng(1), 40, 30, 16, 2.0, shift).reshape(-1, 16)
    j_mu, j_var = jred.moments0(jnp.asarray(x))
    t_mu, t_var = reductions.moments0(torch.from_numpy(x))
    _close(t_mu.numpy(), j_mu)
    _close(t_var.numpy(), j_var)
    batched = reductions.moments0(torch.from_numpy(np.stack([x, 2 * x])))
    assert torch.equal(batched[1][0], t_var)


def test_moments_cn_is_the_two_pass_and_the_gram_diagonal():
    """On the CPU ``moments_cn`` is the plain two-pass; on the card it is the
    centred Gram's mean and diagonal over N, which this holds equal on the
    CPU twin of the kernel."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(np.maximum(rng.standard_normal((3, 16, 500)), 0).astype(np.float32))
    mean, var = gram.moments_cn(x)
    ref_mean, ref_var = reductions.moments0(x.mT)
    assert torch.equal(mean, ref_mean) and torch.equal(var, ref_var)
    g, g_mean = gram._centered_gram_plain(x)
    # f32 sums of 500 terms in another order: measured 1.7e-6.
    torch.testing.assert_close(g.diagonal(dim1=-2, dim2=-1) / 500, var, rtol=1e-5, atol=0)
    torch.testing.assert_close(g_mean, mean, rtol=1e-5, atol=0)
    alone = gram.moments_cn(x[2:])
    assert torch.equal(alone[1][0], var[2])


@pytest.mark.parametrize("alpha", [1.0, 0.6, 0.0])
def test_adain_matches_reference(alpha):
    rng = np.random.default_rng(3)
    fc = _feat(rng, scale=3.0, shift=-2.0, relu=True)
    fs = _feat(rng, h=9, w=7, scale=0.5, shift=4.0)
    ref = jadain.adain(jnp.asarray(fc), jnp.asarray(fs), alpha)
    got = tadain.adain(torch.from_numpy(fc), torch.from_numpy(fs), alpha)
    _close(got.numpy(), ref)
    if alpha == 0.0:
        np.testing.assert_allclose(got.numpy(), fc, atol=1e-5)


def test_stats_transform_and_cached_path_match_reference():
    rng = np.random.default_rng(4)
    fc, fs = _feat(rng, relu=True, shift=0.5), _feat(rng, h=9, w=7, shift=1.0)
    j_st = jadain.adain_stats(jnp.asarray(fs))
    t_st = tadain.adain_stats(torch.from_numpy(fs))
    _close(t_st.mean.numpy(), j_st.mean)
    _close(t_st.std.numpy(), j_st.std)
    j_scale, j_bias = jadain.adain_transform(jnp.asarray(fc), j_st, 0.7)
    t_scale, t_bias = tadain.adain_transform(torch.from_numpy(fc), t_st, 0.7)
    _close(t_scale.numpy(), j_scale)
    _close(t_bias.numpy(), j_bias)
    # The diagonal affine is the transform it folds.
    direct = tadain.adain_from_stats(torch.from_numpy(fc), t_st, 0.7)
    _close((torch.from_numpy(fc) * t_scale + t_bias).numpy(), direct.numpy())
    a = tadain.adain_from_stats(torch.from_numpy(fc), t_st, 0.6)
    b = tadain.adain(torch.from_numpy(fc), torch.from_numpy(fs), 0.6)
    assert torch.equal(a, b)


def test_output_has_the_style_moments():
    rng = np.random.default_rng(5)
    fc = _feat(rng, 16, 16, 8, 3.0, -2.0)
    fs = _feat(rng, 9, 7, 8, 0.5, 4.0)
    out = tadain.adain(torch.from_numpy(fc), torch.from_numpy(fs), 1.0).numpy()
    np.testing.assert_allclose(out.mean((0, 1)), fs.mean((0, 1)), atol=1e-4)
    np.testing.assert_allclose(out.std((0, 1)), np.sqrt(fs.var((0, 1)) + 1e-5), rtol=1e-4)


def test_bf16_in_bf16_out_with_f32_arithmetic():
    """bf16 features: f32 moments and arithmetic, the result rounded once."""
    rng = np.random.default_rng(6)
    fc = torch.from_numpy(_feat(rng, relu=True)).to(torch.bfloat16)
    fs = torch.from_numpy(_feat(rng, h=9, w=7))
    st = tadain.adain_stats(fs)
    got = tadain.adain_from_stats(fc, st, 0.8)
    assert got.dtype == torch.bfloat16
    ref = tadain.adain_from_stats(fc.float(), st, 0.8).to(torch.bfloat16)
    assert torch.equal(got, ref)
    j = jadain.adain_from_stats(jnp.asarray(fc.float().numpy()).astype(jnp.bfloat16),
                                jadain.adain_stats(jnp.asarray(fs.numpy())), 0.8)
    assert j.dtype == jnp.bfloat16
    d = np.abs(got.float().numpy() - np.asarray(j.astype(jnp.float32)))
    assert (d <= 2.0**-7 * np.abs(np.asarray(j.astype(jnp.float32))) + 1e-6).all()
