"""The port's two-pass centred Gram against ``wct_tpu``'s Pallas kernel.

The same numpy features go through ``gram_pallas.centered_gram`` (interpret
mode on the CPU, as ``tests/test_reductions.py`` runs it) and through the
plain version the port takes for a CPU tensor, at that test's shapes and
with its bounds: ``rtol 2e-4, atol 2e-3`` on the Gram and ``rtol 2e-5,
atol 1e-5`` on the mean, against the Pallas kernel and against numpy in
float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wct_tpu.ops import gram_pallas
from wct_tpu_torch.ops import gram
from wct_tpu_torch.ops import wct as twct

SHAPES = [(132, 512), (1000, 64), (4096, 128), (7, 256)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite runs in
    parallel workers, and torch's OpenMP threads spinning on a loaded
    machine made a 30-step test take 150 s instead of 1."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _features(n, c, seed=0):
    """relu-like features with a mean well away from zero."""
    rng = np.random.default_rng(seed + n)
    return (np.maximum(rng.standard_normal((n, c)), 0) + 0.3).astype(np.float32)


@pytest.mark.parametrize("n,c", SHAPES)
def test_plain_matches_pallas_kernel_and_float64(n, c):
    x = _features(n, c)
    got, mean = gram.centered_gram(torch.from_numpy(x))
    assert got.shape == (c, c) and mean.shape == (c,)
    assert got.dtype == mean.dtype == torch.float32
    ref, ref_mean = gram_pallas.centered_gram(jnp.asarray(x), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(mean.numpy(), np.asarray(ref_mean), rtol=2e-5, atol=1e-5)
    x64 = x.astype(np.float64)
    mu = x64.mean(0)
    np.testing.assert_allclose(got.numpy(), (x64 - mu).T @ (x64 - mu), rtol=2e-4, atol=2e-3)
    np.testing.assert_allclose(mean.numpy(), mu, rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("n,c", SHAPES)
def test_normalised_gram_is_the_wct_covariance(n, c):
    """``gram / (n − 1)`` equals ``ops.wct._gram``'s covariance: rtol 2e-4
    of the largest entry."""
    x = torch.from_numpy(_features(n, c, seed=1))
    got, mean = gram.centered_gram(x)
    cov, cov_mean = twct._gram(x)
    scale = float(cov.abs().max())
    assert float((got / (n - 1) - cov).abs().max()) <= 2e-4 * scale
    np.testing.assert_allclose(mean.numpy(), cov_mean.numpy(), rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("n,c", [(132, 64), (1000, 32)])
def test_batched_form_equals_per_image_form_bitwise(n, c):
    xs = [torch.from_numpy(_features(n, c, seed=s)) for s in range(3)]
    batch = torch.stack([x.mT.contiguous() for x in xs])
    grams, means = gram.centered_gram_cn(batch)
    assert grams.shape == (3, c, c) and means.shape == (3, c)
    for i, x in enumerate(xs):
        g, m = gram.centered_gram(x)
        assert torch.equal(grams[i], g) and torch.equal(means[i], m)
        g1, m1 = gram.centered_gram_cn(batch[i : i + 1])
        assert torch.equal(grams[i], g1[0]) and torch.equal(means[i], m1[0])


@pytest.mark.parametrize("n,c", [(132, 64), (7, 256)])
def test_bf16_input_equals_its_upcast_bitwise(n, c):
    x = torch.from_numpy(_features(n, c, seed=2)).to(torch.bfloat16)
    g16, m16 = gram.centered_gram(x)
    g32, m32 = gram.centered_gram(x.float())
    assert g16.dtype == torch.float32
    assert torch.equal(g16, g32) and torch.equal(m16, m32)


@pytest.mark.parametrize("case", ["rank1", "rank3_to_2d_entry", "rank2_to_cn_entry"])
def test_wrappers_reject_wrong_rank(case):
    x = torch.zeros(4, 8, 16)
    with pytest.raises(ValueError):
        if case == "rank1":
            gram.centered_gram(x[0, 0])
        elif case == "rank3_to_2d_entry":
            gram.centered_gram(x)
        else:
            gram.centered_gram_cn(x[0])


def test_kernel_wrapper_needs_the_card():
    before = gram.centered_gram_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        gram.centered_gram_cuda(torch.zeros(1, 8, 16))
    with pytest.raises(TypeError):
        gram.centered_gram_cuda(torch.zeros(1, 8, 16, dtype=torch.float64))
    assert gram.centered_gram_cuda.launches == before
