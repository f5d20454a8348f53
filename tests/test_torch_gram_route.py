"""The cascade's covariance ``ops.wct._gram_cn`` goes through the centred Gram.

``_gram_cn`` is ``gram.centered_gram_cn``'s Gram over N − 1, with its
mean, for f32 and bf16 features alike (the hand-written kernel on the
card, its plain version here). At the size of the relu1_1 level at 512 px
(N = 262,144 columns of a ReLU map that is mostly zeros) the port and
``wct_tpu``'s jitted ``_gram`` both stay within 1e-5 relative Frobenius
of a float64 covariance, and of each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wct_tpu.ops import wct as jwct
from wct_tpu_torch.ops import gram
from wct_tpu_torch.ops import wct as twct


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite runs in
    parallel workers, and torch's OpenMP threads spinning on a loaded
    machine made a 30-step test take 150 s instead of 1."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _relu_map(n, c, seed, zeros=0.77):
    """``[N, C]`` f32 ReLU features, ``zeros`` of them exactly 0."""
    rng = np.random.default_rng(seed)
    shift = {0.5: 0.0, 0.77: 0.7388}[zeros]  # Φ(0.7388) ≈ 0.77
    return np.maximum(rng.standard_normal((n, c)) - shift, 0).astype(np.float32)


def _rel_fro(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _cov64(x):
    x64 = np.asarray(x, np.float64)
    c = x64 - x64.mean(0)
    return c.T @ c / (x64.shape[0] - 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b,c,n", [(1, 64, 1000), (3, 32, 4097), (2, 128, 132)])
def test_gram_cn_is_the_centred_gram_over_n_minus_1(b, c, n, dtype):
    x = torch.from_numpy(
        np.ascontiguousarray(np.stack([_relu_map(n, c, seed=s).T for s in range(b)]))).to(dtype)
    cov, mean = twct._gram_cn(x)
    g, mu = gram.centered_gram_cn(x)
    assert cov.dtype == mean.dtype == torch.float32
    assert torch.equal(cov, g / (n - 1)) and torch.equal(mean, mu)
    # a view that is not contiguous gives the same bits
    cov_t, mean_t = twct._gram_cn(x.mT.contiguous().mT)
    assert torch.equal(cov_t, cov) and torch.equal(mean_t, mean)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gram_cn_batch_does_not_change_an_image(dtype):
    x = torch.from_numpy(
        np.ascontiguousarray(np.stack([_relu_map(2000, 48, seed=s).T for s in range(4)]))).to(dtype)
    cov, mean = twct._gram_cn(x)
    one_cov, one_mean = twct._gram_cn(x[2:3])
    assert torch.equal(one_cov[0], cov[2]) and torch.equal(one_mean[0], mean[2])


def test_gram_matches_reference_and_float64_at_relu1_1_size():
    """[262,144, 64], 77 % zeros: the JAX package's jitted ``_gram`` and
    the port's ``_gram`` within 1e-5 of each other and of float64."""
    x = _relu_map(262144, 64, seed=0)
    ref64 = _cov64(x)
    j_cov, j_mean = jax.jit(jwct._gram)(jnp.asarray(x))
    t_cov, t_mean = twct._gram(torch.from_numpy(x))
    assert _rel_fro(j_cov, ref64) <= 1e-5
    assert _rel_fro(t_cov.numpy(), ref64) <= 1e-5
    assert _rel_fro(t_cov.numpy(), j_cov) <= 1e-5
    np.testing.assert_allclose(t_mean.numpy(), x.astype(np.float64).mean(0), rtol=1e-6)
    np.testing.assert_allclose(t_mean.numpy(), np.asarray(j_mean), rtol=1e-6)


def test_bf16_gram_is_centred_and_close_to_float64():
    """The bf16 route takes the centred form: its covariance of bf16
    values is within 1e-5 of the float64 covariance of the same values,
    also when the mean is far above the spread."""
    x = (_relu_map(20000, 32, seed=1, zeros=0.5) + 40.0).astype(np.float32)
    x16 = torch.from_numpy(x).to(torch.bfloat16)
    cov, _ = twct._gram(x16)
    assert _rel_fro(cov.numpy(), _cov64(x16.float().numpy())) <= 1e-5


def test_bf16_gram_cn_matches_float64_at_relu1_1_size():
    """bf16 features of the relu1_1 level at 512 px ([1, 64, 262,144],
    77 % zeros): covariance and mean of the bf16 values within 1e-5 and
    1e-6 of float64, as the f32 features are."""
    x16 = torch.from_numpy(np.ascontiguousarray(_relu_map(262144, 64, seed=2).T)).to(torch.bfloat16)
    x = x16.float().numpy().T
    cov, mean = twct._gram_cn(x16[None])
    assert _rel_fro(cov[0].numpy(), _cov64(x)) <= 1e-5
    np.testing.assert_allclose(mean[0].numpy(), x.astype(np.float64).mean(0), rtol=1e-6)
