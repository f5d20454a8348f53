"""Port Newton–Schulz against ``wct_tpu``'s Pallas kernel (interpret mode).

The port's plain version is what the CUDA kernel is held against on the
card; here it is held against ``newton_schulz_sqrtm(use_pallas=True)``,
which runs ``_sqrtm_pallas`` in interpret mode off the TPU. Bound:
relative Frobenius error ≤ 1e-5 on both outputs. Measured: 0 at C=64,
≤ 3e-6 at C=512 on SPD matrices, ≤ 1.5e-6 on the trained encoder's
full-rank Grams. (Rank-deficient Grams, N < C, differ by up to 8e-5 in
the inverse root: the floor modes are where the iteration is still
moving, and both packages round differently there.)
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wct_tpu.models import vgg as jvgg
from wct_tpu.ops import sqrtm as jsqrtm
from wct_tpu.train import checkpoint as jck
from wct_tpu_torch.ops import sqrtm as tsqrtm

BUNDLE = Path(__file__).resolve().parent.parent / "weights" / "bundle.npz"
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


def _spd(rng, c, cond=100.0):
    """Random SPD matrix with controlled condition number (tests/test_sqrtm.py)."""
    q, _ = np.linalg.qr(rng.standard_normal((c, c)))
    eigs = np.geomspace(1.0, 1.0 / cond, c)
    return (q * eigs) @ q.T


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _check_against_pallas(cov):
    j_sq, j_isq = jsqrtm.newton_schulz_sqrtm(jnp.asarray(cov), use_pallas=True)
    t_sq, t_isq = tsqrtm.newton_schulz_sqrtm(torch.from_numpy(cov)[None], use_kernel=True)
    assert _rel(t_sq[0].numpy(), np.asarray(j_sq)) <= BOUND
    assert _rel(t_isq[0].numpy(), np.asarray(j_isq)) <= BOUND


@pytest.mark.parametrize("c", [64, 128, 512])
def test_plain_matches_pallas_spd(rng, c):
    _check_against_pallas(_spd(rng, c).astype(np.float32))


@pytest.fixture(scope="module")
def relu_grams():
    """Gram + eps·I of each level of one 256-px image, trained encoder.

    Every level up to relu4_1 is full rank at 256 px (N ≥ C).
    """
    params = jck.load_pytree(BUNDLE)
    x = np.random.default_rng(4).random((1, 256, 256, 3)).astype(np.float32)
    targets = ("relu1_1", "relu2_1", "relu3_1", "relu4_1")
    feats = jvgg.encode_multi(params["encoder"], jnp.asarray(x), targets)
    grams = {}
    for t in targets:
        f = np.asarray(feats[t])[0].reshape(-1, jvgg.TARGET_CHANNELS[t]).astype(np.float64)
        f -= f.mean(0)
        cov = f.T @ f / (f.shape[0] - 1) + 1e-8 * np.eye(f.shape[1])
        grams[t] = cov.astype(np.float32)
    return grams


@pytest.mark.parametrize("target", ["relu1_1", "relu2_1", "relu3_1", "relu4_1"])
def test_plain_matches_pallas_relu_grams(relu_grams, target):
    _check_against_pallas(relu_grams[target])


def test_batched_equals_one_by_one(rng):
    covs = np.stack([_spd(rng, 32, cond=c) for c in (10.0, 100.0, 1000.0)]).astype(np.float32)
    sq, isq = tsqrtm.newton_schulz_sqrtm(torch.from_numpy(covs))
    for i in range(3):
        s1, i1 = tsqrtm.newton_schulz_sqrtm(torch.from_numpy(covs[i : i + 1]))
        np.testing.assert_allclose(sq[i].numpy(), s1[0].numpy(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(isq[i].numpy(), i1[0].numpy(), rtol=1e-6, atol=1e-7)


def test_cpu_tensor_takes_the_plain_version(rng):
    cov = torch.from_numpy(_spd(rng, 48).astype(np.float32))[None]
    before = tsqrtm.ns_sqrtm_cuda.launches
    kernel_path = tsqrtm.newton_schulz_sqrtm(cov, use_kernel=True)
    plain = tsqrtm._ns_plain(cov, tsqrtm.DEFAULT_ITERS, tsqrtm.DEFAULT_REG)
    assert tsqrtm.ns_sqrtm_cuda.launches == before
    for a, b in zip(kernel_path, plain):
        assert torch.equal(a, b)


@pytest.mark.parametrize(
    "case,exc",
    [
        ("float64", TypeError),
        ("2d", ValueError),
        ("non_square", ValueError),
        ("cpu_tensor", ValueError),
    ],
)
def test_kernel_wrapper_rejects_bad_input_without_card(rng, case, exc):
    """The wrapper checks shape, dtype and device before it builds anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; tests/test_torch_cuda.py covers it")
    cov = torch.from_numpy(_spd(rng, 16).astype(np.float32))[None]
    bad = {
        "float64": cov.double(),
        "2d": cov[0],
        "non_square": cov[:, :, :8],
        "cpu_tensor": cov,
    }[case]
    with pytest.raises(exc):
        tsqrtm.ns_sqrtm_cuda(bad)
    assert tsqrtm.ns_sqrtm_cuda.launches == 0


@pytest.mark.parametrize("c", [17, 64, 130, 256])
def test_plain_converges_to_float64_square_root(c):
    """The plain version, which the card holds the kernel against, within
    the reference's bar of 5e-5 (wct_tpu/ops/sqrtm.py:53-58) of the float64
    eigendecomposition the card's accuracy checks use, on SPD matrices of
    condition number 100, and that reference squares back to A + reg·tr/C·I."""
    from wct_tpu_torch.tools.profile_sqrtm import sqrt_float64

    rng = np.random.default_rng(c)
    a = torch.from_numpy(np.stack([_spd(rng, c), _spd(rng, c)]).astype(np.float32))
    ref, a64 = sqrt_float64(a)
    assert float((ref @ ref - a64).norm() / a64.norm()) <= 1e-12
    sq, _ = tsqrtm.newton_schulz_sqrtm(a)
    assert _rel(sq.double().numpy(), ref.numpy()) <= 5e-5
