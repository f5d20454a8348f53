"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file
imports neither JAX nor ``wct_tpu``, so it runs on a machine that has
PyTorch with CUDA and no JAX; there, skip the JAX-only conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from wct_tpu_torch.ops import sqrtm

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from wct_tpu_torch.utils.device import set_fp32_numerics

    set_fp32_numerics()
    return torch.device("cuda")


def _spd(b, c, seed, cond=100.0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((b, c, c)))
    eigs = np.geomspace(1.0, 1.0 / cond, c)
    return torch.from_numpy(((q * eigs) @ q.transpose(0, 2, 1)).astype(np.float32))


def _rel(a, b):
    return float(((a - b).flatten(1).norm(dim=1) / b.flatten(1).norm(dim=1)).max())


@pytest.mark.parametrize(
    "b,c",
    [(1, 1), (3, 17), (2, 64), (1, 100), (4, 128), (2, 130), (4, 256), (1, 384), (2, 512)],
)
def test_ns_kernel_matches_plain(card, b, c):
    """Tile edges (C not a multiple of 64) included; bound 1e-4 relative."""
    a = _spd(b, c, seed=c).to(card)
    before = sqrtm.ns_sqrtm_cuda.launches
    sq_k, isq_k = sqrtm.newton_schulz_sqrtm(a, use_kernel=True)
    assert sqrtm.ns_sqrtm_cuda.launches == before + 1
    sq_p, isq_p = sqrtm._ns_plain(a, sqrtm.DEFAULT_ITERS, sqrtm.DEFAULT_REG)
    torch.cuda.synchronize()
    assert _rel(sq_k, sq_p) <= 1e-4
    assert _rel(isq_k, isq_p) <= 1e-4


@pytest.mark.parametrize("iters", [0, 1, 3])
def test_ns_kernel_iteration_counts(card, iters):
    a = _spd(2, 96, seed=iters).to(card)
    sq_k, isq_k = sqrtm.ns_sqrtm_cuda(a, iters, 1e-3)
    sq_p, isq_p = sqrtm._ns_plain(a, iters, 1e-3)
    assert _rel(sq_k, sq_p) <= 1e-5
    assert _rel(isq_k, isq_p) <= 1e-5


def test_ns_kernel_deterministic(card):
    a = _spd(3, 192, seed=5).to(card)
    first = sqrtm.ns_sqrtm_cuda(a)
    second = sqrtm.ns_sqrtm_cuda(a)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.parametrize("case", ["float64", "2d", "non_square", "non_contiguous"])
def test_ns_kernel_rejects_bad_input_on_card(card, case):
    a = _spd(2, 64, seed=0).to(card)
    bad = {
        "float64": a.double(),
        "2d": a[0],
        "non_square": a[:, :, :32],
        "non_contiguous": a.mT,
    }[case]
    with pytest.raises((TypeError, ValueError)):
        sqrtm.ns_sqrtm_cuda(bad)


def test_cascade_kernel_matches_plain_cascade(card):
    """Trained bundle, 64 px, two levels: kernel path vs plain path."""
    from pathlib import Path

    from wct_tpu_torch.models import cascade
    from wct_tpu_torch.train import checkpoint

    bundle = Path(__file__).resolve().parent.parent / "weights" / "bundle.npz"
    params = checkpoint.params_from_numpy(checkpoint.load_pytree(bundle), card)
    rng = np.random.default_rng(0)
    content = rng.random((3, 64, 64, 3)).astype(np.float32)
    style = rng.random((64, 64, 3)).astype(np.float32)
    outs = {}
    for method in ("newton_schulz_pallas", "newton_schulz"):
        cfg = cascade.CascadeConfig(relu_targets=("relu2_1", "relu1_1"), method=method)
        cache = cascade.precompute_style(params["encoder"], style, cfg)
        outs[method] = cascade.stylize_microbatched(params, content, cache, 0.6, cfg, 2)
    d = (outs["newton_schulz_pallas"] - outs["newton_schulz"]).abs()
    assert float(d.max()) <= 1e-3
