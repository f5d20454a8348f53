"""The Newton–Schulz and centred-Gram kernels at their designs' edges, on the card.

``csrc/ns_sqrtm.cu`` picks its route from C (resident at C <= 64, a
cluster of eight blocks up to 128, a launch per product above, 64 x 64 or
128 x 64 tiles) and pads C to a multiple of 64; ``csrc/centered_gram.cu``
tiles C by 64 (several images to a tile at C <= 32), splits N by
``gram.split_columns`` and stages rows by TMA only where they are 16-byte
aligned. These tests cross each of those edges. Every test needs an
NVIDIA GPU and skips without one; the file imports neither JAX nor
``wct_tpu``:

    python -m pytest --noconftest -q -m cuda tests/test_torch_ns_gram_cuda.py
"""

import numpy as np
import pytest
import torch

from wct_tpu_torch.ops import gram, sqrtm

pytestmark = pytest.mark.cuda

NS_F64_LIMIT = 5e-5  # the reference's bar (wct_tpu/ops/sqrtm.py:53-58)
GRAM_F64_LIMIT = 1e-6


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from wct_tpu_torch.utils.device import set_fp32_numerics

    set_fp32_numerics()
    return torch.device("cuda")


def _rel(a, b):
    return float(((a - b).flatten(1).norm(dim=1) / b.flatten(1).norm(dim=1)).max())


def _spd(b, c, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((b, c, c)))
    eigs = np.geomspace(1.0, 1e-2, c)
    return torch.from_numpy(((q * eigs) @ q.transpose(0, 2, 1)).astype(np.float32))


def _ns_float64(a, iters, reg=sqrtm.DEFAULT_REG):
    """(sqrt, isqrt) by the kernel's coupled iteration, every step in float64."""
    c = a.shape[-1]
    a64 = a.double()
    eye = torch.eye(c, dtype=torch.float64, device=a.device)
    a64 = a64 + (reg * a64.diagonal(dim1=-2, dim2=-1).sum(-1) / c)[:, None, None] * eye
    norm = a64.abs().sum(-1).amax(-1)[:, None, None]
    y, z = a64 / norm, eye.expand_as(a64)
    for _ in range(iters):
        t = 1.5 * eye - 0.5 * z @ y
        y, z = y @ t, t @ z
    return y * norm.sqrt(), z / norm.sqrt()


@pytest.mark.parametrize("iters", [0, 1, 14])
@pytest.mark.parametrize("c", [17, 64, 100, 128, 130, 256, 384, 512])
def test_ns_kernel_routes_and_edges(card, c, iters):
    """Every route and padding edge, B = 16 (B = 5 above 256), iterations 0,
    1 and 14: within 1e-4 of plain (1e-5 for 0 and 1 steps) and 5e-5 of the
    float64 iteration, both outputs; the first and the last matrix the same
    bits alone as in the batch."""
    b = 16 if c <= 256 else 5
    a = _spd(b, c, seed=c + iters).to(card)
    before = sqrtm.ns_sqrtm_cuda.launches
    sq, isq = sqrtm.ns_sqrtm_cuda(a, iters)
    assert sqrtm.ns_sqrtm_cuda.launches == before + 1
    sq_p, isq_p = sqrtm._ns_plain(a, iters, sqrtm.DEFAULT_REG)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(sq).all() and torch.isfinite(isq).all())
    limit = 1e-4 if iters == 14 else 1e-5
    assert _rel(sq, sq_p) <= limit and _rel(isq, isq_p) <= limit
    sq64, isq64 = _ns_float64(a, iters)
    assert _rel(sq.double(), sq64) <= NS_F64_LIMIT
    assert _rel(isq.double(), isq64) <= NS_F64_LIMIT
    for i in (0, b - 1):
        alone = sqrtm.ns_sqrtm_cuda(a[i:i + 1].contiguous(), iters)
        assert torch.equal(alone[0][0], sq[i]) and torch.equal(alone[1][0], isq[i])


@pytest.mark.parametrize("c", [130, 256, 512])
def test_ns_kernel_tiled_route_repeatable(card, c):
    """The tiled route's launches (one per product) give the same bits on
    every call."""
    a = _spd(3, c, seed=7).to(card)
    first = sqrtm.ns_sqrtm_cuda(a)
    second = sqrtm.ns_sqrtm_cuda(a)
    assert torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])


def _features(b, c, n, dtype, seed, device):
    """ReLU-like maps: about 77 % zeros, the rest half-normal."""
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.standard_normal((b, c, n), dtype=np.float32) - 0.7388, 0)
    return torch.from_numpy(x).to(dtype).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [7, 31, 1000, 1023, 1025, 262144])
@pytest.mark.parametrize("c", [16, 32, 48, 64, 130, 512])
def test_centered_gram_kernel_edges(card, c, n, dtype):
    """Packed tiles (C = 16, 32), a partial tile (48, 130), one split or
    many, rows the TMA copies or plain loads stage (N = 1023, 1025 are not
    16-byte rows): within 1e-6 of float64 (Gram and mean), G exactly
    symmetric, the last image the same bits alone as in the batch."""
    b = 2 if c * n > 2**24 else 3
    x = _features(b, c, n, dtype, seed=c * 7 + n, device=card)
    before = gram.centered_gram_cuda.launches
    got, mean = gram.centered_gram_cn(x)
    assert gram.centered_gram_cuda.launches == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, got.mT)
    x64 = x.double()
    mean64 = x64.mean(-1)
    assert float((mean - mean64).abs().max()) <= GRAM_F64_LIMIT * float(mean64.abs().max())
    c64 = x64 - mean64[..., None]
    g64 = c64 @ c64.mT
    del x64, c64
    assert _rel(got.double(), g64) <= GRAM_F64_LIMIT
    alone, alone_mean = gram.centered_gram_cn(x[b - 1:].contiguous())
    assert torch.equal(alone[0], got[b - 1]) and torch.equal(alone_mean[0], mean[b - 1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_centered_gram_unaligned_base_same_bits(card, dtype):
    """A map whose base is not 16-byte aligned goes through plain loads, not
    TMA: the same bits as an aligned copy of it (the sums' order follows N
    and C alone)."""
    x = _features(2, 64, 4096, dtype, seed=3, device=card)
    storage = torch.empty(x.numel() + 8, dtype=dtype, device=card)
    shifted = storage[1:1 + x.numel()].view_as(x)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 != 0
    got, mean = gram.centered_gram_cn(shifted)
    ref, ref_mean = gram.centered_gram_cn(x)
    assert torch.equal(got, ref) and torch.equal(mean, ref_mean)
