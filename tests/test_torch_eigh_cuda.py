"""The eigh kernel (``csrc/eigh_jacobi.cu``) on the card, against its plain
twin (``ops/eigh.py::_eigh_plain``, run on the card too) and float64
``eigh`` of the same f32 matrices: at B = 1, 2, 4, 8 and every C the
cascade (64 … 512) and ``wct_groups`` (down to 4) give, and a few that
need padding; on the trained covariances of a microbatch at all five
levels, against cuSOLVER's f32 eigh too; on every card, bitwise the
first's; and on one f32 microbatch of the default route, which must
launch it five times, reach no sweep cap and synchronise nowhere. Every
test needs an NVIDIA GPU and skips without one (the every-card test a
second); the file imports neither JAX nor ``wct_tpu``:

    python -m pytest --noconftest -q -m cuda tests/test_torch_eigh_cuda.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from wct_tpu_torch.models import cascade, vgg
from wct_tpu_torch.ops import eigh, wct
from wct_tpu_torch.train import checkpoint

pytestmark = pytest.mark.cuda

BUNDLE = Path(__file__).resolve().parent.parent / "weights" / "bundle.npz"
EPS32 = 2.0 ** -23


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from wct_tpu_torch.utils.device import set_fp32_numerics

    set_fp32_numerics()
    return torch.device("cuda")


def _spd(b, c, seed, device):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((b, c, c)))
    eigs = np.geomspace(50.0, 50.0e-6, c)
    return torch.from_numpy(((q * eigs) @ q.transpose(0, 2, 1)).astype(np.float32)).to(device)


def _errors(a, s, u):
    """Per matrix: ‖UᵀU − I‖_F, the eigenvalues' largest error over the
    largest, and A^-1/2's (hard 1e-5 mask) relative distance, from float64
    eigh of the same matrix."""
    s64, u64 = torch.linalg.eigh(a.double())
    sd, ud = s.double(), u.double()

    def minus_half(s_, u_):
        keep = s_ > wct.DEFAULT_TRUNC
        return (u_ * torch.where(keep, s_.abs() ** -0.5, 0.0)[..., None, :]) @ u_.mT

    ref = minus_half(s64, u64)
    eye = torch.eye(a.shape[-1], dtype=torch.float64, device=a.device)
    return ((ud.mT @ ud - eye).norm(dim=(1, 2)), (sd - s64).abs().amax(-1) / s64.abs().amax(-1),
            (minus_half(sd, ud) - ref).flatten(1).norm(dim=1) / ref.flatten(1).norm(dim=1))


@pytest.mark.parametrize("c", [4, 7, 8, 16, 32, 33, 64, 100, 128, 256, 512])
def test_kernel_against_twin_and_float64(card, c):
    a = _spd(8, c, c, card)
    s, u = eigh.eigh_cuda(a)
    assert bool((s[:, 1:] >= s[:, :-1]).all())
    for b in (1, 2, 4):  # a matrix's result does not depend on its batch
        sb, ub = eigh.eigh_cuda(a[:b].contiguous())
        assert torch.equal(sb, s[:b]) and torch.equal(ub, u[:b]), b
    st, ut, _ = eigh._eigh_plain(a[:2])
    orth, eigenvalues, minus_half = _errors(a, s, u)
    _, _, twin_minus_half = _errors(a[:2], st, ut)
    scale = max(c, 32) * EPS32
    assert float(orth.max()) <= scale and float(eigenvalues.max()) <= scale
    assert float(minus_half[:2].max()) <= 2.0 * float(twin_minus_half.max()) + 1e-6
    assert float((s[:2] - st).abs().max()) <= scale * float(st.abs().max())


@pytest.fixture(scope="module")
def trained_covariances():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    params = checkpoint.params_from_numpy(checkpoint.load_pytree(BUNDLE), "cuda")
    rng = np.random.default_rng(11)
    x = torch.as_tensor(rng.random((4, 3, 512, 512)), dtype=torch.float32, device="cuda")
    x = torch.nn.functional.avg_pool2d(x, 9, stride=1, padding=4)  # smoother, as photographs are
    with torch.no_grad():
        feats = vgg.encode_multi_nchw(params["encoder"], x, cascade.DEFAULT_TARGETS)
    out = {}
    for level in cascade.DEFAULT_TARGETS:
        cov, _ = wct._gram_cn(feats[level].flatten(2))
        out[level] = (cov + wct.DEFAULT_EPS * torch.eye(cov.shape[-1], device="cuda")).contiguous()
    return params, out


@pytest.mark.parametrize("level", cascade.DEFAULT_TARGETS)
def test_kernel_on_trained_covariances(card, trained_covariances, level):
    _, covs = trained_covariances
    a = covs[level]
    s, u = eigh.eigh_cuda(a)
    sl, ul = torch.linalg.eigh(a)
    orth, eigenvalues, minus_half = _errors(a, s, u)
    _, _, library_minus_half = _errors(a, sl, ul)
    scale = a.shape[-1] * EPS32
    assert float(orth.max()) <= scale and float(eigenvalues.max()) <= scale
    assert float(minus_half.max()) <= 2.0 * float(library_minus_half.max())
    assert eigh.capped_sweeps() == 0


def test_an_f32_microbatch_launches_five_times_and_never_waits(card, trained_covariances):
    params, _ = trained_covariances
    rng = np.random.default_rng(3)
    cfg = cascade.CascadeConfig()
    cache = cascade.precompute_style(params["encoder"], rng.random((512, 512, 3)).astype(np.float32), cfg)
    batch = torch.as_tensor(rng.random((4, 512, 512, 3)), dtype=torch.float32, device="cuda")
    cascade.stylize(params, batch, cache, 0.6, cfg)
    torch.cuda.synchronize()
    before = eigh.eigh_cuda.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = cascade.stylize(params, batch, cache, 0.6, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert eigh.eigh_cuda.launches - before == 5
    assert bool(torch.isfinite(out).all())
    assert eigh.capped_sweeps() == 0


def test_kernel_on_every_card(card):
    """A cluster of 16 blocks (C = 512) needs a per-device attribute: after a
    call on the first card, every other card gives the same bits."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second CUDA device")
    a = _spd(4, 512, 5, card)
    s0, u0 = eigh.eigh_cuda(a)
    for i in range(1, torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        s, u = eigh.eigh_cuda(a.to(dev))
        assert s.device == dev and u.device == dev
        assert torch.equal(s.cpu(), s0.cpu()) and torch.equal(u.cpu(), u0.cpu()), dev
        assert eigh.capped_sweeps(dev) == 0


def test_dispatch_on_the_card(card):
    a = _spd(2, 64, 1, card)
    before = eigh.eigh_cuda.launches
    s, u = eigh.eigh_cn(a.double())  # float64 keeps torch.linalg.eigh
    assert s.dtype == torch.float64 and eigh.eigh_cuda.launches == before
    eigh.eigh_cn(a.reshape(1, 2, 64, 64))
    assert eigh.eigh_cuda.launches == before + 1
    with pytest.raises(ValueError, match="C ≤ 512"):
        eigh.eigh_cn(torch.eye(513, device=card)[None])
    nan = torch.full((1, 40, 40), float("nan"), device=card)
    s, _ = eigh.eigh_cuda(nan)  # returns: no rotation ever passes the threshold
    torch.cuda.synchronize()
    assert s.shape == (1, 40)
