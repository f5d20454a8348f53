"""The block-Jacobi eigendecomposition (``wct_tpu_torch/ops/eigh.py``): its
plain twin, the CUDA kernel's oracle, against float64 ``torch.linalg.eigh``
on the CPU, and the dispatch of ``eigh_cn``.

Every case is an f32 matrix; the reference is float64 ``eigh`` of that same
matrix, so the numbers measure the decomposition and not the input's
rounding. Each case is held against f32 ``torch.linalg.eigh`` (LAPACK here)
on the same matrix, under the same bounds:

- eigenvalues ascending;
- ``‖UᵀU − I‖_F`` no larger than f32 ``eigh``'s;
- the WCT's matrices ``_sym_pow(·, ±½)`` after the hard 1e-5 mask no
  farther (relative Frobenius) from float64's than twice f32 ``eigh``'s,
  the factor the kernel is held to on the card (measured: the twin nearer
  than f32 ``eigh`` but for relu2_1's +½, 1.35× as far);
- the residual ``‖AU − UΛ‖_F / ‖A‖_F`` and the eigenvalues' largest error
  over the largest eigenvalue within C·2⁻²³, the backward-error scale
  both meet. The twin trails LAPACK there (by up to 5× on the residual,
  15× on the eigenvalues, measured): its diagonal gathers a rounding per
  round where LAPACK's tridiagonal form gathers one per reflection.

The spectra: seeded SPD matrices at C = 7, 64, 128, 256 and 512; a
condition of 1e11 (graded, ``D H D``, as a covariance whose channels'
variances span 1e11); three tight clusters; eigenvalues repeated exactly;
modes under 1e-5, zero and negative; an exactly diagonal matrix with
repeats; and every level's covariances of the trained bundle on a seeded
512² image (C = 512, 512, 256, 128, 64).
"""

import math
from pathlib import Path

import numpy as np
import pytest
import torch

from wct_tpu_torch.models import vgg
from wct_tpu_torch.ops import eigh, wct
from wct_tpu_torch.train import checkpoint
from wct_tpu_torch.utils import profiling

BUNDLE = Path(__file__).resolve().parent.parent / "weights" / "bundle.npz"
EPS32 = 2.0 ** -23
LEVELS = ("relu5_1", "relu4_1", "relu3_1", "relu2_1", "relu1_1")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _spd(c: int, spectrum, seed: int) -> torch.Tensor:
    """``Q diag(spectrum) Qᵀ`` in float64 with a seeded orthogonal Q, rounded to f32."""
    g = torch.Generator().manual_seed(seed)
    q, _ = torch.linalg.qr(torch.randn(c, c, generator=g, dtype=torch.float64))
    spectrum = torch.as_tensor(spectrum, dtype=torch.float64)
    return ((q * spectrum) @ q.T).float()[None]


def _geometric(c: int, cond: float, top: float = 7.6e5) -> torch.Tensor:
    return top * torch.logspace(0, -math.log10(cond), c, dtype=torch.float64)


def _graded(c: int, cond: float, seed: int) -> torch.Tensor:
    """``D H D``: channel scales D spanning ``cond`` in variance around a
    well-conditioned correlation H, as a covariance of features whose
    variances differ by orders of magnitude; its eigenvalues span about
    ``cond`` and f32 can resolve them relative to their size."""
    h = _spd(c, torch.linspace(0.5, 2.0, c, dtype=torch.float64), seed)[0].double()
    d = torch.sqrt(_geometric(c, cond))
    return (d[:, None] * h * d[None, :]).float()[None]


def _cases() -> dict:
    jitter = 1 + 1e-6 * torch.randn(96, generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    small = [1e-6, 1e-7, 0.0, -1e-7, 3e-6, 5e-6, 9e-6, 2e-5, -3e-7, -1e-3]
    return {
        **{f"spd{c}": lambda c=c: _spd(c, _geometric(c, 1e6), c) for c in (7, 64, 128, 256, 512)},
        "condition_1e11": lambda: _graded(128, 1e11, 11),
        "clusters": lambda: _spd(96, torch.cat([torch.full((32,), 5.0), torch.full((32,), 1.0),
                                                torch.full((32,), 1e-3)]).double() * jitter, 96),
        "repeated": lambda: _spd(80, [2.0] * 40 + [0.5] * 40, 80),
        "under_1e-5": lambda: _spd(70, torch.cat([_geometric(60, 1e4, 10.0),
                                                  torch.tensor(small, dtype=torch.float64)]), 70),
        "diagonal": lambda: torch.diag(torch.tensor([3.0] * 10 + [1.0] * 10 + [0.0] * 5 + [-2.0] * 5))[None],
    }


CASES = _cases()


def _rel(x: torch.Tensor, ref: torch.Tensor) -> float:
    return float(((x - ref).flatten(1).norm(dim=1) / ref.flatten(1).norm(dim=1).clamp_min(1e-300)).max())


def _powers(cov: torch.Tensor, decompose, monkeypatch) -> tuple[torch.Tensor, torch.Tensor]:
    """``wct._sym_pow(cov, ∓½)`` (hard 1e-5 mask) with ``eigh_cn`` replaced by ``decompose``."""
    monkeypatch.setattr(eigh, "eigh_cn", decompose)
    out = (wct._sym_pow(cov, -0.5, wct.DEFAULT_TRUNC), wct._sym_pow(cov, 0.5, wct.DEFAULT_TRUNC))
    monkeypatch.undo()
    return out


def _errors(a: torch.Tensor, s: torch.Tensor, u: torch.Tensor, powers) -> dict:
    a64 = a.double()
    s64, _ = torch.linalg.eigh(a64)
    ref = powers["float64"]
    ud, sd = u.double(), s.double()
    eye = torch.eye(a.shape[-1], dtype=torch.float64)
    return {
        "orth": float((ud.mT @ ud - eye).norm(dim=(1, 2)).max()),
        "residual": _rel(a64 @ ud, ud * sd[:, None, :]),
        "eigenvalues": float(((sd - s64).abs().amax(-1) / s64.abs().amax(-1).clamp_min(1e-300)).max()),
        "minus_half": _rel(powers["got"][0].double(), ref[0]),
        "plus_half": _rel(powers["got"][1].double(), ref[1]),
    }


def _check(a: torch.Tensor, monkeypatch) -> dict:
    """The twin's and f32 ``torch.linalg.eigh``'s errors on ``a [B, C, C]``;
    asserts the bounds of the module docstring."""
    s, u, sweeps = eigh._eigh_plain(a)
    assert bool((s[:, 1:] >= s[:, :-1]).all())
    assert int(sweeps.max()) < eigh.MAX_SWEEPS
    s32, u32 = torch.linalg.eigh(a)
    twin_powers = _powers(a, lambda c: (s, u), monkeypatch)
    lapack_powers = _powers(a, lambda c: (s32, u32), monkeypatch)
    f64_powers = _powers(a.double(), torch.linalg.eigh, monkeypatch)
    twin = _errors(a, s, u, {"got": twin_powers, "float64": f64_powers})
    lapack = _errors(a, s32, u32, {"got": lapack_powers, "float64": f64_powers})
    scale = a.shape[-1] * EPS32
    assert twin["orth"] <= lapack["orth"], (twin, lapack)
    for name in ("minus_half", "plus_half"):
        assert twin[name] <= 2.0 * lapack[name], (name, twin, lapack)
    for name in ("residual", "eigenvalues"):
        assert max(twin[name], lapack[name]) <= scale, (name, twin, lapack)
    return twin


@pytest.mark.parametrize("case", sorted(CASES))
def test_twin_against_float64_on_shaped_spectra(case, monkeypatch):
    a = CASES[case]()
    _check(a, monkeypatch)
    if case in ("under_1e-5", "diagonal"):  # signed: a negative eigenvalue stays negative
        s = eigh._eigh_plain(a)[0]
        s64 = torch.linalg.eigvalsh(a.double())
        assert float(s.min()) < 0 and float(s64.min()) < 0
        assert abs(float(s.min()) - float(s64.min())) <= a.shape[-1] * EPS32 * float(s64.abs().max())


@pytest.fixture(scope="module")
def trained_covariances():
    """Each level's covariance (+ ε·I) of one seeded 512² image through the
    trained encoder, as the cascade's ``_gram_cn`` forms them."""
    params = checkpoint.params_from_numpy(checkpoint.load_pytree(BUNDLE), "cpu")
    rng = np.random.default_rng(2149300004)
    grid = rng.random((1, 3, 16, 16)).astype(np.float32)
    image = torch.nn.functional.interpolate(torch.as_tensor(grid), size=(512, 512), mode="bicubic",
                                            align_corners=False)
    image = (image + 0.1 * torch.as_tensor(rng.standard_normal((1, 3, 512, 512)), dtype=torch.float32))
    image = image.clamp(0.0, 1.0)
    with torch.no_grad():
        feats = vgg.encode_multi_nchw(params["encoder"], image, LEVELS)
    out = {}
    for level in LEVELS:
        cov, _ = wct._gram_cn(feats[level].flatten(2))
        out[level] = cov + wct.DEFAULT_EPS * torch.eye(cov.shape[-1])
    return out


@pytest.mark.parametrize("level", LEVELS)
def test_twin_against_float64_on_trained_covariances(trained_covariances, level, monkeypatch):
    a = trained_covariances[level]
    assert a.shape[-1] == {"relu5_1": 512, "relu4_1": 512, "relu3_1": 256, "relu2_1": 128,
                           "relu1_1": 64}[level]
    _check(a, monkeypatch)


def test_each_pair_of_indices_turns_once_a_sweep():
    """A sweep's first round meets every index with all 31 others of its pair
    of blocks, the other rounds each index of one block with each of the
    other's; with the rounds' block pairs that covers every pair of indices of
    the padded matrix exactly once."""
    full, cross = eigh.round_robin(2 * eigh.BLOCK), eigh._cross_steps()
    assert len(full) == 31 and len(cross) == eigh.BLOCK
    for steps in (full, cross):
        for step in steps:
            assert sorted(i for pair in step for i in pair) == list(range(32))
    for nb in (2, 4, 6, 8, 16, 32):
        seen: dict = {}
        for r, pairs in enumerate(eigh.round_robin(nb)):
            for bi, bj in pairs:
                index = [eigh.BLOCK * bi + a for a in range(eigh.BLOCK)] + [
                    eigh.BLOCK * bj + a for a in range(eigh.BLOCK)]
                for step in full if r == 0 else cross:
                    for p, q in step:
                        key = tuple(sorted((index[p], index[q])))
                        seen[key] = seen.get(key, 0) + 1
        n = eigh.BLOCK * nb
        assert seen == {(i, j): 1 for i in range(n) for j in range(i + 1, n)}, nb


def test_twin_reads_the_lower_triangle_and_drops_the_padding():
    a = _spd(33, _geometric(33, 1e3, 1.0), 33)
    noise = torch.randn(33, 33, generator=torch.Generator().manual_seed(1))
    lopsided = torch.tril(a) + torch.triu(noise, 1)  # garbage above the diagonal
    s, u, _ = eigh._eigh_plain(lopsided)
    s_ref, u_ref, _ = eigh._eigh_plain(a)
    assert torch.equal(s, s_ref) and torch.equal(u, u_ref)
    assert s.shape == (1, 33) and u.shape == (1, 33, 33)
    s64 = torch.linalg.eigvalsh(a.double())
    assert float((s.double() - s64).abs().max()) <= 33 * EPS32 * float(s64.abs().max())


def test_eigh_cn_takes_torch_eigh_off_the_card():
    a = CASES["spd64"]()
    for x in (a, a.double(), torch.stack([a[0], a[0] * 2])):
        s, u = eigh.eigh_cn(x)
        s_ref, u_ref = torch.linalg.eigh(x)
        assert torch.equal(s, s_ref) and torch.equal(u, u_ref)
    s, u = eigh.eigh_cn(a.reshape(1, 1, 64, 64))  # leading dims kept
    assert s.shape == (1, 1, 64) and u.shape == (1, 1, 64, 64)


def test_eigh_cuda_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="CUDA tensor"):
        eigh.eigh_cuda(torch.eye(4)[None])
    with pytest.raises(TypeError, match="float32"):
        eigh.eigh_cuda(torch.eye(4, dtype=torch.float64)[None])
    with pytest.raises(ValueError, match=r"a \[B, C, C\]"):
        eigh.eigh_cuda(torch.zeros(2, 3, 4))
    assert eigh.padded_edge(1) == 32 and eigh.padded_edge(512) == 512 and eigh.padded_edge(33) == 64
    assert eigh.tolerance(64) == pytest.approx(8 * EPS32)


def test_the_eigh_span_lies_inside_the_sqrt_span():
    x = torch.as_tensor(np.random.default_rng(0).random((2, 16, 40)), dtype=torch.float32)
    profiling.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        wct.whitening_kernel_cn(x, method="eigh")
        wct.whiten_color_kernels_cn(x, method="eigh")
        wct.whitening_kernel_cn(x, method="newton_schulz")
    totals = profiling.span_totals()
    profiling.reset_spans()
    assert totals["wct.op.eigh"]["calls"] == 2
    assert totals["wct.op.sqrt"]["calls"] == 3
