"""``fold_transform`` and ``ring_conv`` in the port, against ``wct_tpu``.

The ops on the shapes of ``tests/test_convs.py:58-98``: the ring conv
(f32 to 1e-5, bf16 within one bf16 ulp, ``|Δ| ≤ 2⁻⁷·|ref| +
1e-5·max|ref|``) and the per-image conv, against the reference's and
against a per-image loop. ``decode_folded`` against the reference's, dense
and diagonal. Then the cascade on the trained bundle with each flag, per
level at α 0.6 (``tests/test_torch_cascade.py``'s bounds: q99 ≤ 1e-4,
max ≤ 1e-3) and over five levels (q99 ≤ 5e-3), JAX's Newton–Schulz
kernel in interpret mode against the port's plain Newton–Schulz. Last the
serving and mesh wrappers: alone = batch, a mesh of one = ``stylize``,
and ``stylize_spatial`` with either flag against the call without it.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wct_tpu.models import cascade as jcascade
from wct_tpu.models import decoder as jdec
from wct_tpu.ops import convs as jconvs
from wct_tpu.train import checkpoint as jck
from wct_tpu_torch.models import cascade as tcascade
from wct_tpu_torch.models import decoder as tdec
from wct_tpu_torch.ops import convs as tconvs
from wct_tpu_torch.parallel import mesh as tmesh
from wct_tpu_torch.train import checkpoint as tck

BUNDLE = Path(__file__).resolve().parent.parent / "weights" / "bundle.npz"
SIZE = 128
METHOD = "newton_schulz_pallas"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite runs in
    parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(9)
    content = rng.random((SIZE, SIZE, 3)).astype(np.float32)
    style = rng.random((SIZE, SIZE, 3)).astype(np.float32)
    return (jck.load_pytree(BUNDLE), tck.params_from_numpy(tck.load_pytree(BUNDLE), "cpu"),
            content, style)


def _oihw(w_hwio: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1)))


def _within_bf16_ulp(got: np.ndarray, ref: np.ndarray) -> bool:
    got, ref = got.astype(np.float64), ref.astype(np.float64)
    return bool((np.abs(got - ref) <= 2.0**-7 * np.abs(ref) + 1e-5 * np.abs(ref).max()).all())


# ------------------------------------------------------------------ ops

# tests/test_convs.py:67-74, and a map below 2p for a 5×5 kernel.
RING_SHAPES = [
    ((2, 8, 8, 5), 3),
    ((1, 6, 10, 3), 3),
    ((2, 5, 5, 3), 5),
    ((1, 4, 4, 3), 5),   # H == 2p
    ((2, 7, 7, 3), 1),   # 1×1 pass-through
    ((1, 2, 2, 3), 3),   # H == 2p for k = 3
    ((1, 3, 6, 3), 5),   # H below 2p: the reference's exit to the padded conv
]


def _ring_inputs(rng, shape, k):
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((k, k, shape[-1], 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("shape,k", RING_SHAPES, ids=lambda v: str(v))
def test_ring_conv_f32_matches_reference_and_padded(shape, k):
    x, w, b = _ring_inputs(np.random.default_rng(0), shape, k)
    ref = np.asarray(jconvs.conv2d_reflect_ring(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    xt, wt, bt = torch.from_numpy(x), _oihw(w), torch.from_numpy(b)
    got = tconvs.conv2d_reflect_ring(xt, wt, bt).numpy()
    padded = tconvs.conv2d_reflect(xt, wt, bt).numpy()
    assert got.shape == ref.shape == shape[:3] + (6,)
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, padded, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shape,k", RING_SHAPES, ids=lambda v: str(v))
def test_ring_conv_bf16_within_one_ulp(shape, k):
    x, w, b = _ring_inputs(np.random.default_rng(1), shape, k)
    ref = np.asarray(jconvs.conv2d_reflect_ring(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b)).astype(jnp.float32))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = tconvs.conv2d_reflect_ring(xt, _oihw(w), torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    assert _within_bf16_ulp(got.float().numpy(), ref)
    padded = tconvs.conv2d_reflect(xt, _oihw(w), torch.from_numpy(b))
    assert _within_bf16_ulp(got.float().numpy(), padded.float().numpy())


def test_ring_conv_keeps_the_map_below_2p_on_the_padded_path(monkeypatch):
    """H or W below 2p, and k = 1, never reach the SAME conv."""
    calls = []
    real = tconvs._stock_conv
    monkeypatch.setattr(tconvs, "_stock_conv",
                        lambda *a, **kw: calls.append(kw.get("padding", 0)) or real(*a, **kw))
    for shape, k in (((1, 3, 6, 3), 5), ((1, 6, 3, 3), 5), ((2, 7, 7, 3), 1)):
        x, w, b = _ring_inputs(np.random.default_rng(2), shape, k)
        tconvs.conv2d_reflect_ring(torch.from_numpy(x), _oihw(w), torch.from_numpy(b))
    assert calls == [0, 0, 0]
    x, w, b = _ring_inputs(np.random.default_rng(2), (1, 4, 4, 3), 5)
    calls.clear()
    tconvs.conv2d_reflect_ring(torch.from_numpy(x), _oihw(w), torch.from_numpy(b))
    assert calls == [2, 0, 0, 0, 0]  # the SAME conv, then four strips


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_perimage_conv_matches_reference_and_loop(dtype):
    """tests/test_convs.py:83's shapes: the grouped conv against the
    reference's and against a per-image ``conv2d_reflect`` loop."""
    rng = np.random.default_rng(3)
    nb, h, w_, ci, co = 3, 6, 7, 5, 4
    x = rng.standard_normal((nb, h, w_, ci)).astype(np.float32)
    w = rng.standard_normal((nb, 3, 3, ci, co)).astype(np.float32)
    b = rng.standard_normal((nb, co)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    ref = np.asarray(jconvs.conv2d_reflect_perimage(
        jnp.asarray(x, jdt), jnp.asarray(w), jnp.asarray(b)).astype(jnp.float32))
    wt = torch.from_numpy(np.ascontiguousarray(w.transpose(0, 4, 3, 1, 2)))
    xt, bt = torch.from_numpy(x).to(tdt), torch.from_numpy(b)
    got = tconvs.conv2d_reflect_perimage(xt, wt, bt)
    assert got.dtype == tdt and tuple(got.shape) == (nb, h, w_, co)
    loop = torch.cat([tconvs.conv2d_reflect(xt[i:i + 1], wt[i], bt[i]) for i in range(nb)])
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got.numpy(), loop.numpy(), atol=1e-5, rtol=1e-5)
    else:
        assert _within_bf16_ulp(got.float().numpy(), ref)
        assert _within_bf16_ulp(got.float().numpy(), loop.float().numpy())


def test_perimage_nchw_is_the_nhwc_form():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((2, 5, 9, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((2, 3, 5, 3, 3)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 3)).astype(np.float32))
    nhwc = tconvs.conv2d_reflect_perimage(tconvs.to_nhwc(x), w, b)
    assert torch.equal(tconvs.to_nchw(nhwc), tconvs.conv2d_reflect_perimage_nchw(x, w, b))


# -------------------------------------------------------- decode_folded


@pytest.mark.parametrize("target", ["relu1_1", "relu2_1"])
def test_decode_folded_dense_matches_reference(setup, target):
    """tests/test_models.py:327's dense WCT affine, on the trained
    decoders: against the reference's ``decode_folded`` and against the
    port's unfolded decode of the transformed map."""
    jparams, tparams, _, _ = setup
    rng = np.random.default_rng(5)
    c = 64 if target == "relu1_1" else 128
    f = rng.standard_normal((2, 8, 8, c)).astype(np.float32)
    m = (rng.standard_normal((2, c, c)) * 0.1).astype(np.float32)
    bias = (rng.standard_normal((2, c)) * 0.1).astype(np.float32)
    ref = np.asarray(jdec.decode_folded(jparams["decoders"][target], jnp.asarray(f), target,
                                        jnp.asarray(m), jnp.asarray(bias)))
    dp = tparams["decoders"][target]
    got = tdec.decode_folded(dp, torch.from_numpy(f), target, torch.from_numpy(m),
                             torch.from_numpy(bias)).numpy()
    transformed = np.einsum("bhwc,bcd->bhwd", f, m) + bias[:, None, None]
    unfolded = tdec.decode(dp, torch.from_numpy(transformed), target).numpy()
    scale = np.abs(ref).max()
    assert got.shape == ref.shape == (2, 8 * (c // 64), 8 * (c // 64), 3)
    assert np.abs(got - ref).max() <= 1e-5 * scale
    assert np.abs(got - unfolded).max() <= 1e-5 * scale


def test_decode_folded_diagonal_matches_reference(setup):
    """tests/test_models.py:358's diagonal (AdaIN) affine at relu1_1."""
    jparams, tparams, _, _ = setup
    rng = np.random.default_rng(6)
    f = rng.standard_normal((2, 8, 8, 64)).astype(np.float32)
    scale = (1.0 + 0.1 * rng.standard_normal((2, 64))).astype(np.float32)
    bias = (rng.standard_normal((2, 64)) * 0.1).astype(np.float32)
    ref = np.asarray(jdec.decode_folded(jparams["decoders"]["relu1_1"], jnp.asarray(f), "relu1_1",
                                        jnp.asarray(scale), jnp.asarray(bias)))
    got = tdec.decode_folded(tparams["decoders"]["relu1_1"], torch.from_numpy(f), "relu1_1",
                             torch.from_numpy(scale), torch.from_numpy(bias)).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


# ------------------------------------------------------------- cascade

LEVEL_CASES = [
    ("fold", dict(fold_transform=True), "relu2_1"),
    ("fold", dict(fold_transform=True), "relu1_1"),
    ("fold-adain", dict(fold_transform=True, transform="adain"), "relu2_1"),
    ("fold-adain", dict(fold_transform=True, transform="adain"), "relu1_1"),
    ("fold-groups2", dict(fold_transform=True, wct_groups=2), "relu2_1"),
    ("fold-groups2", dict(fold_transform=True, wct_groups=2), "relu1_1"),
    ("fold-swap5", dict(fold_transform=True, swap5=True), "relu5_1"),  # stays unfolded
    ("ring", dict(ring_conv=True), "relu5_1"),
    ("ring", dict(ring_conv=True), "relu4_1"),
    ("ring", dict(ring_conv=True), "relu3_1"),
    ("ring", dict(ring_conv=True), "relu2_1"),
    ("ring", dict(ring_conv=True), "relu1_1"),
    ("ring-adain", dict(ring_conv=True, transform="adain"), "relu1_1"),
    ("ring-groups2", dict(ring_conv=True, wct_groups=2), "relu2_1"),
    ("ring-swap5", dict(ring_conv=True, swap5=True), "relu5_1"),
    ("ring-compose_conv0", dict(ring_conv=True, compose_conv0=True), "relu1_1"),
    ("fold-ring", dict(fold_transform=True, ring_conv=True), "relu2_1"),
]


def _stylize_both(setup, kw, alpha=0.6, content=None, style=None):
    jparams, tparams, c0, s0 = setup
    content = c0 if content is None else content
    style = s0 if style is None else style
    kw = dict(kw, method=METHOD)
    ref = np.asarray(jcascade.stylize_pair(
        jparams, jnp.asarray(content), jnp.asarray(style), alpha, jcascade.CascadeConfig(**kw)))
    got = tcascade.stylize_pair(tparams, content, style, alpha, tcascade.CascadeConfig(**kw)).numpy()
    assert got.shape == ref.shape == content.shape
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    d = np.abs(got.astype(np.float64) - ref)
    return float(np.quantile(d, 0.99)), float(d.max())


@pytest.mark.parametrize("name,kw,level", LEVEL_CASES,
                         ids=[f"{n}-{lv}" for n, _, lv in LEVEL_CASES])
def test_each_level_with_fold_or_ring(setup, name, kw, level):
    q99, dmax = _stylize_both(setup, dict(kw, relu_targets=(level,)))
    assert q99 <= 1e-4, q99
    assert dmax <= 1e-3, dmax


@pytest.mark.parametrize("kw", [dict(fold_transform=True), dict(ring_conv=True)],
                         ids=["fold", "ring"])
def test_five_levels_with_fold_or_ring(setup, kw):
    q99, _ = _stylize_both(setup, kw)
    assert q99 <= 5e-3, q99


def test_ring_at_a_size_that_is_not_a_multiple(setup):
    """tests/test_models.py:765's 37 × 45 content: padded to the pool
    multiple, the strips spliced at shapes that are not multiples of 16."""
    rng = np.random.default_rng(3)
    content = rng.random((37, 45, 3)).astype(np.float32)
    style = rng.random((32, 32, 3)).astype(np.float32)
    q99, dmax = _stylize_both(setup, dict(relu_targets=("relu2_1", "relu1_1"), ring_conv=True),
                              0.7, content, style)
    assert q99 <= 1e-4 and dmax <= 1e-3, (q99, dmax)


def test_fold_changes_only_the_foldable_levels(setup, monkeypatch):
    """The five-level fold runs ``decode_folded_nchw`` at relu2_1 and
    relu1_1 only (C ≤ 128), as the reference folds."""
    _, tparams, content, style = setup
    seen = []
    real = tdec.decode_folded_nchw
    monkeypatch.setattr(tdec, "decode_folded_nchw",
                        lambda p, f, level, m, b: seen.append(level) or real(p, f, level, m, b))
    cfg = tcascade.CascadeConfig(fold_transform=True)
    tcascade.stylize_pair(tparams, content[:64, :64], style[:64, :64], 0.6, cfg)
    assert seen == ["relu2_1", "relu1_1"]


@pytest.fixture(scope="module")
def small_batch(setup):
    _, tparams, _, style = setup
    rng = np.random.default_rng(11)
    return tparams, rng.random((3, 64, 64, 3)).astype(np.float32), style[:64, :64]


def test_microbatched_fold_alone_equals_batch(small_batch):
    params, content, style = small_batch
    cfg = tcascade.CascadeConfig(fold_transform=True, relu_targets=("relu2_1", "relu1_1"))
    cache = tcascade.precompute_style(params["encoder"], style, cfg)
    batch = tcascade.stylize_microbatched(params, content, cache, 0.6, cfg, microbatch=2)
    for i in range(3):
        alone = tcascade.stylize_microbatched(params, content[i:i + 1], cache, 0.6, cfg, microbatch=2)
        assert torch.equal(alone[0], batch[i])


@pytest.mark.parametrize("kw", [dict(fold_transform=True), dict(ring_conv=True)],
                         ids=["fold", "ring"])
def test_stylize_sharded_mesh_of_one_is_stylize(small_batch, kw):
    params, content, style = small_batch
    cfg = tcascade.CascadeConfig(relu_targets=("relu3_1", "relu2_1", "relu1_1"), **kw)
    cache = tcascade.precompute_style(params["encoder"], style, cfg)
    mesh = tmesh.create_mesh(1, device="cpu")
    got = tmesh.stylize_sharded(params, content, cache, 0.6, cfg, mesh)
    assert torch.equal(got, tcascade.stylize(params, content, cache, 0.6, cfg))


@pytest.mark.parametrize("kw", [dict(fold_transform=True), dict(ring_conv=True)],
                         ids=["fold", "ring"])
def test_stylize_spatial_refuses_fold_and_ring(small_batch, kw):
    """``stylize_spatial`` carries both flags (ROADMAP.md item 11g): on two
    shards, over relu2_1 → relu1_1 (fold's levels), the output is the
    same call without the flag to q99 ≤ 5e-3, the card phase's bar, and
    max ≤ 1e-4 (measured max ≤ 1.6e-6: the same math, other sums; with
    ``eigh``, whose hard mask sits on a knife edge at relu2_1, the
    unsharded cascade's ring itself moves the output by 4.9e-4)."""
    params, content, style = small_batch
    cfg = tcascade.CascadeConfig(relu_targets=("relu2_1", "relu1_1"), method=METHOD)
    cache = tcascade.precompute_style(params["encoder"], style, cfg)
    mesh = tmesh.create_mesh(2, axis_name="sp", device="cpu")
    on = tmesh.stylize_spatial(params, content[:1], cache, 0.6,
                               dataclasses.replace(cfg, **kw), mesh)
    off = tmesh.stylize_spatial(params, content[:1], cache, 0.6, cfg, mesh)
    d = (on - off).abs().flatten()
    assert float(torch.quantile(d, 0.99)) <= 5e-3 and float(d.max()) <= 1e-4, float(d.max())
    roadmap = (Path(__file__).resolve().parent.parent / "ROADMAP.md").read_text()
    assert "**11g." in roadmap
