"""``pack2_junction`` on an even batch in the port's ``stylize_spatial``.

The reference's height-sharded cascade jits ``stylize_fn`` under GSPMD
with every flag but ``fuse_junction`` (``wct_tpu/parallel/mesh.py:104-116``),
so its pack2 gates (``wct_tpu/models/cascade.py:477-566``) pack the
64-channel tier of an even batch. Held here, on two 32 × 48 images and
the trained bundle, against the reference's ``stylize_spatial`` on the
four virtual CPU devices ``tests/conftest.py`` gives JAX, against the
port's unsharded cascade with the same config and against the port's
own call without pack2; then the layers the spatial walk packs, by the
weight shapes of every conv it runs, against those the unsharded cascade
runs.
"""

import collections
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wct_tpu.models import cascade as jcascade
from wct_tpu.parallel import mesh as jmesh
from wct_tpu.train import checkpoint as jck
from wct_tpu_torch.models import cascade as tcascade
from wct_tpu_torch.ops import convs as tconvs
from wct_tpu_torch.parallel import mesh as tmesh
from wct_tpu_torch.train import checkpoint as tck

BUNDLE = Path(__file__).resolve().parent.parent / "weights" / "bundle.npz"
TARGETS = ("relu3_1", "relu2_1", "relu1_1")
METHOD = "newton_schulz"
PACK2 = dict(pack2_junction=True)
CASES = [PACK2, dict(PACK2, pack2_tail_only=True), dict(PACK2, pack2_junction_only=True),
         dict(PACK2, ring_conv=True, compose_conv0=True, clip_between_levels=True)]
CASE_IDS = ["pack2", "tail_only", "junction_only", "ring_compose_clip"]
OFF = dict(pack2_junction=False, pack2_tail_only=False, pack2_junction_only=False)


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
    rng = np.random.default_rng(13)
    content = rng.random((2, 32, 48, 3)).astype(np.float32)
    style = rng.random((64, 64, 3)).astype(np.float32)
    return jck.load_pytree(BUNDLE), tck.params_from_numpy(tck.load_pytree(BUNDLE), "cpu"), content, style


def _cache(setup, cfg):
    _, params, _, style = setup
    return tcascade.precompute_style(params["encoder"], style, cfg)


def _spatial(setup, cfg, x, n=4, cache=None):
    mesh = tmesh.create_mesh(n, axis_name="sp", device="cpu")
    return tmesh.stylize_spatial(setup[1], x, cache or _cache(setup, cfg), 0.6, cfg, mesh)


def _unsharded(setup, cfg, x, cache=None):
    return tcascade.stylize(setup[1], x, cache or _cache(setup, cfg), 0.6, cfg)


def _reference_spatial(setup, kw, x):
    tree, _, _, style = setup
    jcfg = jcascade.CascadeConfig(**kw)
    jcache = jcascade.precompute_style(tree["encoder"], jnp.asarray(style), jcfg)
    jm = jmesh.create_mesh(4, axis_name="sp")
    return np.asarray(jmesh.stylize_spatial(tree, jmesh.shard_spatial(jnp.asarray(x), jm, "sp"),
                                            jcache, 0.6, jcfg, jm), np.float64)


@pytest.mark.parametrize("kw", CASES + [dict(PACK2, transform="adain")],
                         ids=CASE_IDS + ["adain"])
def test_spatial_pack2_matches_reference_spatial(setup, kw):
    """Two 32 × 48 images, three levels, four shards in both packages:
    max ≤ 1e-4, the bound the reference meets against its own call
    without pack2 (measured ≤ 6.0e-5; the reference's own pack2 on and
    off ≤ 5.2e-5 apart)."""
    _, _, content, _ = setup
    kw = dict(relu_targets=TARGETS, method=METHOD, **kw)
    got = _spatial(setup, tcascade.CascadeConfig(**kw), content)
    ref = _reference_spatial(setup, kw, content)
    assert got.shape == ref.shape == (2, 32, 48, 3)
    assert np.abs(got.numpy() - ref).max() <= 1e-4


@pytest.mark.parametrize("kw", CASES, ids=CASE_IDS)
def test_spatial_pack2_against_the_call_without_it(setup, kw):
    """The same four-shard call with pack2 off: max ≤ 1e-4 (measured ≤
    6.1e-5). pack2 sums the convs in another order, and three levels of
    whitening a rank-deficient covariance (relu3_1 at 8 × 12) amplify
    that rounding."""
    _, _, content, _ = setup
    cfg = tcascade.CascadeConfig(relu_targets=TARGETS, method=METHOD, **kw)
    on = _spatial(setup, cfg, content)
    off = _spatial(setup, dataclasses.replace(cfg, **OFF), content)
    assert torch.isfinite(on).all()
    assert float((on - off).abs().max()) <= 1e-4


@pytest.mark.parametrize("kw", CASES, ids=CASE_IDS)
def test_spatial_pack2_against_the_unsharded_cascade(setup, kw):
    """On a mesh of one entry the walk is the unsharded cascade with the
    same config, bitwise: the same layers packed, in the same order. On
    four shards, each two-level window (a packed junction and the level
    after it), teacher-forced on the unsharded cascade's running image
    (DESIGN.md §2b): max ≤ 1e-4 (measured ≤ 4.6e-5). The whole
    three-level cascade composes that noise: 1.2e-4 with full pack2,
    where pack2 off reads 5.6e-5 from its own unsharded cascade."""
    _, _, content, _ = setup
    cfg = tcascade.CascadeConfig(relu_targets=TARGETS, method=METHOD, **kw)
    assert torch.equal(_spatial(setup, cfg, content, n=1), _unsharded(setup, cfg, content))
    x = torch.from_numpy(content)
    for window in (TARGETS[:2], TARGETS[1:]):
        one = dataclasses.replace(cfg, relu_targets=window)
        ref = _unsharded(setup, one, x)
        assert float((_spatial(setup, one, x) - ref).abs().max()) <= 1e-4, window
        x = _unsharded(setup, dataclasses.replace(cfg, relu_targets=window[:1]), x)


def test_spatial_pack2_adain_and_bf16(setup):
    """AdaIN on four shards against the unsharded cascade and the call
    without pack2: max ≤ 1e-4 each (measured 1.7e-6, 2.4e-6). The bf16 throughput route with pack2
    over relu2_1 → relu1_1 against the unsharded cascade:
    ``tests/test_torch_mesh.py``'s bf16 bars, q99 ≤ 1e-2 and median ≤ 1e-3
    (measured q99 7.8e-3, median 0, the same as with pack2 off; over three
    levels a bf16 chain reaches q99 3.9e-2, pack2 on or off)."""
    _, _, content, _ = setup
    cfg = tcascade.CascadeConfig(relu_targets=TARGETS, method=METHOD, transform="adain", **PACK2)
    on = _spatial(setup, cfg, content)
    assert float((on - _unsharded(setup, cfg, content)).abs().max()) <= 1e-4
    assert float((on - _spatial(setup, dataclasses.replace(cfg, **OFF), content)).abs().max()) <= 1e-4
    cfg = tcascade.CascadeConfig(relu_targets=TARGETS[1:], compute_dtype="bfloat16",
                                 method="newton_schulz_fast", compose_conv0=True, **PACK2)
    got = _spatial(setup, cfg, content)
    assert got.dtype == torch.float32
    d = (got - _unsharded(setup, cfg, content)).abs().flatten()
    assert float(torch.quantile(d, 0.99)) <= 1e-2 and float(d.median()) <= 1e-3


# ------------------------------------------------------------------ gates

GATE_CASES = {"off": dict(), "pack2": PACK2, "tail_only": CASES[1], "junction_only": CASES[2],
              "groups4": dict(PACK2, wct_groups=4), "odd_batch": PACK2}


@pytest.fixture
def conv_shapes(monkeypatch):
    """Records ``[Co, Ci, k, k]`` of every conv run, the cascade's (through
    ``convs.conv2d_valid_nchw``, which ``conv2d_reflect_nchw`` calls) and
    ``stylize_spatial``'s (``mesh``'s own binding of it, for its halo
    convs, and ``conv2d_reflect_nchw`` for its 1×1 ones)."""
    shapes = []
    plain = tconvs.conv2d_valid_nchw

    def recorded(x, w, b):
        shapes.append(tuple(w.shape))
        return plain(x, w, b)

    monkeypatch.setattr(tconvs, "conv2d_valid_nchw", recorded)
    monkeypatch.setattr(tmesh, "conv2d_valid_nchw", recorded)
    return shapes


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_spatial_walk_packs_the_layers_the_cascade_packs(setup, conv_shapes, case):
    """Two images of 32 × 32 on four shards, so every shard holds rows at
    every level, ring and swap off: the multiset of conv weight shapes the
    spatial walk runs, divided by the shard count, is the unsharded
    cascade's with the same config: with pack2 off (the two walks run the
    same layers), in each scope, with ``wct_groups=4`` (packed junctions,
    the tail unpacked) and for an odd batch (nothing packed)."""
    _, _, content, _ = setup
    x = content[:1 if case == "odd_batch" else 2, :, :32]
    cfg = tcascade.CascadeConfig(relu_targets=TARGETS, method=METHOD, **GATE_CASES[case])
    cache = _cache(setup, cfg)
    conv_shapes.clear()
    _spatial(setup, cfg, x, cache=cache)
    spatial = collections.Counter(conv_shapes)
    conv_shapes.clear()
    _unsharded(setup, cfg, x, cache=cache)
    cascade = collections.Counter(conv_shapes)
    assert spatial == collections.Counter({k: 4 * v for k, v in cascade.items()})
    # A packed RGB side (6 channels) marks a packed conv0, conv1_1 or 64→3.
    packed = any(6 in shape[:2] for shape in cascade)
    plan = tmesh.pack2_plan(cfg, len(x))
    assert packed == any(plan.encoder + plan.decoder + plan.tail)


Y, N = True, False
PLANS = [
    (TARGETS, PACK2, 2, ((Y, Y, Y), (Y, Y, N), (N, N, Y))),
    (TARGETS, CASES[1], 2, ((N, N, Y), (N, N, N), (N, N, Y))),
    (TARGETS, CASES[2], 2, ((Y, Y, Y), (Y, Y, N), (N, N, N))),
    (TARGETS, dict(PACK2, wct_groups=4), 4, ((Y, Y, Y), (Y, Y, N), (N, N, N))),
    (TARGETS, PACK2, 3, ((N, N, N), (N, N, N), (N, N, N))),
    (("relu1_1", "relu2_1"), PACK2, 2, ((Y, Y), (N, N), (Y, N))),
    (("relu5_1", "relu1_1"), dict(PACK2, swap5=True), 2, ((Y, Y), (Y, N), (N, Y))),
]


@pytest.mark.parametrize("targets,kw,batch,want", PLANS,
                         ids=["pack2", "tail_only", "junction_only", "groups4", "odd", "tail_first",
                              "swap5"])
def test_pack2_plan_follows_the_cascades_gates(targets, kw, batch, want):
    """``pack2_plan`` per level: the encoder's full-resolution tier packs
    above relu1_1 unless the scope is the tail alone, and at relu1_1 where
    the packed tail takes it or a packed junction made it; a decoder's
    last tier packs where a next level follows; the tail needs ungrouped
    WCT and is off under ``pack2_junction_only``; an odd batch packs
    nothing."""
    plan = tmesh.pack2_plan(tcascade.CascadeConfig(relu_targets=targets, **kw), batch)
    assert (plan.encoder, plan.decoder, plan.tail) == want
