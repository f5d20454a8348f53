"""``pack2_junction`` in the port (``wct_tpu_torch/ops/pack2.py``) against ``wct_tpu``.

The ops of ``wct_tpu/ops/pack2.py`` on the trained bundle's weights and
seeded numpy inputs, NHWC through the JAX package and NCHW through the
port: f32 within 1e-5 of the reference's largest value, bf16 within
one bf16 ulp of ``|ref| + max|b|`` (cuDNN-style rounding of the f32 sum
before the bias, ``tests/test_torch_fold_ring.py``). Then the cascade
with each pack2 scope per level boundary on the trained bundle (DESIGN.md
§2b: two-level windows, the same input images for both packages), the
routing each scope takes, odd batches, and ``stylize_sharded``'s gate.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wct_tpu.models import cascade as jcascade
from wct_tpu.ops import pack2 as jpack2
from wct_tpu.parallel import mesh as jmesh
from wct_tpu.train import checkpoint as jck
from wct_tpu_torch.models import cascade as tcascade
from wct_tpu_torch.ops import pack2 as tpack2
from wct_tpu_torch.parallel import mesh as tmesh
from wct_tpu_torch.train import checkpoint as tck

BUNDLE = Path(__file__).resolve().parent.parent / "weights" / "bundle.npz"
METHOD = "newton_schulz"
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite runs in
    parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def weights():
    return jck.load_pytree(BUNDLE), tck.params_from_numpy(tck.load_pytree(BUNDLE), "cpu")


def _nchw(a: np.ndarray, dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).to(dtype)


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 2, 3, 1).numpy().astype(np.float64)


def _f64(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)


def _close(got: np.ndarray, ref: np.ndarray, dtype, bias) -> None:
    if dtype == torch.float32:
        err = np.abs(got - ref).max() / np.abs(ref).max()
        assert err <= 1e-5, err
    else:
        excess = np.abs(got - ref) - 2.0**-7 * (np.abs(ref) + float(np.abs(np.asarray(bias)).max()))
        assert (excess <= 0).all(), excess.max()


def _wb(tree, name):
    return tree[name]["w"], tree[name]["b"]


def _junction_args(jtree, ttree):
    """relu2_1's decoder tail (64→64, 64→3) and the encoder's head, per package."""
    def args(tree):
        dec, enc = tree["decoders"]["relu2_1"], tree["encoder"]
        return (*_wb(dec, "dec_conv1_2"), *_wb(dec, "dec_conv1_1"),
                *_wb(enc, "conv0"), *_wb(enc, "conv1_1"), *_wb(enc, "conv1_2"))
    return args(jtree), args(ttree)


# ------------------------------------------------------------------ ops


def test_pack_unpack_exact_and_the_references_pairing():
    """``pack`` is the reference's on the same images (NCHW channels =
    NHWC's last dim); ``unpack`` inverts it exactly."""
    x = np.random.default_rng(0).standard_normal((6, 5, 7, 4)).astype(np.float32)
    got = tpack2.pack(_nchw(x, torch.float32))
    assert got.shape == (3, 8, 5, 7)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(jpack2.pack(jnp.asarray(x))))
    assert torch.equal(tpack2.unpack(got), _nchw(x, torch.float32))


def test_blockdiag_is_the_references_in_oihw():
    w = np.random.default_rng(1).standard_normal((3, 3, 4, 5)).astype(np.float32)
    ref = np.asarray(jpack2._blockdiag(jnp.asarray(w))).transpose(3, 2, 0, 1)
    got = tpack2._blockdiag(torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("dtype,jdtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("deep", [True, False], ids=["deep", "shallow"])
@pytest.mark.parametrize("opts", [dict(), dict(compose_pre=True, clip=True), dict(ring=True)],
                         ids=["plain", "compose_clip", "ring"])
def test_junction_pack2_matches_reference(weights, dtype, jdtype, deep, opts):
    """Measured: f32 ≤ 4.3e-6 of max|ref|; bf16 within one ulp everywhere."""
    jtree, ttree = weights
    d = np.abs(np.random.default_rng(2).standard_normal((4, 12, 16, 64))).astype(np.float32)
    ja, ta = _junction_args(jtree, ttree)
    ref = _f64(jpack2.junction_pack2(jnp.asarray(d, jdtype), *ja, deep=deep, **opts))
    got = tpack2.junction_pack2(_nchw(d, dtype), *ta, deep=deep, **opts)
    assert got.dtype == dtype
    _close(_nhwc(got), ref, dtype, ta[-1] if deep else ta[-3])


def test_junction_pack2_kept_packed_is_the_references_layout(weights):
    jtree, ttree = weights
    d = np.abs(np.random.default_rng(3).standard_normal((2, 8, 8, 64))).astype(np.float32)
    ja, ta = _junction_args(jtree, ttree)
    ref = _f64(jpack2.junction_pack2(jnp.asarray(d), *ja, deep=False, unpack_out=False))
    got = tpack2.junction_pack2(_nchw(d, torch.float32), *ta, deep=False, unpack_out=False)
    assert got.shape == (1, 128, 16, 16)
    _close(_nhwc(got), ref, torch.float32, None)


@pytest.mark.parametrize("dtype,jdtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("compose", [False, True], ids=["conv0", "composed"])
def test_heads_match_reference(weights, dtype, jdtype, compose):
    """``head_pack2`` (→ post-pool1) and ``head_pack2_shallow`` (→ packed
    relu1_1). Measured f32 ≤ 7.6e-7 of max|ref|."""
    jtree, ttree = weights
    img = np.random.default_rng(4).random((4, 24, 16, 3)).astype(np.float32)
    jenc, tenc = jtree["encoder"], ttree["encoder"]
    names = ("conv0", "conv1_1", "conv1_2")
    jargs = [t for n in names for t in _wb(jenc, n)]
    targs = [t for n in names for t in _wb(tenc, n)]
    ref = _f64(jpack2.head_pack2(jnp.asarray(img, jdtype), *jargs, compose_pre=compose))
    got = tpack2.head_pack2(_nchw(img, dtype), *targs, compose_pre=compose)
    _close(_nhwc(got), ref, dtype, targs[5])
    ref = _f64(jpack2.head_pack2_shallow(jnp.asarray(img, jdtype), *jargs[:4], compose_pre=compose))
    got = tpack2.head_pack2_shallow(_nchw(img, dtype), *targs[:4], compose_pre=compose)
    assert got.shape == (2, 128, 24, 16)
    _close(_nhwc(got), ref, dtype, targs[3])


def test_pair_gram_is_the_references_diagonal_blocks():
    """Each image's covariance and mean, f32: the diagonal blocks of the
    reference's ``[128, 128]`` pair Gram (measured ≤ 2e-7 of max|ref|)."""
    x = np.abs(np.random.default_rng(5).standard_normal((6, 10, 12, 128))).astype(np.float32)
    cov, mean = tpack2._pair_gram(_nchw(x, torch.float32))
    assert cov.shape == (6, 2, 64, 64) and mean.shape == (6, 128)
    for j in range(6):
        rc, rm = (np.asarray(a, np.float64) for a in jpack2._pair_gram(jnp.asarray(x[j].reshape(-1, 128))))
        for h in (0, 1):
            block = rc[h * 64:(h + 1) * 64, h * 64:(h + 1) * 64]
            assert np.abs(cov[j, h].numpy() - block).max() <= 1e-6 * np.abs(block).max()
        assert np.abs(mean[j].numpy() - rm).max() <= 1e-6 * np.abs(rm).max()


@pytest.mark.parametrize("dtype,jdtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("transform", ["wct", "adain"])
def test_tail_pack2_matches_reference(weights, dtype, jdtype, transform):
    """The packed relu1_1 level on the reference's own packed relu1_1
    features and the style statistics of each package. The bf16 route's
    covariance is the centred Gram here and the uncentred one there
    (module docstring), so its bar is the ulp bar on the RGB. Measured
    f32 ≤ 5.3e-7 of max|ref|."""
    jtree, ttree = weights
    rng = np.random.default_rng(6)
    img = rng.random((4, 32, 32, 3)).astype(np.float32)
    style = rng.random((32, 32, 3)).astype(np.float32)
    kw = dict(relu_targets=("relu1_1",), method=METHOD, transform=transform,
              compute_dtype="float32" if dtype == torch.float32 else "bfloat16")
    jstyle = jcascade.precompute_style(jtree["encoder"], jnp.asarray(style),
                                       jcascade.CascadeConfig(**kw))["relu1_1"]
    tstyle = tcascade.precompute_style(ttree["encoder"], style,
                                       tcascade.CascadeConfig(**kw))["relu1_1"]
    jenc = jtree["encoder"]
    e1p = jpack2.head_pack2_shallow(jnp.asarray(img, jdtype), *_wb(jenc, "conv0"), *_wb(jenc, "conv1_1"))
    jdec = jtree["decoders"]["relu1_1"]["dec_conv1_1"]
    tdec = ttree["decoders"]["relu1_1"]["dec_conv1_1"]
    ref = _f64(jpack2.tail_pack2(e1p, jstyle.stats, 0.6, jdec["w"], jdec["b"], transform=transform,
                                 adain_stats=jstyle.adain, method=METHOD))
    got = tpack2.tail_pack2(_nchw(_f64(e1p).astype(np.float32), dtype), tstyle.stats, 0.6,
                            tdec["w"], tdec["b"], transform=transform, adain_stats=tstyle.adain,
                            method=METHOD)
    assert got.shape == (4, 3, 32, 32)
    _close(_nhwc(got), ref, dtype, tdec["b"])


# -------------------------------------------------------------- cascade

SCOPES = {"pack2": dict(pack2_junction=True),
          "tail_only": dict(pack2_junction=True, pack2_tail_only=True),
          "junction_only": dict(pack2_junction=True, pack2_junction_only=True)}
WINDOWS = [("relu4_1", "relu3_1"), ("relu2_1", "relu1_1")]


@pytest.fixture
def routed(monkeypatch):
    """Counts the calls the cascade makes into ``ops/pack2.py``."""
    calls = {n: 0 for n in ("head_pack2", "head_pack2_shallow", "junction_pack2", "tail_pack2")}
    for name in calls:
        fn = getattr(tpack2, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(tpack2, name, counted)
    return calls


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(9)
    return rng.random((2, 64, 64, 3)).astype(np.float32), rng.random((64, 64, 3)).astype(np.float32)


EXPECTED_ROUTES = {
    ("pack2", WINDOWS[0]): dict(head_pack2=1, junction_pack2=1),
    ("pack2", WINDOWS[1]): dict(head_pack2=1, junction_pack2=1, tail_pack2=1),
    ("tail_only", WINDOWS[0]): dict(),
    ("tail_only", WINDOWS[1]): dict(head_pack2_shallow=1, tail_pack2=1),
    ("junction_only", WINDOWS[0]): dict(head_pack2=1, junction_pack2=1),
    ("junction_only", WINDOWS[1]): dict(head_pack2=1, junction_pack2=1),
}


@pytest.mark.parametrize("window", WINDOWS, ids=lambda w: "-".join(w))
@pytest.mark.parametrize("scope", list(SCOPES))
def test_cascade_scope_per_level_boundary(weights, images, routed, scope, window):
    """Two levels of the trained bundle with one pack2 scope, batch 2 at
    64 px, α = 0.6, the same images into both packages: the bounds of
    ``tests/test_torch_cascade.py``'s per-level options, q99 ≤ 1e-4 and
    max ≤ 1e-3 (measured q99 ≤ 1.1e-6, max ≤ 1.2e-5). The port takes the
    route the reference's gates give each scope."""
    jtree, ttree = weights
    content, style = images
    kw = dict(relu_targets=window, method=METHOD, **SCOPES[scope])
    jcfg, tcfg = jcascade.CascadeConfig(**kw), tcascade.CascadeConfig(**kw)
    jcache = jcascade.precompute_style(jtree["encoder"], jnp.asarray(style), jcfg)
    ref = np.asarray(jcascade.stylize(jtree, jnp.asarray(content), jcache, 0.6, jcfg), np.float64)
    tcache = tcascade.precompute_style(ttree["encoder"], style, tcfg)
    got = tcascade.stylize(ttree, content, tcache, 0.6, tcfg).numpy()
    d = np.abs(got - ref)
    assert np.quantile(d, 0.99) <= 1e-4 and d.max() <= 1e-3, (np.quantile(d, 0.99), d.max())
    want = {n: 0 for n in routed} | EXPECTED_ROUTES[(scope, window)]
    assert routed == want


def test_bf16_throughput_pack2_per_level_boundary(weights, images):
    """The bf16 throughput configuration with pack2 over relu2_1 → relu1_1:
    ``tests/test_torch_throughput.py``'s bf16 bars, q99 ≤ 2e-2 and
    median ≤ 4e-3 (measured q99 7.8e-3, median 0)."""
    jtree, ttree = weights
    content, style = images
    kw = dict(relu_targets=WINDOWS[1], compute_dtype="bfloat16", method="newton_schulz_fast",
              compose_conv0=True, pack2_junction=True)
    jcfg, tcfg = jcascade.CascadeConfig(**kw), tcascade.CascadeConfig(**kw)
    jcache = jcascade.precompute_style(jtree["encoder"], jnp.asarray(style), jcfg)
    ref = _f64(jcascade.stylize(jtree, jnp.asarray(content), jcache, 0.6, jcfg))
    tcache = tcascade.precompute_style(ttree["encoder"], style, tcfg)
    got = tcascade.stylize(ttree, content, tcache, 0.6, tcfg)
    assert got.dtype == torch.float32
    d = np.abs(got.numpy() - ref)
    assert np.quantile(d, 0.99) <= 2e-2 and np.median(d) <= 4e-3, (np.quantile(d, 0.99), np.median(d))


@pytest.mark.parametrize("scope", list(SCOPES))
def test_odd_batch_is_pack2_off_bitwise(weights, images, routed, scope):
    """The reference's ``b % 2`` gate: three images take the unpacked path,
    the same bits as the config without pack2, and call nothing of pack2."""
    _, ttree = weights
    content, style = images
    x = np.concatenate([content, content[:1, ::-1]])
    cfg = tcascade.CascadeConfig(relu_targets=WINDOWS[1], method=METHOD)
    cache = tcascade.precompute_style(ttree["encoder"], style, cfg)
    on = tcascade.stylize(ttree, x, cache, 0.6, dataclasses.replace(cfg, **SCOPES[scope]))
    assert torch.equal(on, tcascade.stylize(ttree, x, cache, 0.6, cfg))
    assert not any(routed.values())


def test_grouped_wct_keeps_the_unpacked_tail(weights, images, routed):
    """``wct_groups > 1``: the packed tail's gate is off, the junction
    still packs and hands over unpacked relu1_1 features."""
    _, ttree = weights
    content, style = images
    cfg = tcascade.CascadeConfig(relu_targets=WINDOWS[1], method=METHOD, wct_groups=2,
                                 pack2_junction=True)
    cache = tcascade.precompute_style(ttree["encoder"], style, cfg)
    out = tcascade.stylize(ttree, content, cache, 0.6, cfg)
    plain = tcascade.stylize(ttree, content, cache, 0.6,
                             dataclasses.replace(cfg, pack2_junction=False))
    assert routed == dict(head_pack2=1, head_pack2_shallow=0, junction_pack2=1, tail_pack2=0)
    assert (out - plain).abs().max() <= 1e-5


def test_microbatched_pack2_alone_equals_batch(weights, images):
    """``stylize_microbatched`` pads to its microbatch, so an image alone
    is the same bits as in the batch."""
    _, ttree = weights
    content, style = images
    cfg = tcascade.CascadeConfig(relu_targets=WINDOWS[1], method=METHOD, pack2_junction=True)
    cache = tcascade.precompute_style(ttree["encoder"], style, cfg)
    batch = tcascade.stylize_microbatched(ttree, content, cache, 0.6, cfg, microbatch=2)
    alone = tcascade.stylize_microbatched(ttree, content[1:], cache, 0.6, cfg, microbatch=2)
    assert torch.equal(alone[0], batch[1])


# ------------------------------------------------------------------ mesh


@pytest.mark.parametrize("n,b,packs", [(2, 4, True), (4, 4, False), (4, 6, False)],
                         ids=["local_pairs", "local_singles", "fallback"])
def test_stylize_sharded_pack2_gate(weights, images, routed, n, b, packs):
    """The reference's rule (``wct_tpu/parallel/mesh.py:118-139``,
    ``tests/test_mesh.py:242-275``): when the batch divides the mesh each
    shard keeps pack2 and gates on its own batch (4 on 2 shards packs,
    4 on 4 does not); 6 on 4 shards runs pack2 off everywhere. Each
    shard's output is ``stylize`` of its images under the shard's
    config, bitwise."""
    _, ttree = weights
    content, style = images
    x = np.concatenate([content, content[:, ::-1], content[:, :, ::-1]])[:b]
    cfg = tcascade.CascadeConfig(relu_targets=WINDOWS[1], method=METHOD, pack2_junction=True,
                                 pack2_tail_only=True)
    cache = tcascade.precompute_style(ttree["encoder"], style, cfg)
    mesh = tmesh.create_mesh(n, device="cpu")
    out = tmesh.stylize_sharded(ttree, x, cache, 0.6, cfg, mesh)
    assert routed["tail_pack2"] == (n if packs else 0)
    off = dataclasses.replace(cfg, pack2_junction=False, pack2_tail_only=False)
    shard_cfg = cfg if b % n == 0 else off
    start = 0
    for s in tmesh.shard_batch(x, mesh).shards:
        ref = tcascade.stylize(ttree, s, cache, 0.6, shard_cfg)
        assert torch.equal(out[start:start + len(s)], ref)
        start += len(s)


def test_stylize_sharded_pack2_matches_reference(weights, images):
    """Four images on two shards, each packing its pair, against
    ``wct_tpu.parallel.stylize_sharded`` under ``shard_map`` on the
    conftest's virtual devices: the window bounds above (measured q99
    1.1e-6, max 9.5e-6)."""
    jtree, ttree = weights
    content, style = images
    x = np.concatenate([content, content[:, ::-1]])
    kw = dict(relu_targets=WINDOWS[1], method=METHOD, pack2_junction=True)
    jcfg, tcfg = jcascade.CascadeConfig(**kw), tcascade.CascadeConfig(**kw)
    jcache = jcascade.precompute_style(jtree["encoder"], jnp.asarray(style), jcfg)
    jm = jmesh.create_mesh(2)
    ref = np.asarray(jmesh.stylize_sharded(jtree, jmesh.shard_batch(jnp.asarray(x), jm), jcache,
                                           0.6, jcfg, jm), np.float64)
    tcache = tcascade.precompute_style(ttree["encoder"], style, tcfg)
    got = tmesh.stylize_sharded(ttree, x, tcache, 0.6, tcfg, tmesh.create_mesh(2, device="cpu"))
    d = np.abs(got.numpy() - ref)
    assert np.quantile(d, 0.99) <= 1e-4 and d.max() <= 1e-3, (np.quantile(d, 0.99), d.max())


def test_stylize_spatial_odd_batch_with_pack2_is_the_call_without(weights, images):
    """One image: the reference's gate leaves pack2 off, and so does the
    port's height-sharded path, the same bits as the call without it."""
    _, ttree = weights
    content, style = images
    cfg = tcascade.CascadeConfig(relu_targets=WINDOWS[1], method=METHOD)
    cache = tcascade.precompute_style(ttree["encoder"], style, cfg)
    mesh = tmesh.create_mesh(2, axis_name="sp", device="cpu")
    on = tmesh.stylize_spatial(ttree, content[:1], cache, 0.6,
                               dataclasses.replace(cfg, pack2_junction=True), mesh)
    assert torch.equal(on, tmesh.stylize_spatial(ttree, content[:1], cache, 0.6, cfg, mesh))
