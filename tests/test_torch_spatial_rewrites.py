"""``fold_transform`` and ``ring_conv`` in the port's ``stylize_spatial``.

The reference's height-sharded cascade jits ``stylize_fn`` under GSPMD
with every flag but ``fuse_junction`` (``wct_tpu/parallel/mesh.py:104-116``),
so it runs the fold and the ring. Held here, on 32-px and 64-px images
and the trained bundle, against the reference's ``stylize_spatial`` on
the four virtual CPU devices ``tests/conftest.py`` gives JAX, against the
port's unsharded cascade with the same flag, and against the port's own
call without the flag; and the ring's band conv against the ring conv
on the whole map. Last, whether the fold's direct ``stylize`` depends
on the submitted batch in the reference as in the port.
"""

import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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
FLAGS = [dict(fold_transform=True), dict(ring_conv=True),
         dict(fold_transform=True, transform="adain"),
         dict(ring_conv=True, compose_conv0=True, clip_between_levels=True)]
FLAG_IDS = ["fold", "ring", "fold_adain", "ring_compose_clip"]


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
    content = rng.random((4, 64, 64, 3)).astype(np.float32)
    style = rng.random((64, 64, 3)).astype(np.float32)
    return jck.load_pytree(BUNDLE), tck.params_from_numpy(tck.load_pytree(BUNDLE), "cpu"), content, style


def _port(setup, cfg, x, alpha=0.6, n=4):
    _, params, _, style = setup
    cache = tcascade.precompute_style(params["encoder"], style, cfg)
    mesh = tmesh.create_mesh(n, axis_name="sp", device="cpu")
    return (tmesh.stylize_spatial(params, x, cache, alpha, cfg, mesh),
            tcascade.stylize(params, x, cache, alpha, cfg))


@pytest.mark.parametrize("kw", FLAGS, ids=FLAG_IDS)
def test_spatial_rewrite_matches_reference_spatial(setup, kw):
    """One 32 × 48 image, three levels, on four shards in both packages:
    the bound of ``tests/test_torch_mesh.py``'s spatial cascade, max ≤ 1e-4
    (measured ≤ 2.6e-6). Against the port's unsharded cascade with the
    same flag: max ≤ 1e-4 (measured ≤ 1.8e-6)."""
    tree, _, content, style = setup
    x = content[:1, :32, :48]
    kw = dict(relu_targets=TARGETS, method=METHOD, **kw)
    got, unsharded = _port(setup, tcascade.CascadeConfig(**kw), x)
    jcfg = jcascade.CascadeConfig(**kw)
    jcache = jcascade.precompute_style(tree["encoder"], jnp.asarray(style), jcfg)
    jm = jmesh.create_mesh(4, axis_name="sp")
    ref = np.asarray(jmesh.stylize_spatial(tree, jmesh.shard_spatial(jnp.asarray(x), jm, "sp"),
                                           jcache, 0.6, jcfg, jm), np.float64)
    assert got.shape == ref.shape == (1, 32, 48, 3)
    assert np.abs(got.numpy() - ref).max() <= 1e-4
    assert float((got - unsharded).abs().max()) <= 1e-4


@pytest.mark.parametrize("kw", FLAGS, ids=FLAG_IDS)
def test_spatial_rewrite_against_the_call_without_it(setup, kw):
    """Two images at 64 px on four shards: the flag moves the output by
    the rounding of the same math, max ≤ 1e-4 (measured ≤ 2.1e-6)."""
    _, params, content, style = setup
    cfg = tcascade.CascadeConfig(relu_targets=TARGETS, method=METHOD, **kw)
    cache = tcascade.precompute_style(params["encoder"], style, cfg)
    mesh = tmesh.create_mesh(4, axis_name="sp", device="cpu")
    on = tmesh.stylize_spatial(params, content[:2], cache, 0.6, cfg, mesh)
    off = tmesh.stylize_spatial(params, content[:2], cache, 0.6, dataclasses.replace(
        cfg, fold_transform=False, ring_conv=False), mesh)
    assert float((on - off).abs().max()) <= 1e-4


def test_spatial_fold_grouped_and_bf16(setup):
    """The fold with ``wct_groups=4`` (block affines expanded to the dense
    fold) in f32 against the unsharded cascade, max ≤ 1e-4. The bf16
    throughput route with both flags over relu2_1 → relu1_1, where a bf16
    chain flips single roundings: q99 ≤ 1e-2 and median ≤ 4e-3, one bf16
    ulp in [0.5, 1) (measured q99 7.8e-3, median 0; without either flag
    the same q99, median 2.0e-3; over three levels both reach q99 ≈ 0.05,
    the flags or not)."""
    _, _, content, _ = setup
    x = content[:1, :32, :32]
    got, ref = _port(setup, tcascade.CascadeConfig(
        relu_targets=TARGETS, method=METHOD, fold_transform=True, wct_groups=4), x)
    assert float((got - ref).abs().max()) <= 1e-4
    got, ref = _port(setup, tcascade.CascadeConfig(
        relu_targets=TARGETS[1:], method="newton_schulz_fast", compute_dtype="bfloat16",
        compose_conv0=True, fold_transform=True, ring_conv=True), x)
    d = (got - ref).abs().flatten()
    assert float(torch.quantile(d, 0.99)) <= 1e-2 and float(d.median()) <= 4e-3


@pytest.mark.parametrize("rows", [[8, 8, 8, 8], [1, 1, 3, 5], [2, 30]], ids=["even", "thin", "two"])
def test_ring_rows_is_the_ring_conv_on_the_whole_map(rows):
    """Bands of a 32 × 20 map with their halo rows (the neighbours', or the
    reflected ones at the image's edges, as ``_halo_conv`` builds them)
    give the ring conv of the whole map, and so the reflect conv: ≤ 1e-5
    of the map's max (measured ≤ 4e-7)."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 6, sum(rows), 20)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((5, 6, 3, 3)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(5).astype(np.float32))
    full = tconvs.conv2d_reflect_nchw(x, w, b)
    padded = F.pad(x, (0, 0, 1, 1), mode="reflect")
    out, start = [], 0
    for i, r in enumerate(rows):
        band = padded[:, :, start:start + r + 2]
        out.append(tconvs.conv2d_ring_rows_nchw(band, w, b, top_edge=i == 0,
                                                bottom_edge=i == len(rows) - 1))
        start += r
    got = torch.cat(out, dim=2)
    ring = tconvs.conv2d_reflect_ring_nchw(x, w, b)
    scale = float(full.abs().max())
    assert float((got - ring).abs().max()) <= 1e-5 * scale
    assert float((got - full).abs().max()) <= 1e-5 * scale


def test_fold_batch_dependence_is_shared_with_the_reference(setup):
    """``fold_transform=True`` over relu2_1 → relu1_1 at 64 px: image 0
    alone (B = 1) against the same image in a batch of four (B = 4), in
    each package.

    Measured on the CPU: f32, the reference 1.2e-6 (its grouped conv,
    ``batch_group_count=B``, is another XLA program per B) and the port
    1.5e-6 (the port moves by as much without the fold: the CPU conv's
    blocking follows the batch); bf16, the reference 7.8e-3 (one bf16
    ulp at relu1_1) and the port 0. So the reference's fold is no more
    batch-independent than the port's: a shared property of direct
    ``stylize``, which ``stylize_microbatched`` removes. Bars: f32 ≤ 1e-5
    and bf16 ≤ 2⁻⁶ in both packages, and the two packages within the
    per-level bars at B = 4."""
    tree, params, content, style = setup
    gaps = {}
    for dtype, kw in (("f32", dict(method=METHOD)),
                      ("bf16", dict(method="newton_schulz_fast", compute_dtype="bfloat16",
                                    compose_conv0=True))):
        kw = dict(relu_targets=("relu2_1", "relu1_1"), fold_transform=True, **kw)
        jcfg, tcfg = jcascade.CascadeConfig(**kw), tcascade.CascadeConfig(**kw)
        jcache = jcascade.precompute_style(tree["encoder"], jnp.asarray(style), jcfg)
        j4, j1 = (np.asarray(jcascade.stylize(tree, jnp.asarray(content[:b]), jcache, 0.6, jcfg)
                             .astype(jnp.float32)) for b in (4, 1))
        tcache = tcascade.precompute_style(params["encoder"], style, tcfg)
        t4, t1 = (tcascade.stylize(params, content[:b], tcache, 0.6, tcfg).numpy()
                  for b in (4, 1))
        gaps[dtype] = (float(np.abs(j1[0] - j4[0]).max()), float(np.abs(t1[0] - t4[0]).max()))
        d = np.abs(t4.astype(np.float64) - j4)
        if dtype == "f32":
            assert np.quantile(d, 0.99) <= 1e-4 and d.max() <= 1e-3
        else:
            assert np.quantile(d, 0.99) <= 2e-2 and np.median(d) <= 4e-3
    assert max(gaps["f32"]) <= 1e-5, gaps
    assert max(gaps["bf16"]) <= 2.0**-6, gaps
