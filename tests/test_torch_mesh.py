"""The port's mesh module (``wct_tpu_torch.parallel``) on CPU meshes.

Data-parallel and height-sharded stylization against the port's own
unsharded cascade and against ``wct_tpu.parallel`` on the 8 virtual CPU
devices ``tests/conftest.py`` gives JAX. 32-px images, the two shallow
levels as in ``tests/test_mesh.py``, on the trained bundle (random
weights amplify float differences chaotically, DESIGN.md §2). Each
tolerance stands beside its test.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from wct_tpu.models import cascade as jcascade
from wct_tpu.models import vgg as jvgg
from wct_tpu.parallel import mesh as jmesh
from wct_tpu_torch.models import cascade as tcascade
from wct_tpu_torch.models import vgg as tvgg
from wct_tpu_torch.parallel import mesh as tmesh
from wct_tpu_torch.train import checkpoint as tck

BUNDLE = Path(__file__).resolve().parent.parent / "weights" / "bundle.npz"
SIZE = 32
TARGETS = ("relu2_1", "relu1_1")
METHOD = "newton_schulz_pallas"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite runs in
    parallel workers, and torch's OpenMP threads spinning on a loaded
    machine made a 30-step test take 150 s instead of 1."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup():
    tree = tck.load_pytree(BUNDLE)
    rng = np.random.default_rng(11)
    content = rng.random((8, SIZE, SIZE, 3), np.float32)
    style = rng.random((SIZE, SIZE, 3), np.float32)
    cfg = tcascade.CascadeConfig(relu_targets=TARGETS, method=METHOD)
    params = tck.params_from_numpy(tree, "cpu")
    cache = tcascade.precompute_style(params["encoder"], style, cfg)
    return tree, params, content, style, cfg, cache


def _rel(got, ref) -> float:
    """max |got − ref| relative to the reference's largest value."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def test_create_mesh_defaults_to_cuda_and_cycles():
    """A mesh is on CUDA unless the caller asks for the CPU; without a card
    that raises. n above the device count cycles."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmesh.create_mesh()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tmesh.create_mesh(4)
    assert tmesh.create_mesh(device="cpu").devices == (torch.device("cpu"),)
    mesh = tmesh.create_mesh(3, axis_name="sp", device="cpu")
    assert mesh.devices == (torch.device("cpu"),) * 3 and mesh.shape == {"sp": 3}
    assert mesh.streams == ()
    with pytest.raises(ValueError, match="at least one device"):
        tmesh.create_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="mesh axis is 'sp'"):
        tmesh.batch_sharding(mesh)


def test_shard_batch_splits_in_tensor_split_order_and_gathers():
    mesh = tmesh.create_mesh(4, device="cpu")
    x = torch.arange(6 * 2 * 3 * 1, dtype=torch.float32).reshape(6, 2, 3, 1)
    s = tmesh.shard_batch(x, mesh)
    assert [t.shape[0] for t in s.shards] == [2, 2, 1, 1]
    for got, want in zip(s.shards, torch.tensor_split(x, 4)):
        assert torch.equal(got, want)
    assert s.shape == (6, 2, 3, 1) and torch.equal(tmesh.gather(s), x)
    two = tmesh.shard_batch(x[:2], mesh)  # fewer images than entries
    assert [t.shape[0] for t in two.shards] == [1, 1, 0, 0]


@pytest.mark.parametrize("h,n,rows", [(48, 2, [32, 16]), (64, 4, [16] * 4), (80, 3, [32, 32, 16]),
                                      (40, 2, [32, 8])])
def test_shard_spatial_splits_whole_blocks(h, n, rows):
    """Whole 16-row blocks, as even as they allow (3 blocks on 2 shards:
    2 + 1); a last partial block stays with the last shard."""
    mesh = tmesh.create_mesh(n, device="cpu")
    x = torch.rand(1, h, 5, 3)
    s = tmesh.shard_spatial(x, mesh)
    assert [t.shape[1] for t in s.shards] == rows
    assert torch.equal(tmesh.gather(s), x)


def test_shard_spatial_needs_a_block_per_shard():
    with pytest.raises(ValueError, match="too few for 4 shards"):
        tmesh.shard_spatial(torch.zeros(1, 48, 8, 3), tmesh.create_mesh(4, device="cpu"))


def test_replicas_are_shared_on_one_device_and_kept(setup):
    """Shards of one device share the parameter tensors; a tree is copied
    once per device and the copy reused."""
    _, params, _, _, _, cache = setup
    mesh = tmesh.create_mesh(4, device="cpu")
    reps = tmesh.put(params, tmesh.replicated(mesh))
    assert len(reps) == 4 and all(r is reps[0] for r in reps)
    assert reps[0]["encoder"]["conv1_1"]["w"] is params["encoder"]["conv1_1"]["w"]
    c = tmesh.replicate(mesh, cache, torch.device("cpu"))
    assert c is tmesh.replicate(mesh, cache, torch.device("cpu"))
    assert c["relu2_1"].stats.kernel is cache["relu2_1"].stats.kernel


@pytest.mark.parametrize("n", [4, 8])
def test_dp_equals_unsharded_per_shard_and_jax(setup, n):
    """Each shard is the port's ``stylize`` of the same images, bitwise.
    Against ``wct_tpu.parallel.stylize_sharded`` on the same numpy inputs
    and weights: q99 ≤ 1e-4, the bound of
    ``tests/test_torch_cascade.py::test_cascade_options`` for a two-level
    cascade (measured q99 3.8e-6, max 1.4e-5)."""
    tree, params, content, style, cfg, cache = setup
    mesh = tmesh.create_mesh(n, device="cpu")
    out = tmesh.stylize_sharded(params, content, cache, 0.7, cfg, mesh)
    per = 8 // n
    for i in range(n):
        ref = tcascade.stylize(params, content[i * per:(i + 1) * per], cache, 0.7, cfg)
        assert torch.equal(out[i * per:(i + 1) * per], ref), i
    jcfg = jcascade.CascadeConfig(relu_targets=TARGETS, method=METHOD)
    jcache = jcascade.precompute_style(tree["encoder"], jnp.asarray(style), jcfg)
    jm = jmesh.create_mesh(n)
    jout = np.asarray(jmesh.stylize_sharded(
        tree, jmesh.shard_batch(jnp.asarray(content), jm), jcache, 0.7, jcfg, jm))
    assert np.quantile(np.abs(out.numpy() - jout), 0.99) <= 1e-4


def test_dp_uneven_batch_and_fused_config(setup):
    """B = 6 on 4 shards (2, 2, 1, 1): each shard equals ``stylize`` of its
    images, bitwise; ``fuse_junction=True`` runs unfused on the mesh, the
    same bits as the unfused config."""
    import dataclasses

    _, params, content, _, cfg, cache = setup
    mesh = tmesh.create_mesh(4, device="cpu")
    x = tmesh.shard_batch(content[:6], mesh)
    out = tmesh.stylize_sharded(params, x, cache, 0.5, cfg, mesh)
    assert out.shape == (6, SIZE, SIZE, 3)
    start = 0
    for s in x.shards:
        ref = tcascade.stylize(params, s, cache, 0.5, cfg)
        assert torch.equal(out[start:start + len(s)], ref)
        start += len(s)
    fused = tmesh.stylize_sharded(params, content[:6], cache, 0.5,
                                  dataclasses.replace(cfg, fuse_junction=True), mesh)
    assert torch.equal(fused, out)


def test_halo_conv_stack_matches_unsharded_and_jax(setup):
    """The halo encoder to relu2_1 on 4 shards against the unsharded one:
    ≤ 1e-6 of the map's max (measured 0: each shard's conv sums the same
    products). Against JAX's height-sharded conv stack
    (``tests/test_mesh.py``'s jit): ≤ 1e-5 (measured 3.6e-6, the two
    frameworks' convs; the reference's own test allows rtol 1e-4 / atol
    1e-3)."""
    tree, params, content, _, _, _ = setup
    mesh = tmesh.create_mesh(4, axis_name="sp", device="cpu")
    got = tmesh.encode_spatial(params["encoder"], content[:2], "relu2_1", mesh)
    ref = tvgg.encode(params["encoder"], torch.from_numpy(content[:2]), "relu2_1")
    assert got.shape == ref.shape == (2, SIZE // 2, SIZE // 2, 128)
    assert _rel(got, ref) <= 1e-6
    jm = jmesh.create_mesh(4, axis_name="sp")
    enc = jax.jit(lambda p, x: jvgg.encode(p, x, "relu2_1"),
                  in_shardings=(NamedSharding(jm, P()), NamedSharding(jm, P(None, "sp"))),
                  out_shardings=NamedSharding(jm, P(None, "sp")))
    jref = np.asarray(enc(tree["encoder"], jnp.asarray(content[:2])))
    assert _rel(got, jref) <= 1e-5


def test_one_row_shards_take_reflect_rows_from_the_neighbour(setup):
    """8 rows on 4 shards: every shard is one row tall at relu2_1, so the
    top shard's reflected row 1 and the bottom one's row H − 2 live in the
    neighbours. ≤ 1e-6 of the map's max against the unsharded encoder.
    The cascade: max ≤ 1e-4 from the unsharded one (measured 2.5e-5:
    24 relu2_1 pixels give a covariance of rank ≤ 23 of 128, where
    Newton–Schulz amplifies the other summation order; ``eigh`` 5e-7)."""
    _, params, content, _, cfg, cache = setup
    mesh = tmesh.create_mesh(4, axis_name="sp", device="cpu")
    x = content[:1, :8, :12]
    got = tmesh.encode_spatial(params["encoder"], x, "relu2_1", mesh)
    ref = tvgg.encode(params["encoder"], torch.from_numpy(x), "relu2_1")
    assert got.shape[1] == 4 and _rel(got, ref) <= 1e-6
    out = tmesh.stylize_spatial(params, x, cache, 0.7, cfg, mesh)
    assert np.abs((out - tcascade.stylize(params, x, cache, 0.7, cfg)).numpy()).max() <= 1e-4


@pytest.mark.parametrize("groups", [1, 4])
def test_combined_covariance_against_float64(groups):
    """Per-shard Grams combined by Chan's rule on 3 blocks over 2 shards
    (uneven), dense and in 4 groups (block Grams): each covariance ≤ 1e-6
    from float64 in relative Frobenius norm (the card's covariance bar;
    measured 6.2e-7), the means ≤ 1e-6 of their largest (1.2e-7)."""
    rng = np.random.default_rng(5)
    f = np.maximum(rng.standard_normal((2, 32, 3 * 16, 10)) + 0.3, 0).astype(np.float32)
    mesh = tmesh.create_mesh(2, device="cpu")
    feats = list(torch.split(torch.from_numpy(f), [32, 16], dim=2))
    cov, mean = tmesh.sharded_covariance(mesh, feats, groups)
    x = f.astype(np.float64).reshape(2 * groups, 32 // groups, -1)
    mu = x.mean(-1)
    d = x - mu[..., None]
    ref = d @ d.transpose(0, 2, 1) / (x.shape[-1] - 1)
    assert cov.shape == ref.shape and mean.shape == mu.shape
    fro = np.linalg.norm(cov.numpy() - ref, axis=(1, 2)) / np.linalg.norm(ref, axis=(1, 2))
    assert fro.max() <= 1e-6 and _rel(mean, mu) <= 1e-6


def _spatial_vs_unsharded(setup, cfg, cache, x, alpha=0.7):
    _, params, _, _, _, _ = setup
    mesh = tmesh.create_mesh(4, axis_name="sp", device="cpu")
    got = tmesh.stylize_spatial(params, x, cache, alpha, cfg, mesh)
    ref = tcascade.stylize(params, x, cache, alpha, cfg)
    assert got.shape == ref.shape
    return np.abs((got - ref).numpy())


def test_spatial_cascade_per_level_teacher_forced(setup):
    """Each level alone on the unsharded running image (DESIGN.md §2b):
    q99 ≤ 5e-3, the bar of the card's phase, and max ≤ 1e-4 (measured
    q99 ≤ 2.8e-6, max ≤ 6.9e-6)."""
    _, params, content, _, cfg, cache = setup
    import dataclasses

    x = torch.from_numpy(content[:2])
    for level in TARGETS:
        one = dataclasses.replace(cfg, relu_targets=(level,))
        d = _spatial_vs_unsharded(setup, one, cache, x)
        assert np.quantile(d, 0.99) <= 5e-3 and d.max() <= 1e-4, (level, d.max())
        x = tcascade.stylize(params, x, cache, 0.7, one)


def test_spatial_cascade_is_deterministic(setup):
    """Two calls give the same bits (the reference's determinism test);
    the whole cascade stays ≤ 1e-4 from the unsharded one (measured
    6.1e-6)."""
    _, params, content, _, cfg, cache = setup
    mesh = tmesh.create_mesh(4, axis_name="sp", device="cpu")
    x = content[:1]
    a = tmesh.stylize_spatial(params, x, cache, 0.7, cfg, mesh)
    b = tmesh.stylize_spatial(params, tmesh.shard_spatial(x, mesh, "sp", block=2), cache, 0.7,
                              cfg, mesh)
    assert a.shape == (1, SIZE, SIZE, 3) and torch.isfinite(a).all()
    assert torch.equal(a, b)
    assert _spatial_vs_unsharded(setup, cfg, cache, x).max() <= 1e-4


def test_spatial_adain_mode(setup):
    """Mirrors ``tests/test_mesh.py::test_spatial_sharding_adain_mode``
    (atol 5e-2 there): combined moments, no truncation edge; here ≤ 1e-5
    (measured 1.8e-6)."""
    _, params, content, _, _, _ = setup
    cfg = tcascade.CascadeConfig(relu_targets=TARGETS, transform="adain")
    style = np.random.default_rng(17).random((SIZE, SIZE, 3), np.float32)
    cache = tcascade.precompute_style(params["encoder"], style, cfg)
    assert _spatial_vs_unsharded(setup, cfg, cache, content[:1], 0.8).max() <= 1e-5


@pytest.mark.parametrize("kw", [dict(wct_groups=4), dict(compute_dtype="bfloat16",
                                                         method="newton_schulz_fast",
                                                         compose_conv0=True)],
                         ids=["groups4", "bf16_throughput"])
def test_spatial_grouped_and_bf16(setup, kw):
    """Grouped WCT (combined block Grams): ≤ 1e-4 from unsharded (measured
    6.3e-6). The bf16 throughput route (composed conv0): a bf16 chain
    flips single roundings (PERF.md §6), so q99 ≤ 1e-2 and the median
    ≤ 1e-3 (measured q99 7.8e-3, two bf16 ulps near 0.5; median 0)."""
    _, params, content, style, _, _ = setup
    cfg = tcascade.CascadeConfig(relu_targets=TARGETS, **kw)
    cache = tcascade.precompute_style(params["encoder"], style, cfg)
    d = _spatial_vs_unsharded(setup, cfg, cache, content[:2])
    if "wct_groups" in kw:
        assert d.max() <= 1e-4
    else:
        assert np.quantile(d, 0.99) <= 1e-2 and np.median(d) <= 1e-3


def test_spatial_swap5_gathers_the_relu5_1_map(setup):
    """Style-swap at relu5_1 on 4 shards of one row each there (64 rows):
    the whitened map is swapped whole, so the level matches the unsharded
    one within the conv and Gram noise: ≤ 1e-4 (measured 7.5e-7)."""
    _, params, content, _, _, _ = setup
    cfg = tcascade.CascadeConfig(relu_targets=("relu5_1",), swap5=True, method=METHOD)
    rng = np.random.default_rng(23)
    cache = tcascade.precompute_style(params["encoder"], rng.random((64, 64, 3), np.float32), cfg)
    d = _spatial_vs_unsharded(setup, cfg, cache, rng.random((1, 64, 48, 3), np.float32))
    assert d.max() <= 1e-4


def test_microbatched_custom_executor_sees_every_padded_chunk(setup):
    """``stylize_fn`` replaces the per-chunk executor and keeps the pad and
    chunk discipline: 5 images in microbatches of 2 are three calls of 2;
    the default output is unchanged, bitwise."""
    _, params, content, _, cfg, cache = setup
    calls = []

    def spy(p, chunk, c, alpha, config):
        calls.append(chunk.clone())
        return tcascade.stylize(p, chunk, c, alpha, config)

    x = torch.from_numpy(content[:5])
    got = tcascade.stylize_microbatched(params, x, cache, 0.7, cfg, 2, stylize_fn=spy)
    assert [len(c) for c in calls] == [2, 2, 2]
    assert torch.equal(calls[2], torch.cat([x[4:], x[4:]]))  # padded with the last frame
    default = tcascade.stylize_microbatched(params, x, cache, 0.7, cfg, 2)
    assert torch.equal(got, default)
    by_hand = torch.cat([tcascade.stylize(params, c, cache, 0.7, cfg) for c in calls])[:5]
    assert torch.equal(default, by_hand)
    mesh = tmesh.create_mesh(2, device="cpu")
    import functools

    dp = tcascade.stylize_microbatched(
        params, x, cache, 0.7, cfg, 2, stylize_fn=functools.partial(tmesh.stylize_sharded,
                                                                     mesh=mesh))
    assert dp.shape == default.shape


def test_shard_times_on_the_cpu(setup):
    """``profiling.shard_times`` after a CPU run: each entry's enqueue ms
    (the work itself on the CPU), and no device time."""
    from wct_tpu_torch.utils import profiling

    _, params, content, _, cfg, cache = setup
    mesh = tmesh.create_mesh(2, device="cpu")
    tmesh.stylize_sharded(params, content[:2], cache, 0.7, cfg, mesh)
    rows = profiling.shard_times(mesh)
    assert [r["entry"] for r in rows] == [0, 1]
    assert all(r["enqueue_ms"] > 0 and r["device_ms"] is None for r in rows)
