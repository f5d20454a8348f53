"""The port's mesh module on the card: a mesh of two shards of ``cuda:0``.

Every test here needs an NVIDIA GPU and skips without one; run them on
the card's machine with

    python -m pytest --noconftest -q -m cuda tests/test_torch_mesh_cuda.py
"""

import dataclasses

from pathlib import Path

import numpy as np
import pytest
import torch

from wct_tpu_torch.models import cascade
from wct_tpu_torch.ops import gram
from wct_tpu_torch.parallel import mesh as tmesh
from wct_tpu_torch.train import checkpoint as tck
from wct_tpu_torch.train import data as tdata
from wct_tpu_torch.train import trainer as tt

pytestmark = pytest.mark.cuda

BUNDLE = Path(__file__).resolve().parent.parent / "weights" / "bundle.npz"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def params(card):
    return tck.params_from_numpy(tck.load_pytree(BUNDLE), card)


def test_dp_equals_stylize_per_shard(card, params):
    """Two shards of cuda:0, each on its own stream: each shard's output is
    ``stylize`` of the same two images, bitwise, and both kernels ran."""
    rng = np.random.default_rng(0)
    content = rng.random((4, 128, 128, 3), np.float32)
    cfg = cascade.CascadeConfig(method="newton_schulz_pallas")
    cache = cascade.precompute_style(params["encoder"], rng.random((128, 128, 3), np.float32), cfg)
    mesh = tmesh.create_mesh(2, device="cuda:0")
    assert mesh.devices == (card, card) and len(mesh.streams) == 2
    launches = gram.centered_gram_cuda.launches
    out = tmesh.stylize_sharded(params, content, cache, 0.6, cfg, mesh)
    torch.cuda.synchronize()
    assert gram.centered_gram_cuda.launches - launches == 2 * 5
    for i in range(2):
        ref = cascade.stylize(params, content[2 * i:2 * i + 2], cache, 0.6, cfg)
        assert torch.equal(out[2 * i:2 * i + 2], ref)


def test_combined_gram_against_float64(card):
    """Kernel Grams of three uneven height shards, combined: ≤ 1e-6 from
    float64 in relative Frobenius norm (the card's covariance bar)."""
    rng = np.random.default_rng(1)
    f = np.maximum(rng.standard_normal((2, 256, 48, 40)) + 0.2, 0).astype(np.float32)
    mesh = tmesh.create_mesh(3, device="cuda:0")
    feats = [t.to(card) for t in torch.split(torch.from_numpy(f), [16, 24, 8], dim=2)]
    cov, mean = tmesh.sharded_covariance(mesh, feats)
    x = f.astype(np.float64).reshape(2, 256, -1)
    mu = x.mean(-1)
    d = x - mu[..., None]
    ref = d @ d.transpose(0, 2, 1) / (x.shape[-1] - 1)
    got = cov.cpu().numpy()
    assert (np.linalg.norm(got - ref, axis=(1, 2)) / np.linalg.norm(ref, axis=(1, 2))).max() <= 1e-6
    assert np.abs(mean.cpu().numpy() - mu).max() <= 1e-6 * np.abs(mu).max()


def test_one_shard_train_step_is_train_step(card, params):
    """A mesh of one is ``train_step``: the same parameters and Adam
    moments, bitwise, after two steps."""
    cfg = tt.TrainConfig(relu_target="relu3_1", batch_size=4, crop_size=64)
    batch = torch.from_numpy(np.stack([tdata.synthetic_image(np.random.default_rng(i), 64)
                                       for i in range(4)])).to(card)
    step = tt.make_sharded_train_step(tmesh.create_mesh(1, device="cuda:0"), cfg)

    def state():
        return tt.train_state_from_params(
            tck._map_tree(lambda t: t.clone(), params["decoders"]["relu3_1"]), cfg)

    got, ref = state(), state()
    for _ in range(2):
        got, _ = step(got, params["encoder"], batch)
        ref, _ = tt.train_step(ref, params["encoder"], batch, cfg)
    torch.cuda.synchronize()
    for a, b in zip(got.optimizer.param_groups[0]["params"], ref.optimizer.param_groups[0]["params"]):
        assert torch.equal(a, b)
        sa, sb = got.optimizer.state[a], ref.optimizer.state[b]
        assert torch.equal(sa["exp_avg"], sb["exp_avg"]) and torch.equal(sa["exp_avg_sq"], sb["exp_avg_sq"])


@pytest.mark.parametrize("kw", [dict(fold_transform=True), dict(ring_conv=True)],
                         ids=["fold", "ring"])
def test_spatial_rewrites_on_four_shards(card, params, kw):
    """``stylize_spatial`` with the fold or the ring on four shards of
    cuda:0, one 256 × 192 image, five levels: against the same call
    without the flag, f32 q99 ≤ 5e-3 (``chip_smoke.py``'s rewrite bar)."""
    rng = np.random.default_rng(3)
    x = rng.random((1, 256, 192, 3), np.float32)
    cfg = cascade.CascadeConfig(method="newton_schulz_pallas")
    cache = cascade.precompute_style(params["encoder"], rng.random((128, 128, 3), np.float32), cfg)
    mesh = tmesh.create_mesh(4, axis_name="sp", device="cuda:0")
    on = tmesh.stylize_spatial(params, x, cache, 0.6, dataclasses.replace(cfg, **kw), mesh)
    off = tmesh.stylize_spatial(params, x, cache, 0.6, cfg, mesh)
    d = (on - off).abs().flatten()
    assert bool(torch.isfinite(on).all()) and float(torch.quantile(d[::2], 0.99)) <= 5e-3


def test_dp_pack2_keeps_pairs_per_shard(card, params):
    """Four images on two shards: each shard packs its pair and equals
    ``stylize`` of its images with pack2, bitwise; six images on four
    shards run with pack2 off."""
    rng = np.random.default_rng(4)
    content = rng.random((6, 128, 128, 3), np.float32)
    cfg = cascade.CascadeConfig(method="newton_schulz_pallas", pack2_junction=True)
    cache = cascade.precompute_style(params["encoder"], rng.random((128, 128, 3), np.float32), cfg)
    out = tmesh.stylize_sharded(params, content[:4], cache, 0.6, cfg, tmesh.create_mesh(2, device="cuda:0"))
    for i in range(2):
        assert torch.equal(out[2 * i:2 * i + 2],
                           cascade.stylize(params, content[2 * i:2 * i + 2], cache, 0.6, cfg))
    off = dataclasses.replace(cfg, pack2_junction=False)
    mesh = tmesh.create_mesh(4, device="cuda:0")
    assert torch.equal(tmesh.stylize_sharded(params, content, cache, 0.6, cfg, mesh),
                       tmesh.stylize_sharded(params, content, cache, 0.6, off, mesh))


def test_spatial_pack2_on_four_shards_is_the_cpu_call(card, params):
    """pack2 on an even batch in ``stylize_spatial``: two 64-px images,
    relu2_1 → relu1_1 (a packed junction, then the packed relu1_1 tail),
    on four shards of cuda:0 against the same call on four CPU shards:
    the kernels' bar against the plain cascade, max ≤ 1e-3
    (``tests/test_torch_cuda.py``); a Gram kernel launch per level and
    shard, a Newton–Schulz kernel launch per level."""
    from wct_tpu_torch.ops import sqrtm

    rng = np.random.default_rng(5)
    content = rng.random((2, 64, 64, 3), np.float32)
    style = rng.random((64, 64, 3), np.float32)
    cfg = cascade.CascadeConfig(relu_targets=("relu2_1", "relu1_1"), method="newton_schulz_pallas",
                                pack2_junction=True)
    outs = {}
    for dev in ("cuda:0", "cpu"):
        p = params if dev != "cpu" else tck.params_from_numpy(tck.load_pytree(BUNDLE), "cpu")
        cache = cascade.precompute_style(p["encoder"], style, cfg)
        mesh = tmesh.create_mesh(4, axis_name="sp", device=dev)
        grams, roots = gram.centered_gram_cuda.launches, sqrtm.ns_sqrtm_cuda.launches
        outs[dev] = tmesh.stylize_spatial(p, content, cache, 0.6, cfg, mesh)
        if dev != "cpu":
            torch.cuda.synchronize()
            assert gram.centered_gram_cuda.launches - grams == 2 * 4
            assert sqrtm.ns_sqrtm_cuda.launches - roots == 2
    assert outs["cuda:0"].shape == (2, 64, 64, 3)
    assert float((outs["cuda:0"].cpu() - outs["cpu"]).abs().max()) <= 1e-3
