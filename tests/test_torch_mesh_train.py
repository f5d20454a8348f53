"""The port's data-parallel train step on CPU meshes.

``make_sharded_train_step`` against the port's ``train_step`` on the
whole batch and against ``wct_tpu.train.make_sharded_train_step`` on the
8 virtual CPU devices ``tests/conftest.py`` gives JAX. The relu2_1
decoder of the trained bundle, batch 8, crop 32, procedural images.
Each tolerance stands beside its test.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wct_tpu.parallel import mesh as jmesh
from wct_tpu.train import checkpoint as jck
from wct_tpu.train import data as jdata
from wct_tpu.train import trainer as jt
from wct_tpu_torch.parallel import mesh as tmesh
from wct_tpu_torch.train import checkpoint as tck
from wct_tpu_torch.train import trainer as tt

BUNDLE = Path(__file__).resolve().parent.parent / "weights" / "bundle.npz"
TARGET = "relu2_1"


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
def bundle():
    return tck.load_pytree(BUNDLE)


@pytest.fixture(scope="module")
def enc(bundle):
    return tck.params_from_numpy(bundle["encoder"], "cpu")


@pytest.fixture(scope="module")
def batch():
    return np.stack([jdata.synthetic_image(np.random.default_rng(i), 32) for i in range(8)])


def _cfg(**kw):
    return tt.TrainConfig(relu_target=TARGET, batch_size=8, crop_size=32, **kw)


def _state(bundle, cfg):
    return tt.train_state_from_params(tck.params_from_numpy(bundle["decoders"][TARGET], "cpu"),
                                      cfg)


def _grads(state) -> dict:
    """The gradients the last step applied, flattened in the JAX layout."""
    return tck._flatten(tck.params_to_numpy(tck._map_tree(lambda p: p.grad, state.params)))


def test_one_entry_mesh_is_train_step_bitwise(bundle, enc, batch):
    """Two steps on a mesh of one: the parameters and Adam's state are
    ``train_step``'s, bit for bit."""
    cfg = _cfg(grad_clip=0.5)
    step = tt.make_sharded_train_step(tmesh.create_mesh(1, device="cpu"), cfg)
    got, ref = _state(bundle, cfg), _state(bundle, cfg)
    for _ in range(2):
        got, m = step(got, enc, torch.from_numpy(batch))
        ref, m_ref = tt.train_step(ref, enc, torch.from_numpy(batch), cfg)
        assert all(torch.equal(m[k], m_ref[k]) for k in m_ref)
    a, b = tt.state_tree(got), tt.state_tree(ref)
    for tree_a, tree_b in ((a["params"], b["params"]), (a["opt_state"][0][1], b["opt_state"][0][1]),
                           (a["opt_state"][0][2], b["opt_state"][0][2])):
        fa, fb = tck._flatten(tree_a), tck._flatten(tree_b)
        for k in fb:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    assert got.step == ref.step == 2


@pytest.mark.parametrize("n,kw", [(4, {}), (3, {}), (4, dict(feature_norm=True, grad_clip=0.5))],
                         ids=["4_shards", "3_uneven", "4_feature_norm_clip"])
def test_shards_match_train_step_on_the_whole_batch(bundle, enc, batch, n, kw):
    """4 shards of 2, 3 uneven shards (3, 3, 2) and ``feature_norm`` (the
    whole batch's feature power on every shard) with a clip: every
    gradient leaf within 1e-5 relative Frobenius of ``train_step``'s
    (the weighted sum adds in another order; measured ≤ 4.5e-6), the
    loss within 1e-6 relative."""
    cfg = _cfg(**kw)
    got, m = tt.make_sharded_train_step(tmesh.create_mesh(n, device="cpu"), cfg)(
        _state(bundle, cfg), enc, torch.from_numpy(batch))
    ref, m_ref = tt.train_step(_state(bundle, cfg), enc, torch.from_numpy(batch), cfg)
    assert abs(float(m["loss"]) - float(m_ref["loss"])) <= 1e-6 * float(m_ref["loss"])
    g, g_ref = _grads(got), _grads(ref)
    for k, v in g_ref.items():
        assert np.linalg.norm(g[k] - v) <= 1e-5 * np.linalg.norm(v), k
    assert got.step == 1 and set(m) == set(m_ref)


def test_one_step_against_jax_sharded_step(bundle, enc, batch):
    """One step of ``wct_tpu``'s ``make_sharded_train_step`` on its 8-device
    mesh and of the port's on an 8-entry CPU mesh, from the trained
    decoder: the loss within 1e-4 relative and each gradient leaf within
    1e-3 relative Frobenius, ``tests/test_torch_train.py``'s bounds for
    the unsharded step (the JAX gradient read back from Adam's first
    moment, 0.1·g after one step)."""
    jcfg = jt.TrainConfig(relu_target=TARGET, batch_size=8, crop_size=32)
    params = jax.tree.map(jnp.asarray, bundle["decoders"][TARGET])
    jstate = jt.TrainState(params=params, opt_state=jt.make_optimizer(jcfg).init(params),
                           step=jnp.int32(0))
    jm = jmesh.create_mesh(8)
    jstate, jmetrics = jt.make_sharded_train_step(jm, jcfg)(
        jstate, bundle["encoder"], jmesh.shard_batch(jnp.asarray(batch), jm))
    jgrads = {k: v / 0.1 for k, v in jck._flatten(jax.device_get(jstate.opt_state[0].mu)).items()}
    cfg = _cfg()
    got, m = tt.make_sharded_train_step(tmesh.create_mesh(8, device="cpu"), cfg)(
        _state(bundle, cfg), enc, torch.from_numpy(batch))
    assert abs(float(m["loss"]) - float(jmetrics["loss"])) <= 1e-4 * float(jmetrics["loss"])
    g = _grads(got)
    assert sorted(g) == sorted(jgrads)
    for k, ref in jgrads.items():
        ref = np.asarray(ref, np.float64)
        assert np.linalg.norm(g[k] - ref) <= 1e-3 * np.linalg.norm(ref), k
