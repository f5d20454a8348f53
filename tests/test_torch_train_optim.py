"""The port's Adam, clip and training checkpoints against ``wct_tpu``'s.

Bounds, all stated relative to the learning rate ``lr``:

- identical gradients into optax's Adam and the port's: parameters
  within 1e-2·lr after five updates, moments within 1e-6 relative (the
  two round ``mu``, ``nu`` and the bias corrections in another order);
- whole training steps: Adam's first steps move a parameter by about
  ``lr · sign(g)``, so where |g| is rounding noise the two packages can
  part by 2·lr a step. The bound is 2·lr·steps for every parameter and
  1e-2·lr for the median.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wct_tpu.train import checkpoint as jck
from wct_tpu.train import data as jdata
from wct_tpu.train import trainer as jt
from wct_tpu_torch.train import checkpoint as tck
from wct_tpu_torch.train import trainer as tt

BUNDLE = Path(__file__).resolve().parent.parent / "weights" / "bundle.npz"
KW = dict(relu_target="relu1_1", batch_size=2, crop_size=32)


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
def batches():
    pool = jdata.synthetic_pool(np.random.default_rng(2), 4, 32)
    return [pool[:2], pool[2:], pool[1:3]]


def _flat(tree):
    return jck._flatten(jax.device_get(tree))


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return {n: {k: (rng.standard_normal(v.shape) * 10.0 ** rng.integers(-6, 0)).astype(np.float32)
                for k, v in leaf.items()} for n, leaf in params.items()}


def test_adam_matches_optax_on_identical_gradients(bundle):
    cfg = tt.TrainConfig(**KW, learning_rate=1e-3, lr_decay=0.1)
    params_np = bundle["decoders"]["relu1_1"]
    opt_j = jt.make_optimizer(jt.TrainConfig(**KW, learning_rate=1e-3, lr_decay=0.1))
    pj = jax.tree.map(jnp.asarray, params_np)
    sj = opt_j.init(pj)
    update = jax.jit(opt_j.update)
    state = tt.train_state_from_params(tck.params_from_numpy(params_np, "cpu"), cfg)
    for step in range(5):
        g = _grads(params_np, step)
        upd, sj = update(jax.tree.map(jnp.asarray, g), sj, pj)
        pj = optax.apply_updates(pj, upd)
        for p, gt in tck._paired_leaves(state.params, tck.params_from_numpy(g, "cpu")):
            p.grad = gt
        for group in state.optimizer.param_groups:
            group["lr"] = tt.learning_rate(cfg, state.step)
        state.optimizer.step()
        state.step += 1
    ours = tck._flatten(tt.state_tree(state))
    ref = _flat({"params": pj, "opt_state": sj})
    for k, v in ref.items():
        if k.startswith("params/"):
            assert np.abs(ours[k] - v).max() <= 1e-2 * 1e-3, k
        elif v.ndim:
            assert np.abs(ours[k] - v).max() <= 1e-6 * np.abs(v).max(), k
        else:
            assert int(ours[k]) == int(v) == 5, k


def test_learning_rate_schedule_is_optax_count_based():
    cfg = tt.TrainConfig(learning_rate=1e-3, lr_decay=0.5)
    sched = lambda c: 1e-3 / (1.0 + 0.5 * c)  # noqa: E731 — wct_tpu/train/trainer.py:143
    assert [tt.learning_rate(cfg, c) for c in range(4)] == pytest.approx(
        [sched(c) for c in range(4)], rel=1e-12)
    assert tt.learning_rate(cfg, 0) == 1e-3


@pytest.mark.parametrize("clip", [0.0, 1e-3, 1e3])
def test_clip_grads_matches_reference(bundle, clip):
    g = _grads(bundle["decoders"]["relu2_1"], 7)
    want = jt.clip_grads(jax.tree.map(jnp.asarray, g), jt.TrainConfig(grad_clip=clip))
    got = tck.params_from_numpy(g, "cpu")
    tt.clip_grads(tck.tree_leaves(got), tt.TrainConfig(grad_clip=clip))
    got, want = tck._flatten(tck.params_to_numpy(got)), _flat(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, atol=0, err_msg=k)


def test_clip_grads_rejects_negative():
    with pytest.raises(ValueError, match="grad_clip"):
        tt.clip_grads([torch.ones(2)], tt.TrainConfig(grad_clip=-1.0))


def _jax_state(bundle, cfg):
    params = jax.tree.map(jnp.asarray, bundle["decoders"]["relu1_1"])
    return jt.TrainState(params=params, opt_state=jt.make_optimizer(cfg).init(params),
                         step=jnp.int32(0))


def _close_to_lr(ours, ref, lr, steps):
    for k, v in ref.items():
        if not k.startswith("params/"):
            continue
        d = np.abs(ours[k].astype(np.float64) - v)
        assert d.max() <= 2 * lr * steps, (k, d.max())
        assert np.median(d) <= 1e-2 * lr, (k, np.median(d))


def test_whole_steps_match_reference(bundle, enc, batches):
    cfg_j, cfg_t = jt.TrainConfig(**KW), tt.TrainConfig(**KW)
    sj = _jax_state(bundle, cfg_j)
    st = tt.train_state_from_params(tck.params_from_numpy(bundle["decoders"]["relu1_1"], "cpu"),
                                    cfg_t)
    for b in batches:
        sj, mj = jt.train_step(sj, jax.tree.map(jnp.asarray, bundle["encoder"]),
                               jnp.asarray(b), cfg_j)
        st, mt = tt.train_step(st, enc, torch.from_numpy(b), cfg_t)
        assert float(mt["loss"]) == pytest.approx(float(mj["loss"]), rel=1e-3)
    _close_to_lr(tck._flatten(tt.state_tree(st)), _flat({"params": sj.params}),
                 cfg_t.learning_rate, len(batches))


def _jax_state_from_tree(tree, cfg):
    """The JAX CLI's resume (``wct_tpu/cli/train.py:160-174``)."""
    return jt.TrainState(
        params=tree["params"],
        opt_state=jax.tree.unflatten(
            jax.tree.structure(jt.make_optimizer(cfg).init(tree["params"])),
            jax.tree.leaves(tree["opt_state"]),
        ),
        step=tree["step"],
    )


def test_state_written_by_either_package_resumes_in_the_other(tmp_path, bundle, enc, batches):
    cfg_j, cfg_t = jt.TrainConfig(**KW), tt.TrainConfig(**KW)
    enc_j = jax.tree.map(jnp.asarray, bundle["encoder"])
    # JAX writes after two steps; the port resumes and takes a third.
    sj = _jax_state(bundle, cfg_j)
    for b in batches[:2]:
        sj, _ = jt.train_step(sj, enc_j, jnp.asarray(b), cfg_j)
    jck.TrainCheckpointer(tmp_path / "jax").save(
        2, {"params": sj.params, "opt_state": sj.opt_state, "step": sj.step})
    tree = tck.TrainCheckpointer(tmp_path / "jax").restore_latest()
    st = tt.restore_train_state(tree, cfg_t, "cpu")
    assert st.step == 2
    saved = tck._flatten(tree)
    back = tck._flatten(tt.state_tree(st))
    assert sorted(back) == sorted(saved)
    for k, v in saved.items():
        np.testing.assert_array_equal(back[k], v, err_msg=k)  # exact round trip
    st, _ = tt.train_step(st, enc, torch.from_numpy(batches[2]), cfg_t)
    sj3, _ = jt.train_step(sj, enc_j, jnp.asarray(batches[2]), cfg_j)
    _close_to_lr(tck._flatten(tt.state_tree(st)), _flat({"params": sj3.params}),
                 cfg_t.learning_rate, 1)

    # The port writes after its three steps; JAX resumes and takes a fourth.
    tck.TrainCheckpointer(tmp_path / "port").save(st.step, tt.state_tree(st))
    sj4 = _jax_state_from_tree(jck.TrainCheckpointer(tmp_path / "port").restore_latest(), cfg_j)
    assert int(sj4.step) == 3
    leaves_ref = jax.tree.leaves(tt.state_tree(st)["opt_state"])
    for a, b in zip(jax.tree.leaves(sj4.opt_state), leaves_ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    sj4, _ = jt.train_step(sj4, enc_j, jnp.asarray(batches[0]), cfg_j)
    st, _ = tt.train_step(st, enc, torch.from_numpy(batches[0]), cfg_t)
    _close_to_lr(tck._flatten(tt.state_tree(st)), _flat({"params": sj4.params}),
                 cfg_t.learning_rate, 1)


def test_fresh_state_saves_zero_moments_like_optax_init(bundle):
    cfg = tt.TrainConfig(**KW)
    st = tt.train_state_from_params(tck.params_from_numpy(bundle["decoders"]["relu1_1"], "cpu"),
                                    cfg)
    ours = tck._flatten(tt.state_tree(st))
    ref = _flat({"params": bundle["decoders"]["relu1_1"],
                 "opt_state": jt.make_optimizer(jt.TrainConfig(**KW)).init(
                     jax.tree.map(jnp.asarray, bundle["decoders"]["relu1_1"])),
                 "step": jnp.int32(0)})
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype, k
        np.testing.assert_array_equal(ours[k], v, err_msg=k)


def test_checkpointer_round_trip_and_canonical_tree(tmp_path, bundle):
    cfg = tt.TrainConfig(**KW)
    st = tt.train_state_from_params(tck.params_from_numpy(bundle["decoders"]["relu1_1"], "cpu"),
                                    cfg, step=7)
    ckptr = tck.TrainCheckpointer(tmp_path)
    assert ckptr.restore_latest() is None
    tree = tt.state_tree(st)
    ckptr.save(7, tree)
    ckptr.save(7, tree)  # a save on a signal at a save step
    loaded = ckptr.restore_latest()
    ckptr.close()
    canonical = tck.canonicalize(tree)
    assert isinstance(canonical["opt_state"], list) and isinstance(loaded["opt_state"], list)
    flat_l, flat_c = tck._flatten(loaded), tck._flatten(canonical)
    assert sorted(flat_l) == sorted(flat_c)
    for k in flat_c:
        np.testing.assert_array_equal(flat_l[k], flat_c[k], err_msg=k)
    assert int(loaded["step"]) == 7


def test_checkpointer_orbax_names_its_roadmap_item(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 12"):
        tck.TrainCheckpointer(tmp_path, fmt="orbax")
    with pytest.raises(ValueError, match="unknown checkpoint format"):
        tck.TrainCheckpointer(tmp_path, fmt="pickle")
    roadmap = (BUNDLE.parent.parent / "ROADMAP.md").read_text()
    assert "12. **" in roadmap


def test_loss_decreases_from_he_init(enc, batches):
    cfg = tt.TrainConfig(relu_target="relu2_1", batch_size=2, crop_size=32, learning_rate=1e-3)
    state = tt.init_train_state(torch.Generator().manual_seed(2), cfg, "cpu")
    x = torch.from_numpy(batches[0])
    _, m0 = tt.train_step(state, enc, x, cfg)
    for _ in range(29):
        state, m = tt.train_step(state, enc, x, cfg)
    assert float(m["loss"]) < float(m0["loss"])
    assert state.step == 30
