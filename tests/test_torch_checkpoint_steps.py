"""``TrainCheckpointer(fmt="orbax")``: the port's step-directory backend.

The JAX package's orbax manager writes ``<dir>/orbax/<step>/``, keeps the
``keep`` most recent and restores the highest; the port keeps that
layout and contract with its own on-disk form (the npz tree in each step
directory). Retention, restore, atomic writes and a repeated step.
"""

import numpy as np
import pytest
import torch

from wct_tpu.train import checkpoint as jck
from wct_tpu_torch.train import checkpoint as tck


def _tree(step: int) -> dict:
    rng = np.random.default_rng(step)
    return {"params": {"dec_conv1_1": {"w": rng.standard_normal((3, 3, 4, 3)).astype(np.float32),
                                       "b": torch.zeros(3)}},
            "opt_state": [[np.int32(step), {"w": np.ones(2, np.float32)}], [np.int32(step)]],
            "step": np.int32(step)}


def _equal(a, b) -> bool:
    fa, fb = tck._flatten(a), tck._flatten(b)
    return fa.keys() == fb.keys() and all(np.array_equal(fa[k], fb[k]) for k in fa)


@pytest.mark.parametrize("keep", [1, 3])
def test_keeps_the_most_recent_steps_and_restores_the_highest(tmp_path, keep):
    ck = tck.TrainCheckpointer(tmp_path, fmt="orbax", keep=keep)
    for step in (5, 10, 15, 20, 25):
        ck.save(step, _tree(step))
    assert ck.steps() == [5, 10, 15, 20, 25][-keep:]
    assert sorted(p.name for p in (tmp_path / "orbax").iterdir()) == sorted(
        str(s) for s in [5, 10, 15, 20, 25][-keep:])
    assert _equal(ck.restore_latest(), tck.canonicalize(_tree(25)))
    again = tck.TrainCheckpointer(tmp_path, fmt="orbax", keep=keep)
    assert _equal(again.restore_latest(), tck.canonicalize(_tree(25)))


def test_restores_what_the_npz_backend_restores(tmp_path):
    """The same tree through both backends comes back the same."""
    npz = tck.TrainCheckpointer(tmp_path / "a")
    steps = tck.TrainCheckpointer(tmp_path / "b", fmt="orbax")
    npz.save(7, _tree(7))
    steps.save(7, _tree(7))
    assert _equal(npz.restore_latest(), steps.restore_latest())


def test_a_partial_write_is_never_restored(tmp_path):
    """A step is written under a temporary name and renamed, so a left-over
    temporary directory (a process killed mid-write) is neither listed
    nor restored, and the next save replaces it."""
    ck = tck.TrainCheckpointer(tmp_path, fmt="orbax")
    assert ck.restore_latest() is None
    ck.save(1, _tree(1))
    stale = tmp_path / "orbax" / ".2.tmp-12345"
    stale.mkdir()
    (stale / "state.npz").write_bytes(b"truncated")
    assert ck.steps() == [1]
    assert _equal(ck.restore_latest(), tck.canonicalize(_tree(1)))
    ck.save(2, _tree(2))
    assert ck.steps() == [1, 2] and _equal(ck.restore_latest(), tck.canonicalize(_tree(2)))


def test_saving_the_latest_step_again_keeps_it(tmp_path):
    """As the reference (a save-iter boundary and a save on a signal at one
    step): the second save of the latest step writes nothing."""
    ck = tck.TrainCheckpointer(tmp_path, fmt="orbax")
    ck.save(3, _tree(3))
    ck.save(3, _tree(4))
    assert ck.steps() == [3] and _equal(ck.restore_latest(), tck.canonicalize(_tree(3)))


def test_state_npz_in_a_step_loads_in_the_jax_package(tmp_path):
    """Each step's tree is the flat npz both packages read."""
    ck = tck.TrainCheckpointer(tmp_path, fmt="orbax")
    ck.save(9, _tree(9))
    tree = jck.load_pytree(tmp_path / "orbax" / "9" / "state.npz")
    assert int(tree["step"]) == 9
    np.testing.assert_array_equal(np.asarray(tree["params"]["dec_conv1_1"]["w"]),
                                  _tree(9)["params"]["dec_conv1_1"]["w"])


def test_keep_must_be_positive(tmp_path):
    with pytest.raises(ValueError, match="keep"):
        tck.TrainCheckpointer(tmp_path, fmt="orbax", keep=0)
