"""Port checkpoint I/O and the weight bridge against ``wct_tpu``'s."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from wct_tpu.models import cascade as jcascade
from wct_tpu.train import checkpoint as jck
from wct_tpu_torch.train import checkpoint as tck

BUNDLE = Path(__file__).resolve().parent.parent / "weights" / "bundle.npz"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite runs in
    parallel workers, and torch's OpenMP threads spinning on a loaded
    machine made a 30-step test take 150 s instead of 1."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _flat(tree):
    return jck._flatten(jax.device_get(tree))


@pytest.mark.parametrize("upcast", [True, False])
def test_bundle_loads_like_reference(upcast):
    """Every key, shape, dtype and value of the bundle as ``load_pytree`` gives it."""
    ref = _flat(jck.load_pytree(BUNDLE, upcast_f16=upcast))
    ours = tck._flatten(tck.load_pytree(BUNDLE, upcast_f16=upcast))
    assert sorted(ours) == sorted(ref)
    assert len(ours) == 90
    for k, v in ref.items():
        assert ours[k].shape == v.shape, k
        assert ours[k].dtype == v.dtype, k
        np.testing.assert_array_equal(ours[k], v, err_msg=k)
    dtypes = [str(v.dtype) for v in ours.values()]
    if upcast:
        assert set(dtypes) == {"float32"}
    else:
        assert dtypes.count("float16") == 89 and dtypes.count("float32") == 1


def _reference_tree(source):
    if source == "bundle":
        return tck.load_pytree(BUNDLE)
    return jax.tree.map(np.asarray, jcascade.init_params(jax.random.PRNGKey(0)))


@pytest.mark.parametrize("source", ["bundle", "init_params"])
def test_params_from_numpy_round_trip_exact(source):
    tree = _reference_tree(source)
    params = tck.params_from_numpy(tree, "cpu")
    assert params["encoder"]["conv1_1"]["w"].shape == (64, 3, 3, 3)  # OIHW
    assert params["decoders"]["relu1_1"]["dec_conv1_1"]["w"].shape == (3, 64, 3, 3)
    back = tck._flatten(tck.params_to_numpy(params))
    ref = _flat(tree)
    assert sorted(back) == sorted(ref)
    for k, v in ref.items():
        assert back[k].dtype == v.dtype, k
        np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_saved_tree_loads_in_reference(tmp_path):
    params = tck.params_from_numpy(_reference_tree("init_params"), "cpu")
    path = tmp_path / "p.npz"
    tck.save_pytree(path, tck.params_to_numpy(params))
    ref = _flat(jck.load_pytree(path))
    ours = tck._flatten(tck.params_to_numpy(params))
    assert sorted(ref) == sorted(ours)
    for k, v in ours.items():
        np.testing.assert_array_equal(ref[k], v, err_msg=k)


def test_lists_round_trip(tmp_path):
    tree = {"a": [np.arange(3), np.ones((2, 2), np.float16)], "b": torch.zeros(2)}
    path = tmp_path / "t.npz"
    tck.save_pytree(path, tree)
    back = tck.load_pytree(path, upcast_f16=False)
    assert isinstance(back["a"], list) and back["a"][1].dtype == np.float16
    np.testing.assert_array_equal(back["a"][0], np.arange(3))
    np.testing.assert_array_equal(back["b"], np.zeros(2, np.float32))


def test_cuda_request_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tck.params_from_numpy({"w": np.zeros(3, np.float32)})
