"""The port's evaluation protocol (``wct_tpu_torch/eval``) against ``wct_tpu.eval``.

The frozen evaluator's weights must be the reference's bytes (its pinned
``FINGERPRINT``); its Gram statistics, run on the port's encoder, and the
pixel-space texture distances must match the reference's on the same
seeded images.
"""

import numpy as np
import pytest
import torch

from wct_tpu.eval import frozen as jfrozen
from wct_tpu.eval import texture as jtexture
from wct_tpu_torch.eval import frozen, texture


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite runs in
    parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _noise(size=64, seed=0):
    return np.random.default_rng(seed).random((size, size, 3)).astype(np.float32)


def test_fingerprint_is_the_references_pinned_value():
    assert frozen.FINGERPRINT == jfrozen.FINGERPRINT
    assert frozen.fingerprint() == jfrozen.FINGERPRINT


def test_evaluator_params_are_the_references_in_oihw():
    """The port's tensors are the reference's HWIO arrays transposed, and
    the CReLU pairing holds: the second half of each conv's filters is the
    negated first half."""
    ref = jfrozen.evaluator_params()
    got = frozen.evaluator_params("cpu")
    assert set(got) == set(ref)
    for name in ref:
        np.testing.assert_array_equal(got[name]["w"].numpy(),
                                      np.asarray(ref[name]["w"]).transpose(3, 2, 0, 1))
        np.testing.assert_array_equal(got[name]["b"].numpy(), np.asarray(ref[name]["b"]))
    w = got["conv2_1"]["w"]
    half = w.shape[0] // 2
    assert torch.equal(w[:half], -w[half:])


def test_gram_stats_match_reference():
    """f32 on both sides, 64 px through relu5_1: each level's Gram, mean
    and std within 1e-5 of the reference's largest entry (measured
    ≤ 1.5e-6)."""
    img = _noise(64, seed=3)
    ref = jfrozen.gram_stats(img)
    got = frozen.gram_stats(img, device="cpu")
    assert set(got) == set(ref)
    for t in ref:
        for k in ("gram", "mean", "std"):
            assert got[t][k].dtype == np.float64 and got[t][k].shape == ref[t][k].shape
            err = np.abs(got[t][k] - ref[t][k]).max() / np.abs(ref[t][k]).max()
            assert err <= 1e-5, (t, k, err)


def test_gram_distance_matches_reference():
    style, out = _noise(64, seed=4), _noise(64, seed=5)
    targets = ("relu1_1", "relu2_1", "relu3_1")
    ref = jfrozen.gram_distance(out, jfrozen.gram_stats(style, targets), targets)
    got = frozen.gram_distance(out, frozen.gram_stats(style, targets, "cpu"), targets, "cpu")
    assert got.keys() == ref.keys()
    for k in ("frozen_gram_rel", "frozen_meanstd_rel"):
        assert abs(got[k] - ref[k]) <= 1e-5 * abs(ref[k]), k
    assert frozen.gram_distance(style, frozen.gram_stats(style, targets, "cpu"), targets,
                                "cpu")["frozen_gram_rel"] == 0.0


def test_gram_stats_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        frozen.gram_stats(_noise(16))


@pytest.mark.parametrize("fn", ["spectrum_distance", "color_distance", "contrast_distance",
                                "texture_distances"])
def test_texture_distances_match_reference(fn):
    """The numpy copy gives the reference's numbers, bitwise."""
    a, b = _noise(96, seed=6), _noise(64, seed=7)
    assert getattr(texture, fn)(a, b) == getattr(jtexture, fn)(a, b)


def test_texture_module_is_the_references():
    assert texture.__all__ == jtexture.__all__
