"""Port encoder and decoders against ``wct_tpu`` on the trained bundle.

64 px inputs, f32. Bound: the largest absolute difference of each
feature map or image is at most 1e-5 of that map's largest |value|,
except relu5_1's features, 2e-5. Measured at this input: 1.5e-7
(relu1_1) to 5.9e-6 (relu4_1), and 1.08e-5 at relu5_1, which is the
f32 floor of this trained encoder itself: against a float64 evaluation
of the same network the reference is off by 9.2e-6 at relu5_1 and
1.5e-5 at relu3_1, the port by 5.9e-6 and 2.1e-5. The float64 test
below holds the port to that floor directly.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wct_tpu.models import cascade as jcascade
from wct_tpu.models import decoder as jdec
from wct_tpu.models import vgg as jvgg
from wct_tpu.train import checkpoint as jck
from wct_tpu_torch.models import cascade as tcascade
from wct_tpu_torch.models import decoder as tdec
from wct_tpu_torch.models import vgg as tvgg
from wct_tpu_torch.train import checkpoint as tck

BUNDLE = Path(__file__).resolve().parent.parent / "weights" / "bundle.npz"
SIZE = 64
REL = {"relu5_1": 2e-5}


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
    jparams = jck.load_pytree(BUNDLE)
    tparams = tck.params_from_numpy(tree, "cpu")
    x = np.random.default_rng(3).random((2, SIZE, SIZE, 3)).astype(np.float32)
    jfeats = jax.tree.map(
        np.asarray, jvgg.encode_multi(jparams["encoder"], jnp.asarray(x), jvgg.RELU_TARGETS)
    )
    return jparams, tparams, x, jfeats


def _assert_close(got, ref, what, rel=None):
    assert got.shape == ref.shape, what
    rel = rel or REL.get(what, 1e-5)
    scale = float(np.abs(ref).max())
    err = float(np.abs(got.astype(np.float64) - ref).max())
    assert err <= rel * scale, f"{what}: max err {err:.3e} > {rel} × {scale:.3e}"


def test_layer_specs_match_reference():
    assert tvgg.ENCODER_LAYERS == jvgg.ENCODER_LAYERS
    assert tvgg.RELU_TARGETS == jvgg.RELU_TARGETS
    assert tvgg.TARGET_CHANNELS == jvgg.TARGET_CHANNELS
    assert tvgg.TARGET_SCALE == jvgg.TARGET_SCALE
    for t in jvgg.RELU_TARGETS:
        assert tvgg.layers_to(t) == jvgg.layers_to(t)
        assert tdec.decoder_layers(t) == jdec.decoder_layers(t)
    with pytest.raises(ValueError):
        tvgg.layers_to("relu9_1")


def test_init_params_layout_matches_bridge():
    """Random init has the bridge's tree: same keys, OIHW shapes, f32."""
    ref = tck.params_from_numpy(
        jax.tree.map(np.asarray, jcascade.init_params(jax.random.PRNGKey(0))), "cpu"
    )
    ours = tcascade.init_params(0, device="cpu")
    flat_ref, flat_ours = tck._flatten(ref), tck._flatten(ours)
    assert sorted(flat_ref) == sorted(flat_ours)
    for k, v in flat_ref.items():
        assert flat_ours[k].shape == v.shape and flat_ours[k].dtype == v.dtype, k
    np.testing.assert_array_equal(flat_ours["encoder/conv0/w"], flat_ref["encoder/conv0/w"])


@pytest.mark.parametrize("compose_pre", [False, True])
def test_encode_multi_every_target(setup, compose_pre):
    jparams, tparams, x, jfeats = setup
    ours = tvgg.encode_multi(
        tparams["encoder"], torch.from_numpy(x), tvgg.RELU_TARGETS, compose_pre=compose_pre
    )
    assert sorted(ours) == sorted(tvgg.RELU_TARGETS)
    for t in tvgg.RELU_TARGETS:
        _assert_close(ours[t].numpy(), jfeats[t], t)


def test_encode_multi_float64_floor(setup):
    """The port in f32 against itself in float64: at most 3e-5 of each map's max."""
    jparams, tparams, x, jfeats = setup
    p64 = {k: {n: t.double() for n, t in v.items()} for k, v in tparams["encoder"].items()}
    ref = tvgg.encode_multi(p64, torch.from_numpy(x).double(), tvgg.RELU_TARGETS)
    ours = tvgg.encode_multi(tparams["encoder"], torch.from_numpy(x), tvgg.RELU_TARGETS)
    for t in tvgg.RELU_TARGETS:
        _assert_close(ours[t].numpy(), ref[t].numpy(), t, rel=3e-5)


@pytest.mark.parametrize("target", ["relu1_1", "relu3_1", "relu5_1"])
def test_encode_single_target(setup, target):
    jparams, tparams, x, jfeats = setup
    _assert_close(
        tvgg.encode(tparams["encoder"], torch.from_numpy(x), target).numpy(),
        jfeats[target], target,
    )


@pytest.mark.parametrize("target", ["relu2_1", "relu4_1"])
def test_encode_from_pool1(setup, target):
    jparams, tparams, x, jfeats = setup
    # Any [B, H/2, W/2, 64] state will do: pooled relu1_1 features.
    p1 = jfeats["relu1_1"].reshape(2, SIZE // 2, 2, SIZE // 2, 2, 64).max((2, 4))
    ref = np.asarray(jvgg.encode_from_pool1(jparams["encoder"], jnp.asarray(p1), target))
    got = tvgg.encode_from_pool1(tparams["encoder"], torch.from_numpy(p1), target).numpy()
    _assert_close(got, ref, target)
    with pytest.raises(ValueError):
        tvgg.encode_from_pool1(tparams["encoder"], torch.from_numpy(p1), "relu1_1")


@pytest.mark.parametrize("target", ["relu1_1", "relu2_1", "relu3_1", "relu4_1", "relu5_1"])
def test_decode(setup, target):
    """Each trained decoder on the reference encoder's features."""
    jparams, tparams, x, jfeats = setup
    f = jfeats[target]
    ref = np.asarray(jdec.decode(jparams["decoders"][target], jnp.asarray(f), target))
    got = tdec.decode(tparams["decoders"][target], torch.tensor(f), target).numpy()
    assert got.shape == (2, SIZE, SIZE, 3)
    _assert_close(got, ref, target)
