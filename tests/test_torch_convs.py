"""Port conv primitives against ``wct_tpu.ops.convs`` and manual numpy.

Same NHWC inputs (numpy, seeded) through both packages; the port's
weights are the same HWIO arrays through the weight bridge (OIHW).
f32 throughout, bound 1e-5 (atol and rtol) against JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wct_tpu.ops import convs as jconvs
from wct_tpu_torch.ops import convs as tconvs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite runs in
    parallel workers, and torch's OpenMP threads spinning on a loaded
    machine made a 30-step test take 150 s instead of 1."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.mark.parametrize(
    "shape,k,co",
    [
        ((2, 8, 8, 5), 3, 6),
        ((1, 6, 10, 3), 3, 4),
        ((1, 5, 5, 2), 3, 4),
        ((1, 2, 2, 3), 3, 4),  # H == 2·pad + 0: smallest map reflect allows
        ((2, 5, 5, 3), 5, 6),
        ((2, 7, 7, 3), 1, 5),  # 1×1: no pad
    ],
)
def test_conv2d_reflect_matches_jax(rng, shape, k, co):
    x = rng.standard_normal(shape).astype(np.float32)
    w = rng.standard_normal((k, k, shape[-1], co)).astype(np.float32)
    b = rng.standard_normal((co,)).astype(np.float32)
    ref = np.asarray(jconvs.conv2d_reflect(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    got = tconvs.conv2d_reflect(_t(x), _oihw(w), _t(b)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("case", ["conv3x3_5x5", "conv1x1"])
def test_conv2d_reflect_manual(rng, case):
    """The hand-computed cases of tests/test_convs.py."""
    if case == "conv3x3_5x5":
        x = rng.standard_normal((1, 5, 5, 2)).astype(np.float32)
        w = rng.standard_normal((3, 3, 2, 4)).astype(np.float32)
        b = rng.standard_normal((4,)).astype(np.float32)
        xp = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)), mode="reflect")
        ref = np.zeros((1, 5, 5, 4), np.float32)
        for i in range(5):
            for j in range(5):
                patch = xp[0, i : i + 3, j : j + 3, :]
                ref[0, i, j] = np.tensordot(patch, w, axes=([0, 1, 2], [0, 1, 2])) + b
    else:
        x = rng.standard_normal((1, 4, 4, 3)).astype(np.float32)
        w = rng.standard_normal((1, 1, 3, 5)).astype(np.float32)
        b = np.zeros((5,), np.float32)
        ref = x @ w[0, 0]
    got = tconvs.conv2d_reflect(_t(x), _oihw(w), _t(b)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize(
    "op,shape,arg",
    [
        ("pad_reflect", (2, 5, 6, 3), 1),
        ("pad_reflect", (2, 5, 6, 3), 2),
        ("pad_reflect", (1, 4, 4, 2), 0),
        ("maxpool2", (1, 4, 6, 2), None),
        ("maxpool2", (2, 5, 7, 3), None),  # odd sizes floor (VALID)
        ("upsample_nearest2", (1, 2, 3, 2), None),
        ("upsample_nearest2", (2, 3, 3, 4), None),
    ],
)
def test_data_movement_ops_exact(rng, op, shape, arg):
    """Pads, pools and upsamples move values: equal to JAX and numpy, bit for bit."""
    x = rng.standard_normal(shape).astype(np.float32)
    args = () if arg is None else (arg,)
    ref = np.asarray(getattr(jconvs, op)(jnp.asarray(x), *args))
    got = getattr(tconvs, op)(_t(x), *args).numpy()
    np.testing.assert_array_equal(got, ref)
    if op == "pad_reflect":
        p = ((0, 0), (arg, arg), (arg, arg), (0, 0))
        np.testing.assert_array_equal(got, np.pad(x, p, mode="reflect"))
    elif op == "maxpool2":
        b, h, w, c = shape
        crop = x[:, : h // 2 * 2, : w // 2 * 2]
        np.testing.assert_array_equal(
            got, crop.reshape(b, h // 2, 2, w // 2, 2, c).max(axis=(2, 4))
        )
    else:
        np.testing.assert_array_equal(got, np.repeat(np.repeat(x, 2, axis=1), 2, axis=2))


def test_compose_1x1_into_conv_matches_jax_and_chain(rng):
    w0 = rng.standard_normal((1, 1, 3, 3)).astype(np.float32)
    b0 = rng.standard_normal((3,)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 8)).astype(np.float32)
    b = rng.standard_normal((8,)).astype(np.float32)
    jw, jb = jconvs.compose_1x1_into_conv(*map(jnp.asarray, (w0, b0, w, b)))
    tw, tb = tconvs.compose_1x1_into_conv(_oihw(w0), _t(b0), _oihw(w), _t(b))
    np.testing.assert_allclose(tw.numpy(), _oihw(np.asarray(jw)).numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-5, rtol=1e-5)
    x = _t(rng.random((2, 6, 7, 3)).astype(np.float32))
    chain = tconvs.conv2d_reflect(tconvs.conv2d_reflect(x, _oihw(w0), _t(b0)), _oihw(w), _t(b))
    composed = tconvs.conv2d_reflect(x, tw, tb)
    np.testing.assert_allclose(composed.numpy(), chain.numpy(), atol=1e-5, rtol=1e-5)
