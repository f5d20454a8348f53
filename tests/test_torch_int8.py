"""The int8 conv (``ops/convs.py``) against ``wct_tpu/ops/convs.py:201-257``.

Quantized weights must be the reference's bits (HWIO there, OIHW here),
the integer sums exact, and the outputs the reference's within 1e-6
relative; the reference's own bound against the f32 conv
(``tests/test_convs.py:170-190``: relative max < 0.02) and its static
activation scale hold too.
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
    parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


SHAPES = [((2, 16, 16, 8), (3, 3, 8, 16)), ((1, 12, 20, 64), (3, 3, 64, 64)),
          ((1, 8, 8, 512), (3, 3, 512, 24)), ((2, 6, 6, 5), (1, 1, 5, 7))]
IDS = ["8to16", "64to64", "512to24", "1x1_5to7"]


def _case(seed, shape, wshape):
    rng = np.random.default_rng(seed)
    x = np.abs(rng.standard_normal(shape)).astype(np.float32)
    w = rng.standard_normal(wshape).astype(np.float32)
    b = rng.standard_normal(wshape[3]).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("shape,wshape", SHAPES, ids=IDS)
def test_quantized_weights_are_the_references_bits(shape, wshape):
    _, w, _ = _case(0, shape, wshape)
    w[..., 0] = 0.0  # an all-zero channel takes the 1e-12 floor
    w[0, 0, 0, 1] = -2.5 * np.abs(w[..., 1]).max()  # an extreme that maps to -127
    jq, js = jconvs.quantize_weight_int8(jnp.asarray(w))
    tq, ts = tconvs.quantize_weight_int8(tconvs.oihw_from_hwio(w))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_rounding_is_half_to_even():
    """A weight of exactly k + ½ steps rounds to the even k, as jnp.round."""
    w = np.broadcast_to(np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5], np.float32)[None, :, None, None],
                        (1, 6, 1, 1)).copy()
    tq, ts = tconvs.quantize_weight_int8(torch.from_numpy(w))
    assert float(ts[0]) == 1.0
    assert tq.flatten().tolist() == [127, 0, 2, 2, 0, -2]


@pytest.mark.parametrize("shape,wshape", SHAPES, ids=IDS)
def test_outputs_match_reference(shape, wshape):
    """Measured: the same bits (the sums are exact, the dequantization
    is the reference's order)."""
    x, w, b = _case(1, shape, wshape)
    jq, js = jconvs.quantize_weight_int8(jnp.asarray(w))
    ref = np.asarray(jconvs.conv2d_reflect_int8(jnp.asarray(x), jq, js, jnp.asarray(b)))
    tq, ts = tconvs.quantize_weight_int8(tconvs.oihw_from_hwio(w))
    got = tconvs.conv2d_reflect_int8(torch.from_numpy(x), tq, ts, torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert np.abs(got.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()


def test_close_to_f32_conv():
    """The reference's bound, ``tests/test_convs.py:170-190``."""
    x, w, b = _case(2, (2, 16, 16, 8), (3, 3, 8, 16))
    tw = tconvs.oihw_from_hwio(w)
    ref = tconvs.conv2d_reflect(torch.from_numpy(x), tw, torch.from_numpy(b))
    tq, ts = tconvs.quantize_weight_int8(tw)
    out = tconvs.conv2d_reflect_int8(torch.from_numpy(x), tq, ts, torch.from_numpy(b))
    rel = float((out - ref).abs().max() / ref.abs().max().clamp_min(1e-6))
    assert rel < 0.02, rel


def test_static_scale_matches_reference():
    """A static ``act_scale`` equal to the dynamic one gives the same
    output; a static scale of its own is the reference's."""
    x, w, _ = _case(3, (1, 8, 8, 4), (3, 3, 4, 4))
    b = np.zeros(4, np.float32)
    tq, ts = tconvs.quantize_weight_int8(tconvs.oihw_from_hwio(w))
    tx, tb = torch.from_numpy(x), torch.from_numpy(b)
    dyn = tconvs.conv2d_reflect_int8(tx, tq, ts, tb)
    sx = float(np.abs(x).max()) / 127.0
    assert torch.equal(tconvs.conv2d_reflect_int8(tx, tq, ts, tb, act_scale=sx), dyn)
    jq, js = jconvs.quantize_weight_int8(jnp.asarray(w))
    ref = np.asarray(jconvs.conv2d_reflect_int8(jnp.asarray(x), jq, js, jnp.asarray(b), act_scale=0.01))
    got = tconvs.conv2d_reflect_int8(tx, tq, ts, tb, act_scale=0.01).numpy()
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


@pytest.mark.parametrize("shape,wshape", SHAPES + [((1, 2, 3, 3), (3, 3, 3, 5))],
                         ids=IDS + ["few_rows"])
def test_card_patch_route_sums_exactly(shape, wshape):
    """The card's route (patches × weights, both zero-padded to multiples
    of 8 and at least 17 rows, as ``torch._int_mm`` needs) with an exact
    int32 product standing in for cuBLASLt's: the float64 conv's sums,
    bitwise, at the largest magnitudes (every entry ±127)."""
    rng = np.random.default_rng(4)
    b, h, w, ci = shape
    k, co = wshape[0], wshape[3]
    xq = torch.from_numpy(rng.choice([-127, 127], (b, ci, h + k - 1, w + k - 1)).astype(np.int8))
    wq = torch.from_numpy(rng.choice([-127, 127], (co, ci, k, k)).astype(np.int8))

    def exact_mm(a, m):
        assert a.shape[0] > 16 and a.shape[1] % 8 == 0 and m.shape[1] % 8 == 0
        return (a.long() @ m.long()).to(torch.int32)

    got = tconvs._int8_sums_by_patches(xq, wq, exact_mm)
    ref = tconvs.conv2d_int8_sums_nchw(xq, wq)
    assert got.dtype == ref.dtype == torch.int32 and torch.equal(got, ref)
