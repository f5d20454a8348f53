"""The port's style-swap against ``wct_tpu.ops.style_swap``.

The same numpy features through both packages: patch extraction is
held bitwise, the swap to the same argmax everywhere and 1e-5 of the
map's largest |value| (measured ≤ 1.2e-7), the whitened swap through
``eigh`` to 1e-5 (measured 6.9e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wct_tpu.ops import reductions as jred
from wct_tpu.ops import style_swap as jswap
from wct_tpu.tools.oracle import style_swap_np
from wct_tpu_torch.ops import style_swap as tswap

BOUND = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite runs in
    parallel workers, and torch's OpenMP threads spinning on a loaded
    machine made a 30-step test take 150 s instead of 1."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _close(got, ref, bound=BOUND):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= bound * np.abs(ref).max(), f"max err {err:.3e}, scale {np.abs(ref).max():.3e}"


@pytest.mark.parametrize("shape,ps,stride", [((5, 6, 2), 3, 1), ((7, 7, 1), 3, 2),
                                             ((9, 11, 6), 3, 1), ((10, 9, 4), 4, 3)])
def test_extract_patches_bitwise(shape, ps, stride):
    f = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jswap.extract_patches(jnp.asarray(f), ps, stride))
    got = tswap.extract_patches(torch.from_numpy(f), ps, stride).numpy()
    np.testing.assert_array_equal(got, ref)


def _reference_argmax(fc, fs, ps, stride):
    """The patch each location takes under the reference's rule, from its
    own filters and norms; and from a float64 evaluation of the rule."""
    filters = jswap.extract_patches(jnp.asarray(fs), ps, stride)
    p = filters.shape[-1]
    norms = jnp.sqrt(jred.sum0((filters * filters).reshape(-1, p)))
    fn = filters / jnp.maximum(norms, 1e-8)
    corr = jax.lax.conv_general_dilated(jnp.asarray(fc)[None], fn, (stride, stride), "VALID",
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    f64 = np.asarray(filters, np.float64)
    fn64 = f64 / np.maximum(np.sqrt((f64**2).reshape(-1, p).sum(0)), 1e-8)
    h, w = fc.shape[:2]
    best64 = np.array([[np.tensordot(fc[i : i + ps, j : j + ps].astype(np.float64), fn64, 3).argmax()
                        for j in range(0, w - ps + 1, stride)] for i in range(0, h - ps + 1, stride)])
    return np.asarray(corr[0].argmax(-1)), best64


@pytest.mark.parametrize("shape_c,shape_s,stride", [((8, 8, 4), (8, 8, 4), 1),
                                                    ((10, 9, 6), (7, 8, 6), 1),
                                                    ((9, 9, 4), (9, 9, 4), 2),
                                                    ((12, 10, 16), (11, 12, 16), 1)])
def test_style_swap_matches_reference(shape_c, shape_s, stride):
    """The same argmax as the reference and as float64 at every location,
    and the same map."""
    rng = np.random.default_rng(1)
    fc = rng.standard_normal(shape_c).astype(np.float32)
    fs = rng.standard_normal(shape_s).astype(np.float32)
    _, filters_n = tswap._filters(torch.from_numpy(fs).permute(2, 0, 1)[None], 3, stride)
    best = tswap._best_patches(torch.from_numpy(fc).permute(2, 0, 1)[None], filters_n, stride)
    ref_best, best64 = _reference_argmax(fc, fs, 3, stride)
    np.testing.assert_array_equal(best[0].numpy(), ref_best)
    np.testing.assert_array_equal(best[0].numpy(), best64)
    for ss_alpha in (0.7, 1.0):  # 1.0: the rebuilt map alone
        ref = np.asarray(jswap.style_swap(jnp.asarray(fc), jnp.asarray(fs), ss_alpha, 3, stride))
        got = tswap.style_swap(torch.from_numpy(fc), torch.from_numpy(fs), ss_alpha, 3, stride)
        _close(got.numpy(), ref)
    _close(got.numpy(), style_swap_np(fc, fs, 1.0, 3, stride))


def test_deconv_patches_matches_reference():
    rng = np.random.default_rng(2)
    filters = rng.standard_normal((3, 3, 5, 12)).astype(np.float32)
    best = rng.integers(0, 12, (1, 4, 6))
    one_hot = np.eye(12, dtype=np.float32)[best]
    for stride in (1, 2):
        ref = jswap._deconv_patches(jnp.asarray(one_hot), jnp.asarray(filters), stride)
        got = tswap._deconv_patches(torch.from_numpy(one_hot), torch.from_numpy(filters), stride)
        _close(got.numpy(), ref)


def test_self_swap_is_identity_and_ss_alpha0():
    rng = np.random.default_rng(3)
    f = torch.from_numpy(rng.standard_normal((8, 8, 4)).astype(np.float32))
    torch.testing.assert_close(tswap.style_swap(f, f, 1.0), f, atol=1e-5, rtol=0)
    fs = torch.from_numpy(rng.standard_normal((8, 8, 4)).astype(np.float32))
    assert torch.equal(tswap.style_swap(f, fs, 0.0), f)


@pytest.mark.parametrize("method", ["eigh", "newton_schulz", "newton_schulz_pallas"])
def test_wct_style_swap_matches_reference(method):
    rng = np.random.default_rng(4)
    fc = rng.standard_normal((12, 12, 6)).astype(np.float32)
    fs = (rng.standard_normal((10, 11, 6)) * 1.5 + 0.3).astype(np.float32)
    ref = jswap.wct_style_swap(jnp.asarray(fc), jnp.asarray(fs), 0.8, 0.6,
                               method="newton_schulz" if method != "eigh" else method)
    got = tswap.wct_style_swap(torch.from_numpy(fc), torch.from_numpy(fs), 0.8, 0.6,
                               method=method)
    _close(got.numpy(), ref, BOUND if method == "eigh" else 5e-5)


def test_batched_swap_is_per_image():
    """An image's swap is the same bits alone and in a batch."""
    rng = np.random.default_rng(5)
    fc = torch.from_numpy(rng.standard_normal((3, 8, 9, 10)).astype(np.float32))
    fs = torch.from_numpy(rng.standard_normal((1, 8, 7, 11)).astype(np.float32))
    out = tswap.style_swap_nchw(fc, fs, 0.6)
    assert out.shape == fc.shape
    assert torch.equal(tswap.style_swap_nchw(fc[1:2], fs, 0.6)[0], out[1])


def test_undersized_maps_raise_the_reference_error():
    fc = np.zeros((2, 8, 4), np.float32)
    fs = np.zeros((8, 8, 4), np.float32)
    with pytest.raises(ValueError) as ref:
        jswap.style_swap(jnp.asarray(fc), jnp.asarray(fs))
    with pytest.raises(ValueError) as got:
        tswap.style_swap(torch.from_numpy(fc), torch.from_numpy(fs))
    assert str(got.value) == str(ref.value)
    assert "style_swap needs feature maps" in str(got.value)
