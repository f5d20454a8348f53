"""The port's junction module against ``wct_tpu/ops/junction_pallas.py``.

The JAX functions run as the JAX package runs them on the CPU (their
``pallas_call`` goes to interpret mode); the port runs its plain
PyTorch versions, which are what its CUDA kernels are held against on
the card. Trained-bundle weights, inputs from a numpy seed. conv0's
weights are O(255) and the maps O(10–100), so every comparison is
relative to the reference map's largest value.
"""

import inspect
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wct_tpu.models import decoder as jdec
from wct_tpu.ops import junction_pallas as jjunction
from wct_tpu.ops import wct as jwct
from wct_tpu.train import checkpoint as jck
from wct_tpu_torch.models import decoder as tdec
from wct_tpu_torch.models import vgg as tvgg
from wct_tpu_torch.ops import junction as tjunction
from wct_tpu_torch.ops import wct as twct
from wct_tpu_torch.train import checkpoint as tck

BUNDLE = Path(__file__).resolve().parent.parent / "weights" / "bundle.npz"
HEAD = ("conv0", "conv1_1", "conv1_2")


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
    raw = jck.load_pytree(BUNDLE)
    return raw, tck.params_from_numpy(tck.load_pytree(BUNDLE), "cpu")


def _head_args(bundle):
    jp, tp = bundle
    ja = [jnp.asarray(jp["encoder"][n][k]) for n in HEAD for k in ("w", "b")]
    ta = [tp["encoder"][n][k] for n in HEAD for k in ("w", "b")]
    return ja, ta


def _rel(got, ref):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    return np.abs(got - ref).max() / np.abs(ref).max()


def _oihw(w_hwio):
    return np.asarray(w_hwio).transpose(3, 2, 0, 1)


def test_fold_conv0(bundle):
    """Exact up to f32 rounding of a 3-term sum of O(255) products."""
    ja, ta = _head_args(bundle)
    jw, jb = jjunction.fold_conv0(*ja[:4])
    tw, tb = tjunction.fold_conv0(*ta[:4])
    assert _rel(tw.numpy(), _oihw(jw)) <= 1e-6
    assert _rel(tb.numpy(), jb) <= 1e-6


@pytest.mark.parametrize("diagonal", [False, True], ids=["dense", "diagonal"])
def test_fold_affine_into_conv(bundle, diagonal):
    """Same einsum in both packages; 64-term f32 sums, bound 1e-6 relative."""
    jp, tp = bundle
    rng = np.random.default_rng(1)
    m = rng.standard_normal((2, 64) if diagonal else (2, 64, 64)).astype(np.float32)
    bias = rng.standard_normal((2, 64)).astype(np.float32)
    jc, tc = jp["decoders"]["relu1_1"]["dec_conv1_1"], tp["decoders"]["relu1_1"]["dec_conv1_1"]
    jw, jb = jdec.fold_affine_into_conv(
        jnp.asarray(m), jnp.asarray(bias), jnp.asarray(jc["w"]), jnp.asarray(jc["b"]))
    tw, tb = tdec.fold_affine_into_conv(
        torch.from_numpy(m), torch.from_numpy(bias), tc["w"], tc["b"])
    assert tuple(tw.shape) == (2, 3, 64, 3, 3) and tuple(tb.shape) == (2, 3)
    assert _rel(tw.numpy(), np.asarray(jw).transpose(0, 4, 3, 1, 2)) <= 1e-6
    assert _rel(tb.numpy(), jb) <= 1e-6


@pytest.mark.parametrize("target", tvgg.RELU_TARGETS)
def test_has_standard_tail_and_tail_weights(bundle, target):
    jp, tp = bundle
    assert tdec.has_standard_tail(target) == jdec.has_standard_tail(target)
    assert tdec.has_standard_tail(target) == (target != "relu1_1")
    if target == "relu1_1":
        with pytest.raises(ValueError):
            tdec.decode_partial(tp["decoders"][target], torch.zeros(1, 4, 4, 64), target)
        return
    jt = jdec.tail_weights(jp["decoders"][target], target)
    tt = tdec.tail_weights(tp["decoders"][target], target)
    assert [tuple(t.shape) for t in tt] == [(64, 64, 3, 3), (64,), (3, 64, 3, 3), (3,)]
    for j, t in zip(jt, tt):
        j = np.asarray(j)
        np.testing.assert_array_equal(t.numpy(), _oihw(j) if j.ndim == 4 else j)


@pytest.mark.parametrize("target", ["relu2_1", "relu3_1", "relu4_1"])
def test_decode_partial(bundle, target):
    """The decoder up to its [upsample, conv, conv] tail; f32 convs of up
    to 4608-term sums, bound 1e-5 relative to the map's max."""
    jp, tp = bundle
    rng = np.random.default_rng(2)
    f = rng.random((2, 4, 6, tvgg.TARGET_CHANNELS[target])).astype(np.float32)
    ref = jdec.decode_partial(jp["decoders"][target], jnp.asarray(f), target)
    got = tdec.decode_partial(tp["decoders"][target], torch.from_numpy(f), target)
    assert got.shape[-1] == 64 and got.shape[1] * 2 == 4 * tvgg.TARGET_SCALE[target]
    assert _rel(got.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("method", ["eigh", "newton_schulz_pallas"])
@pytest.mark.parametrize("alpha", [0.0, 0.6, 1.0])
def test_wct_transform(method, alpha):
    """(M, bias) against the reference's, and ``f @ M + bias`` against the
    port's own ``wct_from_stats``. Matrix square roots of a 32-channel
    Gram in f32: bound 2e-4 relative (eigh's eigenvectors differ between
    LAPACK builds by more than Newton–Schulz's products do)."""
    rng = np.random.default_rng(3)
    mix = rng.standard_normal((32, 32)).astype(np.float32) / 4
    fc = (rng.standard_normal((12, 10, 32)).astype(np.float32) @ mix + 0.5)
    fs = (rng.standard_normal((9, 11, 32)).astype(np.float32) @ mix.T + 0.2)
    jstats = jwct.style_stats(jnp.asarray(fs), method=method)
    tstats = twct.style_stats(torch.from_numpy(fs), method=method)
    jm, jb = jwct.wct_transform(jnp.asarray(fc), jstats, alpha, method=method)
    tm, tb = twct.wct_transform(torch.from_numpy(fc), tstats, alpha, method=method)
    assert tuple(tm.shape) == (32, 32) and tuple(tb.shape) == (32,)
    if alpha == 0.0:
        np.testing.assert_array_equal(tm.numpy(), np.eye(32, dtype=np.float32))
        np.testing.assert_array_equal(tb.numpy(), np.zeros(32, np.float32))
    else:
        assert _rel(tm.numpy(), jm) <= 2e-4
        assert np.abs(tb.numpy() - np.asarray(jb)).max() <= 2e-4 * max(1.0, np.abs(jb).max())
    applied = torch.from_numpy(fc).reshape(-1, 32) @ tm + tb
    direct = twct.wct_from_stats(torch.from_numpy(fc), tstats, alpha, method=method)
    assert _rel(applied.reshape(fc.shape).numpy(), direct.numpy()) <= 1e-5


def test_wct_transform_grouped_not_ported():
    """Grouped WCT is ported: its affine is the dense block-diagonal
    expansion the reference gives the fold (measured 1.4e-6 of the max),
    and ungrouped style statistics are refused with the reference's error."""
    rng = np.random.default_rng(6)
    fc = rng.random((6, 5, 8)).astype(np.float32)
    fs = rng.random((5, 7, 8)).astype(np.float32)
    jstats = jwct.style_stats(jnp.asarray(fs), groups=2)
    tstats = twct.style_stats(torch.from_numpy(fs), groups=2)
    jm, jb = jwct.wct_transform(jnp.asarray(fc), jstats, 0.5, groups=2)
    tm, tb = twct.wct_transform(torch.from_numpy(fc), tstats, 0.5, groups=2)
    assert tuple(tm.shape) == (8, 8)
    assert not tm[:4, 4:].any() and not tm[4:, :4].any()
    assert _rel(tm.numpy(), jm) <= 1e-5
    assert np.abs(tb.numpy() - np.asarray(jb)).max() <= 1e-5 * max(1.0, np.abs(jb).max())
    with pytest.raises(ValueError) as ref:
        jwct.wct_transform(jnp.asarray(fc), jwct.style_stats(jnp.asarray(fs)), 0.5, groups=2)
    with pytest.raises(ValueError) as got:
        twct.wct_transform(torch.from_numpy(fc), twct.style_stats(torch.from_numpy(fs)), 0.5,
                           groups=2)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize("shape", [(2, 48, 32), (1, 16, 16)], ids=["48x32", "one_tile"])
def test_encoder_head(bundle, shape):
    """Two convs of ≤ 576-term f32 sums in another order: 1e-5 of the max."""
    ja, ta = _head_args(bundle)
    img = np.random.default_rng(4).random((*shape, 3)).astype(np.float32)
    ref = jjunction.encoder_head(jnp.asarray(img), *ja)
    got = tjunction.encoder_head(torch.from_numpy(img), *ta)
    assert tuple(got.shape) == (shape[0], shape[1] // 2, shape[2] // 2, 64)
    assert _rel(got.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
@pytest.mark.parametrize("deep", [True, False], ids=["deep", "shallow"])
@pytest.mark.parametrize("hw", [(16, 16), (8, 24)], ids=["d16x16", "one_tile_high"])
def test_junction(bundle, hw, deep, clip):
    """Four convs in a row, conv0's O(255) scale in the third: 1e-4 of the
    max (measured ≤ 2.3e-5). ``d`` is scaled so that the rgb stage leaves
    [0, 1] and the clip acts."""
    jp, tp = bundle
    ja, ta = _head_args(bundle)
    d = (np.random.default_rng(5).random((1, *hw, 64)) * 20).astype(np.float32)
    jt = [jnp.asarray(a) for a in jdec.tail_weights(jp["decoders"]["relu2_1"], "relu2_1")]
    tt = tdec.tail_weights(tp["decoders"]["relu2_1"], "relu2_1")
    ref = jjunction.junction(jnp.asarray(d), *jt, *ja, deep=deep, clip=clip)
    got = tjunction.junction(torch.from_numpy(d), *tt, *ta, deep=deep, clip=clip)
    scale = 1 if deep else 2
    assert tuple(got.shape) == (1, hw[0] * scale, hw[1] * scale, 64)
    assert _rel(got.numpy(), ref) <= 1e-4
    other = tjunction.junction(torch.from_numpy(d), *tt, *ta, deep=deep, clip=not clip)
    assert not torch.equal(got, other), "the clip did not act on this input"


@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
@pytest.mark.parametrize("shape", [(2, 16, 32), (1, 48, 16)], ids=["16x32", "48x16"])
def test_decoder_tail(bundle, shape, clip):
    """One conv of 576-term f32 sums with per-image weights: 1e-5 of the max."""
    rng = np.random.default_rng(6)
    f = rng.random((*shape, 64)).astype(np.float32)
    w = (rng.standard_normal((shape[0], 3, 3, 64, 3)) * 0.1).astype(np.float32)
    b = rng.standard_normal((shape[0], 3)).astype(np.float32)
    ref = jjunction.decoder_tail(jnp.asarray(f), jnp.asarray(w), jnp.asarray(b), clip=clip)
    got = tjunction.decoder_tail(
        torch.from_numpy(f), torch.from_numpy(w.transpose(0, 4, 3, 1, 2).copy()),
        torch.from_numpy(b), clip)
    assert tuple(got.shape) == (*shape, 3)
    assert np.abs(got.numpy() - np.asarray(ref)).max() <= 1e-5 * max(1.0, np.abs(ref).max())
    if clip:
        assert got.min() >= 0.0 and got.max() <= 1.0
        assert float((got == 0).float().mean()) > 0.01  # the clip acted


@pytest.mark.parametrize(
    "case", ["h_not_16", "w_not_16", "c_not_64", "rank", "dtype", "deep_no_w12"])
def test_wrappers_reject_bad_input(bundle, case):
    _, ta = _head_args(bundle)
    _, tp = bundle
    tt = tdec.tail_weights(tp["decoders"]["relu2_1"], "relu2_1")
    err = TypeError if case == "dtype" else ValueError
    with pytest.raises(err):
        if case == "h_not_16":
            tjunction.encoder_head(torch.zeros(1, 24, 16, 3), *ta)
        elif case == "w_not_16":
            tjunction.decoder_tail(torch.zeros(1, 16, 8, 64), torch.zeros(1, 3, 64, 3, 3),
                                   torch.zeros(1, 3))
        elif case == "c_not_64":
            tjunction.junction(torch.zeros(1, 8, 8, 32), *tt, *ta)
        elif case == "rank":
            tjunction.junction_nchw(torch.zeros(64, 8, 8), *tt, *ta)
        elif case == "dtype":
            tjunction.encoder_head(torch.zeros(1, 16, 16, 3, dtype=torch.float64), *ta)
        else:
            tjunction.junction(torch.zeros(1, 8, 8, 64), *tt, *ta[:4])


def test_cpu_tensor_takes_plain_version_and_launches_nothing(bundle):
    _, ta = _head_args(bundle)
    counts = [f.launches for f in (tjunction.encoder_head_cuda, tjunction.junction_cuda,
                                   tjunction.decoder_tail_cuda)]
    tjunction.encoder_head(torch.rand(1, 16, 16, 3), *ta)
    tjunction.decoder_tail(torch.rand(1, 16, 16, 64), torch.rand(1, 3, 64, 3, 3), torch.rand(1, 3))
    assert counts == [f.launches for f in (tjunction.encoder_head_cuda, tjunction.junction_cuda,
                                           tjunction.decoder_tail_cuda)]
    for fn in (tjunction.encoder_head_cuda, tjunction.decoder_tail_cuda):
        with pytest.raises(ValueError, match="CUDA tensor"):
            fn(torch.zeros(1, 3 if fn is tjunction.encoder_head_cuda else 64, 16, 16),
               *([None] * (4 if fn is tjunction.encoder_head_cuda else 2)))


def test_meta_device_raises(bundle):
    _, ta = _head_args(bundle)
    with pytest.raises(ValueError, match="no encoder_head kernel for device"):
        tjunction.encoder_head_nchw(torch.zeros(1, 3, 16, 16, device="meta"), *ta)


def test_no_try_around_a_launch():
    """No fallback from kernel to plain: the module has no ``try`` at all."""
    src = inspect.getsource(tjunction)
    assert "try:" not in src and "except" not in src


def test_tf32_rounds_to_nearest_ties_away():
    """``_tf32`` keeps 10 mantissa bits, rounding half-way cases away from
    zero, as ``cvt.rna.tf32.f32`` does; ``hi + lo`` keeps f32's value to
    2⁻²² relative."""
    one = torch.tensor([1.0, -1.0])
    half_ulp = 2.0**-11  # half of TF32's ulp at 1
    assert torch.equal(tjunction._tf32(one * (1 + half_ulp)), one * (1 + 2.0**-10))
    assert torch.equal(tjunction._tf32(one * (1 + half_ulp * 0.99)), one)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(10000).astype(np.float32))
    hi = tjunction._tf32(x)
    assert int((hi.view(torch.int32) & 0x1FFF).abs().max()) == 0
    lo = tjunction._tf32(x - hi)
    assert float(((hi + lo - x).abs() / x.abs()).max()) <= 2.0**-21


def test_tc_frags_layout():
    """The f32 head's tensor-core operand (``_head_weights``): conv1_2 in the
    ``wgmma`` layout ``[tap][half][hi, lo][64 rows × 32]``, the 16-byte
    chunk ``k // 4`` of row ``co`` stored at chunk ``(k // 4) ^ (co % 8)``,
    holding hi = tf32(w[co, 32·half + k, tap]) and lo = tf32(w − hi);
    conv1_1 as ``[ci][tap][co]`` taps for the FFMA stage."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((64, 64, 3, 3)).astype(np.float32))
    we1 = torch.from_numpy(rng.standard_normal((64, 3, 3, 3)).astype(np.float32))
    t1, c1, t2, c2 = tjunction._head_weights(we1, torch.zeros(64), w, torch.ones(64),
                                             torch.float32)
    assert t1.shape == (3, 9, 64) and torch.equal(t1[2, 7, 5], we1[5, 2, 7 // 3, 7 % 3])
    assert t2.shape == (9, 2, 2, 2048) and t2.is_contiguous() and torch.equal(c2, torch.ones(64))
    for tap, half, co, k in [(5, 1, 13, 22), (0, 0, 0, 0), (8, 1, 63, 31)]:
        v = w[co, 32 * half + k, tap // 3, tap % 3]
        idx = co * 32 + ((k // 4) ^ (co % 8)) * 4 + k % 4
        hi, lo = t2[tap, half, 0, idx], t2[tap, half, 1, idx]
        assert float(hi) == float(tjunction._tf32(v.reshape(1))[0])
        assert abs(float(hi + lo - v)) <= 2.0**-21 * abs(float(v))
