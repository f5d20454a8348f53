"""The bf16 forms of the port's junction module against ``wct_tpu``'s.

Under ``compute_dtype="bfloat16"`` the JAX package's ``encoder_head``,
``junction`` and ``decoder_tail`` take bf16 operands: every conv sums
exact bf16 × bf16 products in f32, adds the f32 bias, applies the ReLU
and rounds once to bf16 (``junction_pallas.py::_cs_conv``), and every
intermediate map is bf16. The JAX functions run as the JAX package runs
them on the CPU (Pallas in interpret mode); the port runs the plain
versions its CUDA kernels are held against on the card. Trained-bundle
weights, inputs from a numpy seed, maps of at most 64 px. Every bf16
result is upcast to f32 before numpy touches it.

"One bf16 ulp" is ``|Δ| ≤ 2⁻⁷·|ref| + 1e-5·max|ref|`` (``PERF.md`` §6):
two f32 sums of the same exact products in another order round to the
same bf16 value except where they straddle a rounding point.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wct_tpu.models import cascade as jcascade
from wct_tpu.models import decoder as jdec
from wct_tpu.ops import junction_pallas as jjunction
from wct_tpu.train import checkpoint as jck
from wct_tpu_torch.models import cascade as tcascade
from wct_tpu_torch.models import decoder as tdec
from wct_tpu_torch.ops import junction as tjunction
from wct_tpu_torch.ops.convs import pad_reflect_nchw
from wct_tpu_torch.train import checkpoint as tck

BUNDLE = Path(__file__).resolve().parent.parent / "weights" / "bundle.npz"
HEAD = ("conv0", "conv1_1", "conv1_2")
BF16_FUSED = dict(compute_dtype="bfloat16", method="newton_schulz_fast", fuse_junction=True)


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
    return jck.load_pytree(BUNDLE), tck.params_from_numpy(tck.load_pytree(BUNDLE), "cpu")


def _head_args(bundle):
    jp, tp = bundle
    ja = [jnp.asarray(jp["encoder"][n][k]) for n in HEAD for k in ("w", "b")]
    ta = [tp["encoder"][n][k] for n in HEAD for k in ("w", "b")]
    return ja, ta


def _f64(x):
    """A bf16 or f32 array of either framework as float64 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _t16(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(torch.bfloat16)


def _ulp_stats(got, ref):
    """(share of elements bitwise equal, share within one bf16 ulp)."""
    got, ref = _f64(got), _f64(ref)
    assert got.shape == ref.shape
    d = np.abs(got - ref)
    limit = 2.0**-7 * np.abs(ref) + 1e-5 * np.abs(ref).max()
    return float((d == 0).mean()), float((d <= limit).mean())


def _chain_stats(got, ref):
    """(q99.9 of |Δ| past one bf16 ulp, max |Δ| relative to max |ref|)."""
    got, ref = _f64(got), _f64(ref)
    assert got.shape == ref.shape
    d = np.abs(got - ref)
    excess = d - (2.0**-7 * np.abs(ref) + 1e-5 * np.abs(ref).max())
    return float(np.quantile(excess, 0.999)), float(d.max() / np.abs(ref).max())


# ------------------------------------------------------------ the conv rule


def _rounded_twice(xp, w, bias, relu):
    """A twin that rounds the f32 sum to bf16 before adding a bf16 bias (the
    unfused bf16 conv's order, ``ops/convs.py``): not the kernels' rule."""
    y = torch.nn.functional.conv2d(xp.float(), w.to(torch.bfloat16).float()).to(torch.bfloat16)
    y = y + bias.to(torch.bfloat16)[:, None, None]
    return torch.relu(y) if relu else y


def _conv_case(bundle, which, seed=0):
    """A trained conv and a bf16 input carrying its halo, in both layouts:
    (reference args, port args)."""
    jp, tp = bundle
    rng = np.random.default_rng(seed)
    if which == "conv1_2":
        jw, jb = jp["encoder"]["conv1_2"]["w"], jp["encoder"]["conv1_2"]["b"]
        tw, tb = tp["encoder"]["conv1_2"]["w"], tp["encoder"]["conv1_2"]["b"]
        x = np.maximum(rng.standard_normal((64, 10, 26)) * 30, 0)
    elif which == "dec_64to3":
        dec = "dec_conv1_1"
        jw, jb = jp["decoders"]["relu2_1"][dec]["w"], jp["decoders"]["relu2_1"][dec]["b"]
        tw, tb = tp["decoders"]["relu2_1"][dec]["w"], tp["decoders"]["relu2_1"][dec]["b"]
        x = np.maximum(rng.standard_normal((64, 10, 26)) * 2, 0)
    else:  # conv0∘conv1_1, folded in f32, the 3→64 conv of the head
        ja, ta = _head_args(bundle)
        jw, jb = jjunction.fold_conv0(*ja[:4])
        tw, tb = tjunction.fold_conv0(*ta[:4])
        x = rng.random((3, 10, 26))
    xb = _t16(x)
    ref_args = (jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                jjunction._tap_mat(jnp.asarray(jw), jnp.bfloat16),
                jnp.asarray(jb, jnp.float32).reshape(-1, 1, 1))
    return ref_args, (xb[None], tw, tb)


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
@pytest.mark.parametrize("which", ["conv1_2", "dec_64to3", "head_3to64"])
def test_cs_conv_matches_reference(bundle, which, relu):
    """The port's ``_cs_conv`` against the reference's on the same bf16
    values: ≥ 99 % of the elements bitwise equal, all within one bf16 ulp
    (measured: ≥ 99.99 % bitwise)."""
    ref_args, (xp, w, b) = _conv_case(bundle, which)
    ref = jjunction._cs_conv(*ref_args, relu)
    got = tjunction._cs_conv(xp, w, b, relu)[0]
    assert got.dtype == torch.bfloat16 and got.shape == (w.shape[0], 8, 24)
    bitwise, within = _ulp_stats(got, ref)
    assert bitwise >= 0.99, bitwise
    assert within == 1.0, within


@pytest.mark.parametrize("which", ["conv1_2", "dec_64to3"])
def test_rounding_before_the_bias_fails_the_conv_rule(bundle, which):
    """The same bars tell the kernels' rule from the unfused bf16 conv's:
    rounding the sum and then adding a bf16 bias leaves fewer than
    99 % of the elements equal to the reference (measured 95.4 % for
    conv1_2 and 68.2 % for the 64→3 conv, where the bias is as large as
    the sum; the kernels' rule: 100 %)."""
    ref_args, (xp, w, b) = _conv_case(bundle, which)
    ref = jjunction._cs_conv(*ref_args, True)
    bitwise, within = _ulp_stats(_rounded_twice(xp, w, b, True)[0], ref)
    assert bitwise < 0.99 or within < 1.0, (bitwise, within)
    good, _ = _ulp_stats(tjunction._cs_conv(xp, w, b, True)[0], ref)
    assert good >= 0.99


def test_cs_conv_per_image_weights_equal_one_image_at_a_time(bundle):
    """The tail's grouped form gives each image the bits of its own conv."""
    rng = np.random.default_rng(3)
    xp = _t16(rng.random((3, 64, 6, 10)))
    w = torch.from_numpy((rng.standard_normal((3, 3, 64, 3, 3)) * 0.1).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((3, 3)).astype(np.float32))
    full = tjunction._cs_conv(xp, w, b, False)
    for i in range(3):
        assert torch.equal(full[i], tjunction._cs_conv(xp[i : i + 1], w[i], b[i], False)[0])


# -------------------------------------------------------------- the kernels


@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
@pytest.mark.parametrize("shape", [(2, 16, 32), (1, 48, 16)], ids=["16x32", "48x16"])
def test_decoder_tail_bf16(bundle, shape, clip):
    """One conv with per-image weights folded in f32 and rounded to bf16:
    ≥ 99 % bitwise, all within one bf16 ulp (measured: all bitwise)."""
    rng = np.random.default_rng(6)
    f = rng.random((*shape, 64)).astype(np.float32)
    w = (rng.standard_normal((shape[0], 3, 3, 64, 3)) * 0.1).astype(np.float32)
    b = rng.standard_normal((shape[0], 3)).astype(np.float32)
    ref = jjunction.decoder_tail(jnp.asarray(f, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b),
                                 clip=clip)
    got = tjunction.decoder_tail(_t16(f), torch.from_numpy(w.transpose(0, 4, 3, 1, 2).copy()),
                                 torch.from_numpy(b), clip)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (*shape, 3)
    bitwise, within = _ulp_stats(got, ref)
    assert bitwise >= 0.99 and within == 1.0, (bitwise, within)
    if clip:
        assert float(got.float().min()) >= 0.0 and float(got.float().max()) <= 1.0
        assert float((got == 0).float().mean()) > 0.01  # the clip acted


@pytest.mark.parametrize("shape", [(2, 32, 48), (1, 16, 16)], ids=["32x48", "one_tile"])
def test_encoder_head_bf16(bundle, shape):
    """Two convs in a row, the second fed the first's bf16 rounding: a flip
    there moves a 576-term sum, so the bars are a chain's: q99.9 of |Δ|
    within one bf16 ulp, max |Δ| ≤ 1e-2 of max |ref| (measured: 99.99 %
    bitwise, max 1.0e-5)."""
    ja, ta = _head_args(bundle)
    img = np.random.default_rng(4).random((*shape, 3)).astype(np.float32)
    ref = jjunction.encoder_head(jnp.asarray(img, jnp.bfloat16), *ja)
    got = tjunction.encoder_head(_t16(img), *ta)
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == (shape[0], shape[1] // 2, shape[2] // 2, 64)
    q999, rel_max = _chain_stats(got, ref)
    assert q999 <= 0 and rel_max <= 1e-2, (q999, rel_max)


@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
@pytest.mark.parametrize("deep", [True, False], ids=["deep", "shallow"])
def test_junction_bf16(bundle, deep, clip):
    """Four convs in a row, each rounding to bf16, conv0's O(255) weights in
    the third: q99.9 of |Δ| within one bf16 ulp, max |Δ| ≤ 1e-2 of max
    |ref| (measured at d [1, 16, 16, 64]: 99.76–99.94 % bitwise, max
    4.5e-5 deep and 3.9e-3 shallow, where a flipped rgb value reaches
    the output through one conv instead of two). ``d`` is scaled so that
    the rgb stage leaves [0, 1] and the clip acts."""
    jp, tp = bundle
    ja, ta = _head_args(bundle)
    d = (np.random.default_rng(5).random((1, 16, 16, 64)) * 20).astype(np.float32)
    jt = [jnp.asarray(a) for a in jdec.tail_weights(jp["decoders"]["relu2_1"], "relu2_1")]
    tt = tdec.tail_weights(tp["decoders"]["relu2_1"], "relu2_1")
    ref = jjunction.junction(jnp.asarray(d, jnp.bfloat16), *jt, *ja, deep=deep, clip=clip)
    got = tjunction.junction(_t16(d), *tt, *ta, deep=deep, clip=clip)
    scale = 1 if deep else 2
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (1, 16 * scale, 16 * scale, 64)
    q999, rel_max = _chain_stats(got, ref)
    assert q999 <= 0 and rel_max <= 1e-2, (q999, rel_max)
    other = tjunction.junction(_t16(d), *tt, *ta, deep=deep, clip=not clip)
    assert not torch.equal(got, other), "the clip did not act on this input"


def test_weight_preparation_bf16():
    """``_taps`` rounds to bf16 and keeps f32; the bf16 head's weights
    (``_head_weights``) are conv1_1's ``mma.sync`` fragments and conv1_2 in
    the ``wgmma`` layout, ``w[co, k, tap]`` rounded to bf16 at
    ``[tap, co·64 + ((k // 8) ^ (co % 8))·8 + k % 8]``."""
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal((64, 64, 3, 3)).astype(np.float32))
    taps = tjunction._taps(w, dtype=torch.bfloat16)
    assert taps.dtype == torch.float32 and taps.shape == (64, 9, 64)
    assert torch.equal(taps, tjunction._taps(w.to(torch.bfloat16).float()))
    we1 = torch.from_numpy(rng.standard_normal((64, 3, 3, 3)).astype(np.float32) * 20)
    t1, c1, t2, c2 = tjunction._head_weights(we1, torch.ones(64), w, torch.zeros(64), torch.bfloat16)
    assert torch.equal(t1, tjunction._e1_frags_bf16(we1)) and c1.dtype == torch.float32
    assert t2.dtype == torch.bfloat16 and t2.shape == (9, 4096) and t2.is_contiguous()
    for tap, co, k in [(5, 13, 22), (0, 0, 0), (8, 63, 63)]:
        idx = co * 64 + ((k // 8) ^ (co % 8)) * 8 + k % 8
        assert torch.equal(t2[tap, idx], w[co, k, tap // 3, tap % 3].to(torch.bfloat16))



@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_other_types_still_raise(bundle, dtype):
    _, ta = _head_args(bundle)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tjunction.encoder_head_nchw(torch.zeros(1, 3, 16, 16, dtype=dtype), *ta)


def test_bf16_on_cpu_launches_nothing(bundle):
    _, ta = _head_args(bundle)
    fns = (tjunction.encoder_head_cuda, tjunction.junction_cuda, tjunction.decoder_tail_cuda)
    before = [(f.launches, dict(f.launches_by_dtype)) for f in fns]
    x = tjunction.encoder_head(torch.rand(1, 16, 16, 3).to(torch.bfloat16), *ta)
    assert x.dtype == torch.bfloat16
    tjunction.decoder_tail(torch.rand(1, 16, 16, 64).to(torch.bfloat16), torch.rand(1, 3, 64, 3, 3),
                           torch.rand(1, 3))
    assert before == [(f.launches, dict(f.launches_by_dtype)) for f in fns]
    assert all(set(f.launches_by_dtype) == {"f32", "bf16"} for f in fns)


# -------------------------------------------------------------- the cascade

SIZE = 128


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(9)
    return (rng.random((SIZE, SIZE, 3)).astype(np.float32),
            rng.random((SIZE, SIZE, 3)).astype(np.float32))


@pytest.mark.parametrize("targets", [("relu3_1", "relu2_1"), ("relu2_1", "relu1_1")],
                         ids=["junction_and_head", "head_and_tail"])
def test_bf16_fused_cascade_matches_reference(bundle, images, targets):
    """Port-bf16-fused against reference-bf16-fused on the trained bundle,
    α = 0.6, each two-level cascade fed the same image: q99 |Δ| ≤ 2e-2 and
    median ≤ 4e-3, the bars of ``tests/test_torch_throughput.py`` (one bf16
    ulp of a pixel in [0.5, 1) is 3.9e-3; the unfused convs' orders of
    summation differ between the frameworks). Both routes take the fused
    segments: ("relu3_1", "relu2_1") one head and one junction,
    ("relu2_1", "relu1_1") one head and the tail. Measured: q99 1.2e-2,
    median 2.0e-3 and q99 7.8e-3, median 0."""
    jp, tp = bundle
    content, style = images
    ref = _f64(jcascade.stylize_pair(jp, jnp.asarray(content), jnp.asarray(style), 0.6,
                                     jcascade.CascadeConfig(relu_targets=targets, **BF16_FUSED)))
    calls = {"encoder_head": 0, "junction": 0, "decoder_tail": 0}
    originals = {name: getattr(tjunction, f"{name}_nchw") for name in calls}

    def counted(name):
        def fn(x, *a, **kw):
            assert x.dtype == torch.bfloat16
            calls[name] += 1
            return originals[name](x, *a, **kw)
        return fn

    try:
        for name in calls:
            setattr(tjunction, f"{name}_nchw", counted(name))
        got = tcascade.stylize_pair(tp, content, style, 0.6,
                                    tcascade.CascadeConfig(relu_targets=targets, **BF16_FUSED))
    finally:
        for name, fn in originals.items():
            setattr(tjunction, f"{name}_nchw", fn)
    expected = ({"encoder_head": 1, "junction": 1, "decoder_tail": 0} if targets[1] == "relu2_1"
                else {"encoder_head": 1, "junction": 0, "decoder_tail": 1})
    assert calls == expected
    assert got.dtype == torch.float32 and got.shape == (SIZE, SIZE, 3)
    got = _f64(got)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    d = np.abs(got - ref)
    assert np.quantile(d, 0.99) <= 2e-2, np.quantile(d, 0.99)
    assert np.median(d) <= 4e-3, np.median(d)


def test_bf16_fused_config_builds_and_is_batch_independent(bundle):
    """The configuration constructs (five levels by default), runs on the
    CPU through ``stylize_microbatched`` (three levels: a head, a junction
    and the tail), and an image gives the same bits alone as in a batch;
    α = 0 and α = 1 differ."""
    _, tp = bundle
    assert tcascade.CascadeConfig(**BF16_FUSED).relu_targets == tcascade.DEFAULT_TARGETS
    cfg = tcascade.CascadeConfig(relu_targets=("relu3_1", "relu2_1", "relu1_1"), **BF16_FUSED)
    assert cfg.dtype == torch.bfloat16 and cfg.fuse_junction
    rng = np.random.default_rng(2)
    batch = rng.random((3, 64, 64, 3)).astype(np.float32)
    cache = tcascade.precompute_style(tp["encoder"], rng.random((64, 64, 3)).astype(np.float32), cfg)
    full = tcascade.stylize_microbatched(tp, batch, cache, 0.6, cfg, microbatch=2)
    assert full.dtype == torch.float32 and full.shape == (3, 64, 64, 3)
    assert torch.isfinite(full).all() and full.min() >= 0 and full.max() <= 1
    alone = tcascade.stylize_microbatched(tp, batch[2:], cache, 0.6, cfg, microbatch=2)
    assert torch.equal(alone[0], full[2])
    a0 = tcascade.stylize_microbatched(tp, batch, cache, 0.0, cfg, microbatch=2)
    assert float((a0 - full).abs().mean()) > 1e-3


def test_conv_rule_applies_only_to_bf16(bundle):
    """An f32 map keeps the unfused f32 chain: ``_conv`` is
    ``conv2d_reflect_nchw`` + ReLU there, bit for bit."""
    from wct_tpu_torch.ops.convs import conv2d_reflect_nchw

    _, tp = bundle
    w, b = tp["encoder"]["conv1_2"]["w"], tp["encoder"]["conv1_2"]["b"]
    x = torch.rand(1, 64, 8, 8)
    assert torch.equal(tjunction._conv(x, w, b, True), torch.relu(conv2d_reflect_nchw(x, w, b)))
    x16 = x.to(torch.bfloat16)
    assert torch.equal(tjunction._conv(x16, w, b, False),
                       tjunction._cs_conv(pad_reflect_nchw(x16), w, b, False))
