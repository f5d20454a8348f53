"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file
imports neither JAX nor ``wct_tpu``, so it runs on a machine that has
PyTorch with CUDA and no JAX; there, skip the JAX-only conftest:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from wct_tpu_torch.ops import conv_small, gram, junction, sqrtm
from wct_tpu_torch.ops import wct as wct_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from wct_tpu_torch.utils.device import set_fp32_numerics

    set_fp32_numerics()
    return torch.device("cuda")


def _spd(b, c, seed, cond=100.0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((b, c, c)))
    eigs = np.geomspace(1.0, 1.0 / cond, c)
    return torch.from_numpy(((q * eigs) @ q.transpose(0, 2, 1)).astype(np.float32))


def _rel(a, b):
    return float(((a - b).flatten(1).norm(dim=1) / b.flatten(1).norm(dim=1)).max())


@pytest.mark.parametrize(
    "b,c",
    [(1, 1), (3, 17), (2, 64), (1, 100), (4, 128), (2, 130), (4, 256), (1, 384), (2, 512)],
)
def test_ns_kernel_matches_plain(card, b, c):
    """Tile edges (C not a multiple of 64) included; bound 1e-4 relative."""
    a = _spd(b, c, seed=c).to(card)
    before = sqrtm.ns_sqrtm_cuda.launches
    sq_k, isq_k = sqrtm.newton_schulz_sqrtm(a, use_kernel=True)
    assert sqrtm.ns_sqrtm_cuda.launches == before + 1
    sq_p, isq_p = sqrtm._ns_plain(a, sqrtm.DEFAULT_ITERS, sqrtm.DEFAULT_REG)
    torch.cuda.synchronize()
    assert _rel(sq_k, sq_p) <= 1e-4
    assert _rel(isq_k, isq_p) <= 1e-4


@pytest.mark.parametrize("iters", [0, 1, 3])
def test_ns_kernel_iteration_counts(card, iters):
    a = _spd(2, 96, seed=iters).to(card)
    sq_k, isq_k = sqrtm.ns_sqrtm_cuda(a, iters, 1e-3)
    sq_p, isq_p = sqrtm._ns_plain(a, iters, 1e-3)
    assert _rel(sq_k, sq_p) <= 1e-5
    assert _rel(isq_k, isq_p) <= 1e-5


def test_ns_kernel_deterministic(card):
    a = _spd(3, 192, seed=5).to(card)
    first = sqrtm.ns_sqrtm_cuda(a)
    second = sqrtm.ns_sqrtm_cuda(a)
    assert all(torch.equal(x, y) for x, y in zip(first, second))


@pytest.mark.parametrize("c", [17, 64, 128, 256, 512])
def test_ns_kernel_alone_equals_batch_bitwise(card, c):
    """Tiles and the resident route's cluster follow C alone: the last
    matrix of a batch of 4 gives the same bits alone."""
    a = _spd(4, c, seed=c + 1).to(card)
    sq, isq = sqrtm.ns_sqrtm_cuda(a)
    sq1, isq1 = sqrtm.ns_sqrtm_cuda(a[3:].contiguous())
    assert torch.equal(sq1[0], sq[3]) and torch.equal(isq1[0], isq[3])


def test_ns_kernel_matches_float64_at_512(card):
    """C = 512, B = 2, condition 100: the square root within 5e-5 relative
    Frobenius of a float64 eigendecomposition of the regularised matrix (the
    reference's bar, wct_tpu/ops/sqrtm.py:53-58), and within twice the
    plain f32 loop's own error."""
    from wct_tpu_torch.tools.profile_sqrtm import sqrt_float64

    a = _spd(2, 512, seed=11).to(card)
    sq_k, _ = sqrtm.ns_sqrtm_cuda(a)
    sq_p, _ = sqrtm._ns_plain(a, sqrtm.DEFAULT_ITERS, sqrtm.DEFAULT_REG)
    ref, _ = sqrt_float64(a)
    err_k, err_p = _rel(sq_k.double(), ref), _rel(sq_p.double(), ref)
    assert err_k <= 5e-5
    assert err_k <= 2 * err_p


@pytest.mark.parametrize("case", ["float64", "2d", "non_square", "non_contiguous"])
def test_ns_kernel_rejects_bad_input_on_card(card, case):
    a = _spd(2, 64, seed=0).to(card)
    bad = {
        "float64": a.double(),
        "2d": a[0],
        "non_square": a[:, :, :32],
        "non_contiguous": a.mT,
    }[case]
    with pytest.raises((TypeError, ValueError)):
        sqrtm.ns_sqrtm_cuda(bad)


def test_cascade_kernel_matches_plain_cascade(card):
    """Trained bundle, 64 px, two levels: kernel path vs plain path."""
    from pathlib import Path

    from wct_tpu_torch.models import cascade
    from wct_tpu_torch.train import checkpoint

    bundle = Path(__file__).resolve().parent.parent / "weights" / "bundle.npz"
    params = checkpoint.params_from_numpy(checkpoint.load_pytree(bundle), card)
    rng = np.random.default_rng(0)
    content = rng.random((3, 64, 64, 3)).astype(np.float32)
    style = rng.random((64, 64, 3)).astype(np.float32)
    outs = {}
    for method in ("newton_schulz_pallas", "newton_schulz"):
        cfg = cascade.CascadeConfig(relu_targets=("relu2_1", "relu1_1"), method=method)
        cache = cascade.precompute_style(params["encoder"], style, cfg)
        outs[method] = cascade.stylize_microbatched(params, content, cache, 0.6, cfg, 2)
    d = (outs["newton_schulz_pallas"] - outs["newton_schulz"]).abs()
    assert float(d.max()) <= 1e-3


# ---- encoder_head, junction, decoder_tail (csrc/*.cu) against plain ----

# f32-class sums of up to 576 terms in another order (3×TF32 in the
# junction's 64→64 convs) through up to four convs, conv0's O(255) weights
# in the third: max |Δ| ≤ 1e-4 of the map's max.
JUNCTION_LIMIT = 1e-4
SHAPES = [(1, 16, 16), (2, 48, 32), (3, 64, 16), (1, 16, 80), (2, 96, 144)]
# ... and the main path's: d [4, 64, 256, 256] at every level boundary at 512 px
JUNCTION_SHAPES = SHAPES + [(4, 512, 512)]


@pytest.fixture(scope="module")
def weights():
    """Random conv weights at the trained model's scales, OIHW, on the CPU."""
    rng = np.random.default_rng(11)

    def conv(co, ci, scale=1.0):
        w = rng.standard_normal((co, ci, 3, 3)) * np.sqrt(2.0 / (9 * ci)) * scale
        return torch.from_numpy(w.astype(np.float32)), torch.from_numpy(
            (rng.standard_normal(co) * 0.1).astype(np.float32))

    return {"d1": conv(64, 64), "d2": conv(3, 64), "e1": conv(64, 3, 255.0), "e2": conv(64, 64)}


def _on(card, *pairs):
    return [t.to(card) for pair in pairs for t in pair]


def _rel_max(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _rand(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).random(shape).astype(np.float32))


@pytest.mark.parametrize("b,h,w", SHAPES)
def test_encoder_head_kernel_matches_plain(card, weights, b, h, w):
    x = _rand(h + w, b, 3, h, w).to(card)
    args = _on(card, weights["e1"], weights["e2"])
    before = junction.encoder_head_cuda.launches
    got = junction.encoder_head_cuda(x, *args)
    assert junction.encoder_head_cuda.launches == before + 1
    ref = junction._encoder_head_plain(x, *args)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (b, 64, h // 2, w // 2)
    assert _rel_max(got, ref) <= JUNCTION_LIMIT
    assert torch.equal(got, junction.encoder_head_cuda(x, *args))


@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
@pytest.mark.parametrize("deep", [True, False], ids=["deep", "shallow"])
@pytest.mark.parametrize("b,h,w", JUNCTION_SHAPES)
def test_junction_kernel_matches_plain(card, weights, b, h, w, deep, clip):
    d = (_rand(h * w, b, 64, h // 2, w // 2) * 4).to(card)
    args = _on(card, weights["d1"], weights["d2"], weights["e1"], weights["e2"])
    before = junction.junction_cuda.launches
    got = junction.junction_cuda(d, *args, deep, clip)
    assert junction.junction_cuda.launches == before + 1
    ref = junction._junction_plain(d, *args, deep, clip)
    torch.cuda.synchronize()
    assert tuple(got.shape) == ((b, 64, h // 2, w // 2) if deep else (b, 64, h, w))
    assert _rel_max(got, ref) <= JUNCTION_LIMIT
    assert torch.equal(got, junction.junction_cuda(d, *args, deep, clip))
    if clip:  # the clip acts on this input
        assert not torch.equal(got, junction.junction_cuda(d, *args, deep, False))


@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
@pytest.mark.parametrize("b,h,w", SHAPES)
def test_decoder_tail_kernel_matches_plain(card, b, h, w, clip):
    f = _rand(7 * h + w, b, 64, h, w).to(card)
    wt = ((_rand(1, b, 3, 64, 3, 3) - 0.5) * 0.2).to(card)
    bias = _rand(2, b, 3).to(card)
    before = junction.decoder_tail_cuda.launches
    got = junction.decoder_tail_cuda(f, wt, bias, clip)
    assert junction.decoder_tail_cuda.launches == before + 1
    ref = junction._decoder_tail_plain(f, wt, bias, clip)
    torch.cuda.synchronize()
    assert tuple(got.shape) == (b, 3, h, w)
    assert _rel_max(got, ref) <= JUNCTION_LIMIT
    assert torch.equal(got, junction.decoder_tail_cuda(f, wt, bias, clip))
    # per-image weights: image 1 alone gives the same bits as in the batch
    if b > 1:
        alone = junction.decoder_tail_cuda(f[1:2].contiguous(), wt[1:2], bias[1:2], clip)
        assert torch.equal(alone[0], got[1])


def test_junction_kernels_independent_of_batch(card, weights):
    args = _on(card, weights["d1"], weights["d2"], weights["e1"], weights["e2"])
    d = (_rand(3, 5, 64, 24, 16) * 4).to(card)
    full = junction.junction_cuda(d, *args)
    assert torch.equal(junction.junction_cuda(d[3:4].contiguous(), *args)[0], full[3])
    x = _rand(4, 5, 3, 32, 48).to(card)
    full = junction.encoder_head_cuda(x, *args[4:])
    assert torch.equal(junction.encoder_head_cuda(x[2:3].contiguous(), *args[4:])[0], full[2])


@pytest.mark.parametrize(
    "case", ["float64", "cpu", "rank3", "non_contiguous", "c_not_64", "h_not_16", "w_not_16",
             "bad_weight"])
@pytest.mark.parametrize("kernel", ["encoder_head", "junction", "decoder_tail"])
def test_junction_kernels_reject_bad_input_on_card(card, weights, kernel, case):
    c = 3 if kernel == "encoder_head" else 64
    half = 2 if kernel == "junction" else 1  # junction takes the half-resolution map
    x = torch.rand(2, c, 32 // half, 32 // half, device=card)
    bad = {
        "float64": lambda: x.double(),
        "cpu": lambda: x.cpu(),
        "rank3": lambda: x[0],
        "non_contiguous": lambda: x.transpose(2, 3),
        "c_not_64": lambda: torch.rand(2, c + 1, 32 // half, 32 // half, device=card),
        "h_not_16": lambda: torch.rand(2, c, 24 // half, 32 // half, device=card),
        "w_not_16": lambda: torch.rand(2, c, 32 // half, 40 // half, device=card),
        "bad_weight": lambda: x,
    }[case]()
    d1, d2, e1, e2 = (_on(card, weights[k]) for k in ("d1", "d2", "e1", "e2"))
    if case == "bad_weight":
        e1 = [e1[0][:, :, :2], e1[1]]
        d2 = [d2[0][:2], d2[1]]
    call = {
        "encoder_head": lambda: junction.encoder_head_cuda(bad, *e1, *e2),
        "junction": lambda: junction.junction_cuda(bad, *d1, *d2, *e1, *e2),
        "decoder_tail": lambda: junction.decoder_tail_cuda(
            bad, torch.rand(2 if case != "bad_weight" else 1, 3, 64, 3, 3, device=card),
            torch.rand(2, 3, device=card)),
    }[kernel]
    before = getattr(junction, f"{kernel}_cuda").launches
    with pytest.raises((TypeError, ValueError)):
        call()
    assert getattr(junction, f"{kernel}_cuda").launches == before


def test_fused_cascade_matches_unfused_cascade(card):
    """Trained bundle, 64 px, five levels: the fused route launches 1 head,
    3 junctions, 1 tail per chunk and agrees with the unfused route within
    the bounds the CPU tests hold the two routes to."""
    from pathlib import Path

    from wct_tpu_torch.models import cascade
    from wct_tpu_torch.train import checkpoint

    bundle = Path(__file__).resolve().parent.parent / "weights" / "bundle.npz"
    params = checkpoint.params_from_numpy(checkpoint.load_pytree(bundle), card)
    rng = np.random.default_rng(0)
    content = rng.random((3, 64, 64, 3)).astype(np.float32)
    style = rng.random((64, 64, 3)).astype(np.float32)
    outs = {}
    wrappers = (junction.encoder_head_cuda, junction.junction_cuda, junction.decoder_tail_cuda,
                gram.centered_gram_cuda)
    for fuse in (False, True):
        cfg = cascade.CascadeConfig(method="newton_schulz_pallas", fuse_junction=fuse)
        cache = cascade.precompute_style(params["encoder"], style, cfg)
        before = [f.launches for f in wrappers]
        outs[fuse] = cascade.stylize_microbatched(params, content, cache, 0.6, cfg, 2)
        delta = [f.launches - n for f, n in zip(wrappers, before)]
        # per chunk: 1 head, 3 junctions, 1 tail (fused), and a Gram per level
        assert delta == ([2, 6, 2, 10] if fuse else [0, 0, 0, 10])
    d = (outs[True] - outs[False]).abs().flatten()
    assert float(torch.quantile(d, 0.99)) <= 5e-3
    assert float(d.max()) <= 3e-2


# ---- the bf16 forms of encoder_head, junction and decoder_tail ----

# Each conv sums exact bf16 products in f32 and rounds once, in kernel and
# plain alike, so they differ where two f32 sums straddle a rounding point.
# One conv (the tail) against plain: ≥ 99 % bitwise, all within one bf16 ulp.
# A chain carries a flipped intermediate rounding forward: one flip upstream
# of conv0's O(255) weights moves some 20 outputs beyond an ulp and one of
# them by up to about 1 % of the map's max. cuDNN's plain chain is itself up
# to 0.7 % of its outputs beyond one ulp of a float64 evaluation of the same
# rule and 1.7 % of the max away from it (H100, PERF.md). So the chains
# (head, junction) are held to that evaluation, at bars a few such events
# cannot break and a systematic error would: ≥ 99 % bitwise, ≥ 99.5 %
# within one ulp (q99.5 of |Δ|), max |Δ| ≤ 2e-2 of max |ref|; and to plain
# by the same max bound.


def _agreement(got, ref):
    """(share bitwise equal, share within one bf16 ulp, max |Δ| / max |ref|)."""
    got, ref = got.float(), ref.float()
    d = (got - ref).abs()
    excess = d - (2.0**-7 * ref.abs() + 1e-5 * ref.abs().max())
    return (float((d == 0).float().mean()), float((excess <= 0).float().mean()),
            float(d.max() / ref.abs().max()))


def _check_chain(got, plain, plain64):
    bitwise, within, rel_max = _agreement(got, plain64)
    assert bitwise >= 0.99 and within >= 0.995 and rel_max <= 2e-2, (bitwise, within, rel_max)
    assert _agreement(got, plain)[2] <= 2e-2


@pytest.mark.parametrize("b,h,w", SHAPES + [(4, 512, 512)])
def test_encoder_head_bf16_kernel_matches_plain(card, weights, b, h, w):
    x = _rand(h + w, b, 3, h, w).to(card).to(torch.bfloat16)
    args = _on(card, weights["e1"], weights["e2"])
    before = dict(junction.encoder_head_cuda.launches_by_dtype)
    got = junction.encoder_head_cuda(x, *args)
    assert junction.encoder_head_cuda.launches_by_dtype == {**before, "bf16": before["bf16"] + 1}
    ref = junction._encoder_head_plain(x, *args)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, 64, h // 2, w // 2)
    _check_chain(got, ref, junction._encoder_head_plain(x, *args, acc=torch.float64))
    assert torch.equal(got, junction.encoder_head_cuda(x, *args))
    if b > 1:
        assert torch.equal(junction.encoder_head_cuda(x[1:2].contiguous(), *args)[0], got[1])


@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
@pytest.mark.parametrize("deep", [True, False], ids=["deep", "shallow"])
@pytest.mark.parametrize("b,h,w", JUNCTION_SHAPES)
def test_junction_bf16_kernel_matches_plain(card, weights, b, h, w, deep, clip):
    d = (_rand(h * w, b, 64, h // 2, w // 2) * 4).to(card).to(torch.bfloat16)
    args = _on(card, weights["d1"], weights["d2"], weights["e1"], weights["e2"])
    before = dict(junction.junction_cuda.launches_by_dtype)
    got = junction.junction_cuda(d, *args, deep, clip)
    assert junction.junction_cuda.launches_by_dtype == {**before, "bf16": before["bf16"] + 1}
    ref = junction._junction_plain(d, *args, deep, clip)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert tuple(got.shape) == ((b, 64, h // 2, w // 2) if deep else (b, 64, h, w))
    _check_chain(got, ref, junction._junction_plain(d, *args, deep, clip, acc=torch.float64))
    assert torch.equal(got, junction.junction_cuda(d, *args, deep, clip))
    if b > 1:
        alone = junction.junction_cuda(d[1:2].contiguous(), *args, deep, clip)
        assert torch.equal(alone[0], got[1])
    if clip:  # the clip acts on this input
        assert not torch.equal(got, junction.junction_cuda(d, *args, deep, False))


@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
@pytest.mark.parametrize("b,h,w", SHAPES + [(4, 512, 512)])
def test_decoder_tail_bf16_kernel_matches_plain(card, b, h, w, clip):
    f = _rand(7 * h + w, b, 64, h, w).to(card).to(torch.bfloat16)
    wt = ((_rand(1, b, 3, 64, 3, 3) - 0.5) * 0.2).to(card)
    bias = _rand(2, b, 3).to(card)
    before = dict(junction.decoder_tail_cuda.launches_by_dtype)
    small_before = conv_small.conv3x3_small_cuda.launches
    got = junction.decoder_tail_cuda(f, wt, bias, clip)
    assert junction.decoder_tail_cuda.launches_by_dtype == {**before, "bf16": before["bf16"] + 1}
    assert conv_small.conv3x3_small_cuda.launches == small_before  # counted as the tail only
    ref = junction._decoder_tail_plain(f, wt, bias, clip)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, 3, h, w)
    bitwise, within, _ = _agreement(got, ref)
    assert bitwise >= 0.99 and within == 1.0, (bitwise, within)
    assert torch.equal(got, junction.decoder_tail_cuda(f, wt, bias, clip))
    for i in range(b):  # per-image weights: each image alone gives the bits of the batch
        alone = junction.decoder_tail_cuda(f[i : i + 1].contiguous(), wt[i : i + 1], bias[i : i + 1],
                                           clip)
        assert torch.equal(alone[0], got[i])


@pytest.mark.parametrize("kernel", ["encoder_head", "junction"])
def test_junction_kernels_shared_memory_plan(card, kernel):
    """The forms' shared memory as their sources plan it, and what the card
    makes of it: one block per SM for each, all on wgmma from a 1 KB-aligned
    ring of weight slots: the junction's (f32 3 and bf16 6 slots of 16 KB)
    before its maps; the head's persistent blocks on 32 × 16 tiles, f32 3
    slots of 16 KB, bf16 all 9 taps of conv1_2 (8 KB each) and its pooled
    tile staged for 16-byte stores (16 KB)."""
    plans = {dt: junction.kernel_plan(kernel, dt) for dt in (torch.float32, torch.bfloat16)}
    if kernel == "junction":
        assert plans == {torch.float32: (216_996, 1), torch.bfloat16: (194_824, 1)}
    else:
        assert plans == {torch.float32: (222_436, 1), torch.bfloat16: (199_020, 1)}


# The junction on wgmma (csrc/junction.cu) against a float64 evaluation of
# its chain, where plain's own error does not count: f32 (3×TF32, a partial
# per chunk) within 1e-5 of the map's max (it measured 7e-7 at the main
# path's shape, PERF.md), bf16 under the chain bars of _check_chain.
@pytest.mark.parametrize("deep", [True, False], ids=["deep", "shallow"])
@pytest.mark.parametrize("b,h,w", SHAPES[:3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_junction_wgmma_against_float64(card, weights, dtype, b, h, w, deep):
    d = (_rand(h + 3 * w, b, 64, h // 2, w // 2) * 4).to(card).to(dtype)
    args = _on(card, weights["d1"], weights["d2"], weights["e1"], weights["e2"])
    got = junction.junction_cuda(d, *args, deep, True)
    ref = junction._junction_plain(d, *args, deep, True)
    torch.cuda.synchronize()
    if dtype == torch.float32:
        ref64 = junction._junction_plain(d.double(), *[a.double() for a in args], deep, True)
        assert _rel_max(got.double(), ref64) <= 1e-5
        assert _rel_max(got, ref) <= JUNCTION_LIMIT
    else:
        _check_chain(got, ref, junction._junction_plain(d, *args, deep, True, acc=torch.float64))


def test_bf16_fused_cascade_on_card(card):
    """Trained bundle, 64 px, five levels: bf16 + newton_schulz_fast +
    fuse_junction launches the bf16 forms (1 head, 3 junctions, 1 tail per
    chunk, no f32 form) and holds the reference's composed gate against the
    f32 + eigh cascade (median < 0.2); alone = batch bitwise."""
    from pathlib import Path

    from wct_tpu_torch.models import cascade
    from wct_tpu_torch.train import checkpoint

    bundle = Path(__file__).resolve().parent.parent / "weights" / "bundle.npz"
    params = checkpoint.params_from_numpy(checkpoint.load_pytree(bundle), card)
    rng = np.random.default_rng(0)
    content = rng.random((3, 64, 64, 3)).astype(np.float32)
    style = rng.random((64, 64, 3)).astype(np.float32)
    wrappers = (junction.encoder_head_cuda, junction.junction_cuda, junction.decoder_tail_cuda)
    outs = {}
    for name, kw in (("fid", {}), ("fused", dict(compute_dtype="bfloat16",
                                                  method="newton_schulz_fast",
                                                  fuse_junction=True))):
        cfg = cascade.CascadeConfig(**kw)
        cache = cascade.precompute_style(params["encoder"], style, cfg)
        before = [dict(f.launches_by_dtype) for f in wrappers]
        outs[name] = cascade.stylize_microbatched(params, content, cache, 0.8, cfg, 2)
        delta = [{k: f.launches_by_dtype[k] - n[k] for k in n} for f, n in zip(wrappers, before)]
        if name == "fused":
            assert delta == [{"f32": 0, "bf16": 2}, {"f32": 0, "bf16": 6}, {"f32": 0, "bf16": 2}]
        alone = cascade.stylize_microbatched(params, content[2:], cache, 0.8, cfg, 2)
        assert torch.equal(alone[0], outs[name][2])
    out = outs["fused"]
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    assert float(out.min()) >= 0.0 and float(out.max()) <= 1.0
    assert float((out - outs["fid"]).abs().median()) < 0.2


# ---- conv3x3_small (csrc/conv3x3_small.cu) against plain ----

CONV_SHAPES = [(1, 8, 8), (2, 24, 40), (6, 16, 8), (1, 8, 264), (4, 512, 512), (1, 720, 1280),
               (2, 16, 72)]
CONV_CHANNELS = [(64, 64), (64, 3), (3, 64), (32, 8), (5, 17)]


def _bf16_rand(seed, *shape, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape) * scale
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def _one_ulp(got, ref):
    """Both sum exact products in f32 and round once: at most one bf16
    ulp apart, |Δ| ≤ 2⁻⁷·|ref| + 1e-5·max|ref|."""
    got, ref = got.float(), ref.float()
    return bool(((got - ref).abs() <= 2.0**-7 * ref.abs() + 1e-5 * ref.abs().max()).all())


@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
@pytest.mark.parametrize("cin,cout", CONV_CHANNELS)
@pytest.mark.parametrize("b,h,w", CONV_SHAPES)
def test_conv3x3_small_kernel_matches_plain(card, b, h, w, cin, cout, relu):
    if h >= 512 and (cin, cout) not in ((64, 64), (64, 3), (3, 64)):
        pytest.skip("the 512-px and 720p cases run the trained channel counts only")
    x = _bf16_rand(h + w + cin, b, cin, h, w).to(card)
    wt = _bf16_rand(cout, cout, cin, 3, 3, scale=0.1).float().to(card)
    bias = _bf16_rand(1, cout, scale=0.1).float().to(card)
    ref = conv_small._conv3x3_small_plain(x, wt, bias, relu)
    before = conv_small.conv3x3_small_cuda.launches
    got = conv_small.conv3x3_reflect_small_nchw(x, wt, bias, relu)
    x_nhwc = x.permute(0, 2, 3, 1).contiguous()
    got_nhwc = conv_small.conv3x3_reflect_small(x_nhwc, wt, bias, relu)
    assert conv_small.conv3x3_small_cuda.launches == before + 2
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, cout, h, w)
    assert tuple(got_nhwc.shape) == (b, h, w, cout)
    assert _one_ulp(got, ref)
    # the two entries are one body: the same bits in either layout
    assert torch.equal(got_nhwc.permute(0, 3, 1, 2), got)
    assert torch.equal(got, conv_small.conv3x3_reflect_small_nchw(x, wt, bias, relu))
    if b > 1:  # an image alone gives the same bits as in the batch
        alone = conv_small.conv3x3_reflect_small_nchw(x[1:2].contiguous(), wt, bias, relu)
        assert torch.equal(alone[0], got[1])
    fused = conv_small.conv2d_reflect_fused(x_nhwc, wt, bias, relu, impl="pallas_small")
    assert torch.equal(fused, got_nhwc)


@pytest.mark.parametrize("nhwc", [False, True], ids=["nchw", "nhwc"])
@pytest.mark.parametrize("cin,cout", [(64, 64), (3, 64), (64, 3)])
def test_conv3x3_small_call_launches_one_kernel(card, cin, cout, nhwc):
    """A call of either entry launches the kernel and nothing else: the
    kernel lays out the OIHW weights itself (torch.profiler's CUDA events)."""
    from torch.profiler import ProfilerActivity, profile

    x = _bf16_rand(cin, 2, cin, 16, 72).to(card)
    if nhwc:
        x = x.permute(0, 2, 3, 1).contiguous()
    wt = _bf16_rand(cout, cout, cin, 3, 3, scale=0.1).float().to(card)
    bias = _bf16_rand(1, cout, scale=0.1).float().to(card)
    call = conv_small.conv3x3_reflect_small if nhwc else conv_small.conv3x3_reflect_small_nchw
    call(x, wt, bias, True)  # built and loaded
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        call(x, wt, bias, True)
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1 and "conv3x3_small" in kernels[0], kernels


def test_conv2d_reflect_fused_routes_by_shape_and_dtype(card):
    wt, bias = torch.randn(3, 64, 3, 3, device=card) * 0.1, torch.zeros(3, device=card)
    before = conv_small.conv3x3_small_cuda.launches
    x = _bf16_rand(0, 1, 8, 20, 64).to(card)  # W not a multiple of 8: the stock conv
    out = conv_small.conv2d_reflect_fused(x, wt, bias, impl="pallas_small")
    assert tuple(out.shape) == (1, 8, 20, 3) and out.dtype == torch.bfloat16
    conv_small.conv2d_reflect_fused(x[:, :, :16].float(), wt, bias, impl="pallas_small")
    conv_small.conv2d_reflect_fused(x[:, :, :16].contiguous(), wt, bias, impl="xla")
    assert conv_small.conv3x3_small_cuda.launches == before
    conv_small.conv2d_reflect_fused(x[:, :, :16].contiguous(), wt, bias, impl="pallas_small")
    assert conv_small.conv3x3_small_cuda.launches == before + 1


@pytest.mark.parametrize(
    "case", ["float32", "cpu", "rank3", "non_contiguous", "c_above_64", "h_not_8", "w_not_8",
             "bad_weight", "weight_on_cpu"])
def test_conv3x3_small_kernel_rejects_bad_input_on_card(card, case):
    x = _bf16_rand(0, 2, 64, 16, 16).to(card)
    wt, bias = torch.randn(64, 64, 3, 3, device=card), torch.zeros(64, device=card)
    args = {
        "float32": (x.float(), wt, bias),
        "cpu": (x.cpu(), wt.cpu(), bias.cpu()),
        "rank3": (x[0], wt, bias),
        "non_contiguous": (x.transpose(2, 3), wt, bias),
        "c_above_64": (_bf16_rand(0, 2, 72, 16, 16).to(card), torch.randn(64, 72, 3, 3, device=card), bias),
        "h_not_8": (x[:, :, :12].contiguous(), wt, bias),
        "w_not_8": (x[:, :, :, :12].contiguous(), wt, bias),
        "bad_weight": (x, wt[:, :32], bias),
        "weight_on_cpu": (x, wt.cpu(), bias),
    }[case]
    before = conv_small.conv3x3_small_cuda.launches
    with pytest.raises((TypeError, ValueError)):
        conv_small.conv3x3_small_cuda(*args)
    assert conv_small.conv3x3_small_cuda.launches == before


# ---- centered_gram (csrc/centered_gram.cu) against plain ----


def _gram_rel(a, b):
    return float(((a - b).flatten(1).norm(dim=1) / b.flatten(1).norm(dim=1)).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("b", [1, 4, 6])
@pytest.mark.parametrize("n,c", [(7, 32), (132, 512), (1000, 64), (4096, 128), (5000, 100),
                                 (262144, 64), (65536, 32)])
def test_centered_gram_kernel_matches_plain(card, n, c, b, dtype):
    """Masked tails of N (7, 132, 1000, 5000) and of C (32, 100)
    included. Against a float64 evaluation: Gram relative Frobenius and
    means ≤ 1e-6. Against plain only ≤ 1e-4: its f32 sum over thousands
    of equal terms (every zero of a ReLU map gives the same centred
    product) rounds the same way at each step and drifts by up to 1e-5."""
    if n == 262144 and b == 6:
        pytest.skip("B = 1 and 4 cover the largest map")
    rng = np.random.default_rng(n + c)
    x = torch.from_numpy(
        (np.maximum(rng.standard_normal((b, c, n)), 0) + 0.3).astype(np.float32)).to(dtype).to(card)
    before = gram.centered_gram_cuda.launches
    got, mean = gram.centered_gram_cn(x)
    assert gram.centered_gram_cuda.launches == before + 1
    ref, ref_mean = gram._centered_gram_plain(x)
    torch.cuda.synchronize()
    assert got.dtype == mean.dtype == torch.float32
    assert tuple(got.shape) == (b, c, c) and tuple(mean.shape) == (b, c)
    assert _gram_rel(got, ref) <= 1e-4
    assert float((mean - ref_mean).abs().max()) <= 1e-5 * float(ref_mean.abs().max())
    x64 = x.double()
    mean64 = x64.mean(-1)
    assert float((mean - mean64).abs().max()) <= 1e-6 * float(mean64.abs().max())
    c64 = x64 - mean64[..., None]
    assert _gram_rel(got.double(), c64 @ c64.mT) <= 1e-6
    again, _ = gram.centered_gram_cn(x)
    assert torch.equal(got, again)
    alone, alone_mean = gram.centered_gram_cn(x[b - 1 :].contiguous())
    assert torch.equal(alone[0], got[b - 1]) and torch.equal(alone_mean[0], mean[b - 1])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n,c", [(1000, 17), (4099, 130), (777, 384), (262144, 64)])
def test_centered_gram_kernel_symmetric_and_tile_edges(card, n, c, dtype):
    """G is exactly its own transpose (the kernel computes the tiles on and
    above the diagonal and mirrors them), at C past a tile edge and N not
    a multiple of 32 (or of a 16-byte row), within 1e-6 of float64 and
    1e-4 of plain, and the same bits alone and in a batch of 3."""
    rng = np.random.default_rng(n * c)
    x = torch.from_numpy(
        (np.maximum(rng.standard_normal((3, c, n)), 0) + 0.3).astype(np.float32)).to(dtype).to(card)
    got, mean = gram.centered_gram_cn(x)
    ref, _ = gram._centered_gram_plain(x)
    assert torch.equal(got, got.mT)
    x64 = x.double()
    c64 = x64 - x64.mean(-1, keepdim=True)
    assert _gram_rel(got.double(), c64 @ c64.mT) <= 1e-6
    assert _gram_rel(got, ref) <= 1e-4
    alone, alone_mean = gram.centered_gram_cn(x[2:].contiguous())
    assert torch.equal(alone[0], got[2]) and torch.equal(alone_mean[0], mean[2])


def test_centered_gram_2d_entry_and_float64(card):
    """``centered_gram(x [N, C])`` against numpy in float64: ≤ 1e-6
    relative Frobenius, the order of a blocked f32 sum over 20,000 terms."""
    rng = np.random.default_rng(5)
    x = (np.maximum(rng.standard_normal((20000, 96)), 0) + 0.3).astype(np.float32)
    got, mean = gram.centered_gram(torch.from_numpy(x).to(card))
    x64 = x.astype(np.float64)
    mu = x64.mean(0)
    ref = (x64 - mu).T @ (x64 - mu)
    assert np.linalg.norm(got.double().cpu().numpy() - ref) <= 1e-6 * np.linalg.norm(ref)
    np.testing.assert_allclose(mean.cpu().numpy(), mu, rtol=2e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_gram_cn_matches_float64_at_relu1_1(card, dtype):
    """The cascade's own covariance at relu1_1, 512 px, batch 4: a ReLU map
    of [4, 64, 262,144], 77 % zeros, within 1e-6 relative Frobenius of
    float64 for f32 and bf16 features (one cuBLAS product over all N
    columns, which ``_gram_cn`` was before, is about 1e-3 off)."""
    rng = np.random.default_rng(1)
    x = np.maximum(rng.standard_normal((4, 64, 262144), dtype=np.float32) - 0.7388, 0)
    x = torch.from_numpy(x).to(dtype).to(card)
    before = gram.centered_gram_cuda.launches
    cov, mean = wct_ops._gram_cn(x)
    assert gram.centered_gram_cuda.launches == before + 1
    x64 = x.double()
    mean64 = x64.mean(-1)
    c64 = x64 - mean64[..., None]
    cov64 = c64 @ c64.mT / (x.shape[-1] - 1)
    assert _gram_rel(cov.double(), cov64) <= 1e-6
    assert float((mean - mean64).abs().max()) <= 1e-6 * float(mean64.abs().max())
    alone, _ = wct_ops._gram_cn(x[3:])
    assert torch.equal(alone[0], cov[3])


@pytest.mark.parametrize("case", ["float64", "cpu", "rank2", "non_contiguous", "empty"])
def test_centered_gram_kernel_rejects_bad_input_on_card(card, case):
    x = torch.rand(2, 64, 256, device=card)
    bad = {
        "float64": lambda: x.double(),
        "cpu": lambda: x.cpu(),
        "rank2": lambda: x[0],
        "non_contiguous": lambda: x.mT,
        "empty": lambda: x[:, :, :0],
    }[case]()
    before = gram.centered_gram_cuda.launches
    with pytest.raises((TypeError, ValueError)):
        gram.centered_gram_cuda(bad)
    assert gram.centered_gram_cuda.launches == before


# ---- the bf16 throughput cascade on the card ----


def test_throughput_cascade_on_card(card):
    """Trained bundle, 64 px, five levels: bf16 + newton_schulz_fast +
    compose_conv0 against the f32 + eigh cascade within the reference's
    composed gate (median < 0.2), bitwise equal alone and in a batch."""
    from pathlib import Path

    from wct_tpu_torch.models import cascade
    from wct_tpu_torch.train import checkpoint

    bundle = Path(__file__).resolve().parent.parent / "weights" / "bundle.npz"
    params = checkpoint.params_from_numpy(checkpoint.load_pytree(bundle), card)
    rng = np.random.default_rng(0)
    content = rng.random((3, 64, 64, 3)).astype(np.float32)
    style = rng.random((64, 64, 3)).astype(np.float32)
    outs = {}
    for name, kw in (("fid", {}), ("fast", dict(compute_dtype="bfloat16",
                                                 method="newton_schulz_fast",
                                                 compose_conv0=True))):
        cfg = cascade.CascadeConfig(**kw)
        cache = cascade.precompute_style(params["encoder"], style, cfg)
        outs[name] = cascade.stylize_microbatched(params, content, cache, 0.8, cfg, 2)
        alone = cascade.stylize_microbatched(params, content[2:], cache, 0.8, cfg, 2)
        assert torch.equal(alone[0], outs[name][2])
    assert outs["fast"].dtype == torch.float32
    assert float((outs["fast"] - outs["fid"]).abs().median()) < 0.2


# ---- grouped WCT, AdaIN and style-swap: the existing kernels at new shapes ----


def _ns_float64(a, iters=sqrtm.DEFAULT_ITERS, reg=sqrtm.DEFAULT_REG):
    """sqrt(A) by the kernel's coupled iteration, every step in float64."""
    c = a.shape[-1]
    a64 = a.double()
    eye = torch.eye(c, dtype=torch.float64, device=a.device)
    a64 = a64 + (reg * a64.diagonal(dim1=-2, dim2=-1).sum(-1) / c)[:, None, None] * eye
    norm = a64.abs().sum(-1).amax(-1)[:, None, None]
    y, z = a64 / norm, eye.expand_as(a64)
    for _ in range(iters):
        t = 1.5 * eye - 0.5 * z @ y
        y, z = y @ t, t @ z
    return y * norm.sqrt()


@pytest.mark.parametrize("bg", [16, 64, 256])
@pytest.mark.parametrize("cg", [8, 16, 32])
def test_grouped_gram_and_ns_kernels_at_small_channels(card, cg, bg):
    """Grouped WCT hands the Gram ``[B·G, C/G, N]`` and Newton–Schulz
    ``[B·G, C/G, C/G]``, down to C/G = 8 and up to 4·64 matrices: the Gram
    ≤ 1e-6 from float64 and Newton–Schulz ≤ 5e-5 from its float64 iteration,
    both the same bits alone and in the batch."""
    rng = np.random.default_rng(cg * bg)
    x = torch.from_numpy(np.maximum(rng.standard_normal((bg, cg, 4099)), 0).astype(np.float32))
    x = x.to(card)
    g, mean = gram.centered_gram_cn(x)
    x64 = x.double()
    c64 = x64 - x64.mean(-1, keepdim=True)
    assert _gram_rel(g.double(), c64 @ c64.mT) <= 1e-6
    alone, _ = gram.centered_gram_cn(x[-1:].contiguous())
    assert torch.equal(alone[0], g[-1])
    cov = (g / 4098 + 1e-8 * torch.eye(cg, device=card)).contiguous()
    before = sqrtm.ns_sqrtm_cuda.launches
    sq, isq = sqrtm.newton_schulz_sqrtm(cov, use_kernel=True)
    assert sqrtm.ns_sqrtm_cuda.launches == before + 1
    torch.cuda.synchronize()
    assert _rel(sq.double(), _ns_float64(cov)) <= 5e-5
    sq_p, isq_p = sqrtm._ns_plain(cov, sqrtm.DEFAULT_ITERS, sqrtm.DEFAULT_REG)
    assert _rel(sq, sq_p) <= 1e-4 and _rel(isq, isq_p) <= 1e-4
    alone = sqrtm.ns_sqrtm_cuda(cov[-1:].contiguous())
    assert torch.equal(alone[0][0], sq[-1]) and torch.equal(alone[1][0], isq[-1])


def test_grouped_whitening_launches_once_per_call(card):
    """A grouped batch is one Gram launch and one Newton–Schulz launch."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(np.maximum(rng.standard_normal((4, 64, 1024)), 0).astype(np.float32))
    x = x.to(card)
    before = (gram.centered_gram_cuda.launches, sqrtm.ns_sqrtm_cuda.launches)
    w, mu = wct_ops.whitening_kernel_cn(x, method="newton_schulz_pallas", groups=4)
    assert (gram.centered_gram_cuda.launches, sqrtm.ns_sqrtm_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    assert tuple(w.shape) == (4, 4, 16, 16) and tuple(mu.shape) == (4, 64)
    w_p, mu_p = wct_ops.whitening_kernel_cn(x.cpu(), method="newton_schulz_pallas", groups=4)
    assert _rel(w.cpu().flatten(0, 1), w_p.flatten(0, 1)) <= 1e-4


def test_moments_on_card_are_the_gram_diagonal(card):
    """AdaIN's moments on the card: the centred Gram's mean and diagonal,
    ≤ 1e-6 from float64, the same bits alone and in the batch."""
    from wct_tpu_torch.ops import reductions

    rng = np.random.default_rng(2)
    x = torch.from_numpy(np.maximum(rng.standard_normal((4, 64, 65536)), 0).astype(np.float32))
    x = x.to(card)
    before = gram.centered_gram_cuda.launches
    mean, var = gram.moments_cn(x)
    assert gram.centered_gram_cuda.launches == before + 1
    x64 = x.double()
    assert float((var.double() - x64.var(-1, unbiased=False)).abs().max()) <= 1e-6 * float(
        x64.var(-1).max())
    assert float((mean.double() - x64.mean(-1)).abs().max()) <= 1e-6 * float(x64.mean(-1).max())
    alone = gram.moments_cn(x[1:2])
    assert torch.equal(alone[1][0], var[1])
    plain = reductions.moments0(x.mT)
    assert float((plain[1] - var).abs().max()) <= 1e-5 * float(var.max())


def test_style_swap_on_card_matches_its_cpu_run(card):
    """The correlation, the argmax and the transposed convs on the card
    (full f32, no TF32) against the same function on the CPU: the same
    argmax at every location and the map within 1e-5 of its max."""
    from wct_tpu_torch.ops import style_swap

    rng = np.random.default_rng(3)
    fc = torch.from_numpy(rng.standard_normal((2, 64, 16, 16)).astype(np.float32))
    fs = torch.from_numpy(rng.standard_normal((1, 64, 14, 15)).astype(np.float32))
    for stride in (1, 2):
        _, fn = style_swap._filters(fs, 3, stride)
        _, fn_card = style_swap._filters(fs.to(card), 3, stride)
        for i in range(2):
            best = style_swap._best_patches(fc[i : i + 1], fn, stride)
            best_card = style_swap._best_patches(fc[i : i + 1].to(card), fn_card, stride)
            assert torch.equal(best_card.cpu(), best)
        got = style_swap.style_swap_nchw(fc.to(card), fs.to(card), 0.7, 3, stride).cpu()
        ref = style_swap.style_swap_nchw(fc, fs, 0.7, 3, stride)
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_adain_folded_bf16_tail_against_float64_rule(card):
    """The fused relu1_1 tail with AdaIN's diagonal affine folded into its
    bf16 per-image weights (in f32): the kernel against a float64
    evaluation of the bf16 rule and against plain, ≥ 99 % bitwise and all
    within one bf16 ulp."""
    from wct_tpu_torch.models import decoder
    from wct_tpu_torch.ops import adain

    rng = np.random.default_rng(4)
    f = torch.from_numpy(np.maximum(rng.standard_normal((4, 64, 128, 128)), 0).astype(np.float32))
    f = (f * 3).to(card).to(torch.bfloat16)
    style = torch.from_numpy((rng.random((1, 64, 900)) * 2).astype(np.float32)).to(card)
    scale, bias = adain.adain_transform_cn(f.flatten(2), adain.adain_stats_cn(style), 0.8)
    w = torch.from_numpy(((rng.random((3, 64, 3, 3)) - 0.5) * 0.2).astype(np.float32)).to(card)
    b = torch.from_numpy(rng.random(3).astype(np.float32)).to(card)
    wf, bf = decoder.fold_affine_into_conv(scale, bias, w, b)
    got = junction.decoder_tail_cuda(f, wf, bf, False)
    ref64 = junction._decoder_tail_plain(f, wf, bf, False, acc=torch.float64)
    ref = junction._decoder_tail_plain(f, wf, bf, False)
    torch.cuda.synchronize()
    for r in (ref64, ref):
        bitwise, within, _ = _agreement(got, r)
        assert bitwise >= 0.99 and within == 1.0, (bitwise, within)


# ---- the stream and bucketed serving engines on the card ----


@pytest.fixture(scope="module")
def bundle_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from pathlib import Path

    from wct_tpu_torch.train import checkpoint

    bundle = Path(__file__).resolve().parent.parent / "weights" / "bundle.npz"
    return checkpoint.params_from_numpy(checkpoint.load_pytree(bundle), "cuda")


_BF16_FUSED = dict(compute_dtype="bfloat16", method="newton_schulz_fast", fuse_junction=True)


@pytest.mark.parametrize("fb", [1, 3])
@pytest.mark.parametrize("depth", [1, 2])
def test_stream_pipelined_equals_strict_on_card(card, bundle_on_card, depth, fb):
    """The copy stream's ordering and the pinned ring: submit-ahead gives
    strict mode's bits, in order, with 7 frames (a partial last group),
    also when every host slot is in flight before the first collect."""
    from wct_tpu_torch.models import cascade
    from wct_tpu_torch.utils.stream import StreamStylizer

    rng = np.random.default_rng(depth * 10 + fb)
    eng = StreamStylizer(bundle_on_card, cascade.CascadeConfig(**_BF16_FUSED), 128, 192,
                         readback="uint8", pipeline_depth=depth, frame_batch=fb)
    eng.alpha = 0.7
    eng.set_style(rng.random((160, 160, 3), dtype=np.float32))
    frames = [rng.random((128, 192, 3), dtype=np.float32) for _ in range(7)]
    strict = [eng.process(f) for f in frames]
    piped = [eng.process_pipelined(f) for f in frames]
    while (tail := eng.collect()) is not None:
        piped.append(tail)
    piped = [p for p in piped if p is not None]
    assert len(piped) == 7 and eng.n_pending == 0
    for a, b in zip(strict, piped):
        np.testing.assert_array_equal(a, b)
    for f in frames:
        eng.submit(f)
    burst = [eng.collect() for _ in range(7)]
    for a, b in zip(strict, burst):
        np.testing.assert_array_equal(a, b)
    assert all(np.isfinite(o).all() and o.min() >= 0 and o.max() <= 1 for o in strict)


def test_stream_uint8_readback_is_the_host_quantisation_on_card(card, bundle_on_card):
    from wct_tpu_torch.models import cascade
    from wct_tpu_torch.utils.stream import StreamStylizer

    rng = np.random.default_rng(5)
    cfg = cascade.CascadeConfig(**_BF16_FUSED)
    style = rng.random((128, 128, 3), dtype=np.float32)
    engines = [StreamStylizer(bundle_on_card, cfg, 96, 160, readback=r) for r in ("float32", "uint8")]
    for eng in engines:
        eng.set_style(style)
    for _ in range(3):
        frame = rng.random((96, 160, 3), dtype=np.float32)
        out_f, out_u = (eng.process(frame) for eng in engines)
        host = (np.clip(out_f, 0, 1) * 255).astype(np.uint8)
        np.testing.assert_array_equal(host, np.rint(out_u * 255).astype(np.uint8))


def test_bucketed_stylizer_exact_sizes_on_card(card, bundle_on_card):
    """Every size comes back exactly, through the fused kernels (buckets
    are multiples of 16), and equals stylize on the padded input, cropped."""
    from wct_tpu_torch.models import cascade
    from wct_tpu_torch.utils.serving import BucketedStylizer, pad_to_bucket

    rng = np.random.default_rng(6)
    cfg = cascade.CascadeConfig(**_BF16_FUSED)
    eng = BucketedStylizer(bundle_on_card, cfg, granularity=64)
    eng.set_style(rng.random((128, 128, 3), dtype=np.float32))
    for h, w in [(30, 40), (64, 64), (65, 127), (200, 90)]:
        img = rng.random((h, w, 3), dtype=np.float32)
        before = junction.encoder_head_cuda.launches_by_dtype["bf16"]
        out = eng.stylize(img, 0.6)
        assert out.shape == (h, w, 3) and np.isfinite(out).all()
        assert junction.encoder_head_cuda.launches_by_dtype["bf16"] == before + 1
        padded, _ = pad_to_bucket(img, 64)
        ref = cascade.stylize(bundle_on_card, torch.as_tensor(padded, device=card)[None],
                              eng._cache, 0.6, cfg)[0, :h, :w].cpu().numpy()
        np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_centered_gram_at_720p_against_float64(card, dtype):
    """The Gram at relu1_1 of a 1280×720 frame batch (N = 921,600), as the
    stream route hands it: within 1e-6 of float64, exactly symmetric,
    alone = batch."""
    rng = np.random.default_rng(7)
    x = np.maximum(rng.standard_normal((2, 64, 921600), dtype=np.float32) - 0.7388, 0)
    x = torch.from_numpy(x).to(dtype).to(card)
    got, mean = gram.centered_gram_cn(x)
    x64 = x.double()
    c64 = x64 - x64.mean(-1, keepdim=True)
    g64 = c64 @ c64.mT
    assert _gram_rel(got.double(), g64) <= 1e-6
    assert torch.equal(got, got.mT)
    alone, _ = gram.centered_gram_cn(x[1:])
    assert torch.equal(alone[0], got[1])
