"""The encoder head and the decoder tail kernels at their designs' edges, on the card.

``csrc/encoder_head.cu`` walks tiles of 32 rows × 16 columns with
persistent blocks (a tile may reach below the image: H = 16, 48 and 720
leave a partial last row of tiles) and runs conv1_2 on ``wgmma``;
``csrc/decoder_tail.cu`` reads 64 × 64 tiles with a one-pixel halo, one
source for both operand types. These tests hold both forms of both
kernels to their plain versions (and the bf16 head to a float64
evaluation of its rounding rule) at small, 512 × 512 and 720 × 1280
shapes, with the clip on and off, alone against in a batch. Every test
needs an NVIDIA GPU and skips without one; the file imports neither JAX
nor ``wct_tpu``:

    python -m pytest --noconftest -q -m cuda tests/test_torch_head_tail_cuda.py
"""

import numpy as np
import pytest
import torch

from wct_tpu_torch.ops import conv_small, junction

pytestmark = pytest.mark.cuda

# f32: sums of up to 576 terms in another order (3×TF32 in conv1_2) after
# conv0's O(255) weights: max |Δ| ≤ 1e-4 of the map's max (chip_smoke.py's
# JUNCTION_LIMIT). bf16: the chip phase's bars (chip_smoke.py BF16_*).
LIMIT = 1e-4
BF16_BITWISE, BF16_WITHIN, BF16_CHAIN_MAX = 0.99, 0.995, 2e-2
SHAPES = [(1, 16, 16), (2, 48, 32), (3, 64, 16), (1, 720, 1280), (4, 512, 512)]
IDS = ["b1_16x16", "b2_48x32", "b3_64x16", "b1_720x1280", "b4_512x512"]
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from wct_tpu_torch.utils.device import set_fp32_numerics

    set_fp32_numerics()
    return torch.device("cuda")


@pytest.fixture(scope="module")
def head_weights():
    """(we1, be1, w12, b12) on the CPU: conv1_1 with conv0 folded in at
    ×255 as the trained model's, conv1_2 He-scaled."""
    rng = np.random.default_rng(11)
    out = []
    for co, ci, scale in ((64, 3, 255.0), (64, 64, 1.0)):
        w = rng.standard_normal((co, ci, 3, 3)) * np.sqrt(2.0 / (9 * ci)) * scale
        out += [torch.from_numpy(w.astype(np.float32)),
                torch.from_numpy((rng.standard_normal(co) * 0.1).astype(np.float32))]
    return out


def _rand(seed, *shape):
    return torch.from_numpy(np.random.default_rng(seed).random(shape).astype(np.float32))


def _rel_max(a, b):
    return float((a.double() - b.double()).abs().max() / b.double().abs().max())


def _agreement(got, ref):
    """(share bitwise equal, share within one bf16 ulp, max |Δ| / max |ref|)."""
    got, ref = got.float(), ref.float()
    d = (got - ref).abs()
    excess = d - (2.0**-7 * ref.abs() + 1e-5 * ref.abs().max())
    return (float((d == 0).float().mean()), float((excess <= 0).float().mean()),
            float(d.max() / ref.abs().max()))


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,w", SHAPES, ids=IDS)
def test_encoder_head_against_plain_and_float64(card, head_weights, b, h, w, dtype):
    x = _rand(h + 3 * w, b, 3, h, w).to(card).to(dtype)
    args = [t.to(card) for t in head_weights]
    before = dict(junction.encoder_head_cuda.launches_by_dtype)
    got = junction.encoder_head_cuda(x, *args)
    name = junction.DTYPES[dtype]
    assert junction.encoder_head_cuda.launches_by_dtype == {**before, name: before[name] + 1}
    ref = junction._encoder_head_plain(x, *args)
    torch.cuda.synchronize()
    assert got.dtype == dtype and tuple(got.shape) == (b, 64, h // 2, w // 2)
    assert bool(torch.isfinite(got.float()).all())
    if dtype == torch.float32:
        assert _rel_max(got, ref) <= LIMIT
        if h * w <= 64 * 64:
            ref64 = junction._encoder_head_plain(x.double(), *[a.double() for a in args])
            assert _rel_max(got, ref64) <= 1e-5
    else:
        bitwise, within, rel_max = _agreement(
            got, junction._encoder_head_plain(x, *args, acc=torch.float64))
        assert bitwise >= BF16_BITWISE and within >= BF16_WITHIN and rel_max <= BF16_CHAIN_MAX, (
            bitwise, within, rel_max)
        assert _agreement(got, ref)[2] <= BF16_CHAIN_MAX
    assert torch.equal(got, junction.encoder_head_cuda(x, *args))
    alone = junction.encoder_head_cuda(x[-1:].contiguous(), *args)
    assert torch.equal(alone[0], got[-1])


@pytest.mark.parametrize("clip", [False, True], ids=["noclip", "clip"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("b,h,w", SHAPES, ids=IDS)
def test_decoder_tail_against_plain(card, b, h, w, dtype, clip):
    f = _rand(5 * h + w, b, 64, h, w).to(card).to(dtype)
    wt = ((_rand(1, b, 3, 64, 3, 3) - 0.5) * 0.2).to(card)
    bias = (_rand(2, b, 3) - 0.25).to(card)
    before = dict(junction.decoder_tail_cuda.launches_by_dtype)
    small = conv_small.conv3x3_small_cuda.launches
    got = junction.decoder_tail_cuda(f, wt, bias, clip)
    name = junction.DTYPES[dtype]
    assert junction.decoder_tail_cuda.launches_by_dtype == {**before, name: before[name] + 1}
    assert conv_small.conv3x3_small_cuda.launches == small
    ref = junction._decoder_tail_plain(f, wt, bias, clip)
    torch.cuda.synchronize()
    assert got.dtype == dtype and tuple(got.shape) == (b, 3, h, w)
    if dtype == torch.float32:
        assert _rel_max(got, ref) <= LIMIT
    else:
        bitwise, within, _ = _agreement(got, ref)
        assert bitwise >= BF16_BITWISE and within == 1.0, (bitwise, within)
    if clip:
        assert float(got.float().min()) >= 0.0 and float(got.float().max()) <= 1.0
        assert not torch.equal(got, junction.decoder_tail_cuda(f, wt, bias, False))
    assert torch.equal(got, junction.decoder_tail_cuda(f, wt, bias, clip))
    for i in range(b):  # per-image weights: each image alone gives the bits of the batch
        alone = junction.decoder_tail_cuda(f[i: i + 1].contiguous(), wt[i: i + 1].contiguous(),
                                           bias[i: i + 1].contiguous(), clip)
        assert torch.equal(alone[0], got[i])


@pytest.mark.parametrize("kernel", ["encoder_head", "decoder_tail"])
def test_head_and_tail_refuse_a_map_off_a_16_byte_boundary(card, head_weights, kernel):
    """The bf16 head copies rows of its image in 16-byte pieces, and the
    tail's TMA tensor map needs a 16-byte base: a bf16 map that starts off
    such a boundary raises, and launches nothing."""
    c = 3 if kernel == "encoder_head" else 64
    buf = torch.zeros(2 * c * 32 * 32 + 1, device=card, dtype=torch.bfloat16)
    x = buf[1:].view(2, c, 32, 32)
    fn = getattr(junction, f"{kernel}_cuda")
    before = fn.launches
    with pytest.raises(ValueError, match="16-byte boundary"):
        if kernel == "encoder_head":
            fn(x, *[t.to(card) for t in head_weights])
        else:
            fn(x, torch.rand(2, 3, 64, 3, 3, device=card), torch.rand(2, 3, device=card))
    assert fn.launches == before


def test_f32_head_takes_an_image_off_a_16_byte_boundary(card, head_weights):
    """The f32 head copies each value on its own: an image 4 bytes past a
    16-byte boundary launches, and gives the bits of the same image on one."""
    x = _rand(9, 2, 3, 32, 48).to(card)
    buf = torch.zeros(x.numel() + 1, device=card)
    shifted = buf[1:].view_as(x)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 == 4
    args = [t.to(card) for t in head_weights]
    assert torch.equal(junction.encoder_head_cuda(shifted, *args),
                       junction.encoder_head_cuda(x, *args))
