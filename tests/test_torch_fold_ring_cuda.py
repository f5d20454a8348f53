"""The ring conv and the per-image conv on the card, and their conv choices.

Every test here needs an NVIDIA GPU and skips without one; run them on
the card's machine with

    python -m pytest --noconftest -q -m cuda tests/test_torch_fold_ring_cuda.py

Each conv on the card is held to its plain form on the CPU: f32 to 1e-5
of the map's largest value; bf16 within one bf16 ulp of the conv's sum
before its bias, ``|Δ| ≤ 2⁻⁷·(|ref| + max|b|) + 1e-5·max|ref|``. A bf16
conv rounds its f32 sum and then adds the bf16 bias (two roundings, as
``ops/convs.py`` says), so where cuDNN's sum and the CPU's straddle a
rounding point they part by one ulp of the sum, which the bias may have
shifted far from the output's own ulp (``chip_smoke.py``'s small-conv
check against the stock conv has the same bar). The conv choices are kept
in a file of each test's own (``convs.CHOICES_PATH``).
"""

import json

import pytest
import torch

from wct_tpu_torch.ops import convs
from wct_tpu_torch.utils.device import set_numerics

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def choices(card, tmp_path, monkeypatch):
    """A fresh choice file and empty in-process tables."""
    path = tmp_path / "conv_choices.json"
    monkeypatch.setattr(convs, "CHOICES_PATH", path)
    monkeypatch.setattr(convs, "_CUDNN_OK", {})
    return path


def _close(got: torch.Tensor, ref: torch.Tensor, b: torch.Tensor) -> bool:
    got, ref = got.double().cpu(), ref.double().cpu()
    bar = 2.0**-7 * (ref.abs() + float(b.abs().max())) + 1e-5 * ref.abs().max()
    return bool(((got - ref).abs() <= bar).all())


def _inputs(shape, co, k, seed, per_image=False):
    g = torch.Generator().manual_seed(seed)
    b, ci = shape[:2]
    x = torch.randn(*shape, generator=g)
    w = torch.randn(*((b,) if per_image else ()), co, ci, k, k, generator=g) * (2.0 / (k * k * ci)) ** 0.5
    bias = torch.randn(*((b,) if per_image else ()), co, generator=g)
    return x, w, bias


# The cascade's shapes at 128 px, a thin map, a map below 2p (k = 5) and
# the 1×1 pass-through.
RING_CASES = [((2, 64, 128, 128), 64, 3), ((2, 256, 32, 32), 256, 3), ((1, 3, 96, 80), 64, 3),
              ((1, 64, 2, 40), 64, 3), ((1, 8, 3, 9), 6, 5), ((2, 5, 7, 7), 6, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,co,k", RING_CASES, ids=lambda v: str(v))
def test_ring_conv_on_the_card_is_its_plain_form(card, choices, shape, co, k, dtype):
    set_numerics(dtype)
    x, w, b = _inputs(shape, co, k, 0)
    x = x.to(dtype)
    ref = convs.conv2d_reflect_ring_nchw(x, w, b)
    got = convs.conv2d_reflect_ring_nchw(x.to(card), w.to(card), b.to(card))
    assert got.dtype == dtype and got.shape == ref.shape
    if dtype == torch.float32:
        assert float((got.cpu() - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    else:
        assert _close(got, ref, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape,co", [((4, 64, 128, 128), 3), ((4, 128, 64, 64), 128), ((1, 64, 37, 45), 64)],
                         ids=lambda v: str(v))
def test_perimage_conv_on_the_card_is_its_plain_form(card, choices, shape, co, dtype):
    set_numerics(dtype)
    x, w, b = _inputs(shape, co, 3, 1, per_image=True)
    x = x.to(dtype)
    ref = convs.conv2d_reflect_perimage_nchw(x, w, b)
    got = convs.conv2d_reflect_perimage_nchw(x.to(card), w.to(card), b.to(card))
    assert got.dtype == dtype and got.shape == ref.shape
    if dtype == torch.float32:
        assert float((got.cpu() - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    else:
        assert _close(got, ref, b)
    # The last image's output is that image's conv alone.
    one = convs.conv2d_reflect_nchw(x[-1:].to(card), w[-1].to(card), b[-1].to(card))
    if dtype == torch.float32:
        assert float((got[-1:] - one).abs().max()) <= 1e-5 * float(one.abs().max())
    else:
        assert _close(got[-1:], one, b[-1])


def _entries(path) -> dict:
    (card_entry,) = json.loads(path.read_text()).values()
    return card_entry["inference"]


def test_same_and_valid_convs_of_equal_shapes_have_separate_entries(card, choices):
    """A ring's SAME conv of ``[B, C, H, W]`` and ``conv2d_valid_nchw`` of a
    padded map of that same shape are two entries of the choice file."""
    set_numerics(torch.float32)
    x, w, b = _inputs((2, 64, 66, 66), 64, 3, 2)
    x, w, b = x.to(card), w.to(card), b.to(card)
    convs.conv2d_valid_nchw(x, w, b)
    convs.conv2d_reflect_ring_nchw(x, w, b)
    torch.cuda.synchronize()
    shapes = set(_entries(choices))
    assert "[2, 64, 66, 66] [64, 64, 3, 3] float32" in shapes
    assert "[2, 64, 66, 66] [64, 64, 3, 3] float32 padding=1" in shapes
    # The ring's four strips are VALID convs of their own shapes.
    assert "[2, 64, 3, 68] [64, 64, 3, 3] float32" in shapes
    assert "[2, 64, 68, 3] [64, 64, 3, 3] float32" in shapes


def test_a_grouped_conv_never_shares_an_entry(card, choices):
    """The per-image conv's grouped conv carries ``groups=B`` in its key,
    in each dtype: no VALID or SAME conv's key can equal it."""
    x, w, b = _inputs((2, 64, 32, 32), 3, 3, 3, per_image=True)
    for dtype in (torch.float32, torch.bfloat16):
        set_numerics(dtype)
        convs.conv2d_reflect_perimage_nchw(x.to(card, dtype), w.to(card), b.to(card))
    torch.cuda.synchronize()
    assert set(_entries(choices)) == {"[1, 128, 34, 34] [6, 64, 3, 3] float32 groups=2",
                                      "[1, 128, 34, 34] [6, 64, 3, 3] bfloat16 groups=2"}
