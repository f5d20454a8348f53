"""pack2 and the int8 conv on the card.

Every test here needs an NVIDIA GPU and skips without one; run them on
the card's machine with

    python -m pytest --noconftest -q -m cuda tests/test_torch_pack2_cuda.py

pack2's routes on the trained bundle at 128 px, batch 4, against the
same route with pack2 off (the bars of ``chip_smoke.py``'s rewrites:
f32 q99 ≤ 5e-3; bf16, where a chain of bf16 convs flips single
roundings, q99 ≤ 0.05 and median ≤ 4e-3), an odd batch bitwise equal to
pack2 off, and the Gram kernel launched once per level and microbatch.
The int8 conv's integer sums on the card (``torch._int_mm``) against a
float64 conv of the same quantized tensors on the card, bitwise.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wct_tpu_torch.models import cascade
from wct_tpu_torch.ops import convs, gram
from wct_tpu_torch.train import checkpoint as tck

pytestmark = pytest.mark.cuda

BUNDLE = Path(__file__).resolve().parent.parent / "weights" / "bundle.npz"
ROUTES = {
    "f32_ns_pallas": dict(method="newton_schulz_pallas"),
    "bf16_throughput": dict(compute_dtype="bfloat16", method="newton_schulz_fast",
                            compose_conv0=True),
}
SCOPES = {"pack2": {}, "tail_only": dict(pack2_tail_only=True),
          "junction_only": dict(pack2_junction_only=True)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def setup(card):
    rng = np.random.default_rng(0)
    return (tck.params_from_numpy(tck.load_pytree(BUNDLE), card),
            rng.random((4, 128, 128, 3), np.float32), rng.random((128, 128, 3), np.float32))


@pytest.mark.parametrize("scope", list(SCOPES))
@pytest.mark.parametrize("route", list(ROUTES))
def test_pack2_route_against_pack2_off(setup, route, scope):
    params, content, style = setup
    cfg = cascade.CascadeConfig(**ROUTES[route])
    on = dataclasses.replace(cfg, pack2_junction=True, **SCOPES[scope])
    cache = cascade.precompute_style(params["encoder"], style, cfg)
    base = gram.centered_gram_cuda.launches
    got = cascade.stylize(params, content, cache, 0.6, on)
    torch.cuda.synchronize()
    assert gram.centered_gram_cuda.launches - base == 5
    ref = cascade.stylize(params, content, cache, 0.6, cfg)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    d = (got - ref).abs().flatten()
    q99 = float(torch.quantile(d[::3], 0.99))
    if route == "f32_ns_pallas":
        assert q99 <= 5e-3, q99
    else:
        assert q99 <= 0.05 and float(d.median()) <= 4e-3, (q99, float(d.median()))


def test_odd_batch_is_pack2_off_bitwise(setup):
    params, content, style = setup
    cfg = cascade.CascadeConfig(**ROUTES["f32_ns_pallas"])
    cache = cascade.precompute_style(params["encoder"], style, cfg)
    on = cascade.stylize(params, content[:3], cache, 0.6, dataclasses.replace(cfg, pack2_junction=True))
    assert torch.equal(on, cascade.stylize(params, content[:3], cache, 0.6, cfg))


def test_microbatched_pack2_alone_equals_batch(setup):
    params, content, style = setup
    cfg = cascade.CascadeConfig(**ROUTES["bf16_throughput"], pack2_junction=True)
    cache = cascade.precompute_style(params["encoder"], style, cfg)
    batch = cascade.stylize_microbatched(params, content, cache, 0.6, cfg, microbatch=4)
    alone = cascade.stylize_microbatched(params, content[2:3], cache, 0.6, cfg, microbatch=4)
    assert torch.equal(alone[0], batch[2])


@pytest.mark.parametrize("shape,co,k", [((2, 64, 66, 34), 64, 3), ((1, 128, 34, 18), 256, 3),
                                        ((1, 3, 5, 4), 5, 3), ((2, 5, 9, 9), 7, 1)],
                         ids=["64to64", "128to256", "few_rows", "1x1_unaligned"])
def test_int8_sums_exact_on_the_card(card, shape, co, k):
    """Every entry ±127, so the sums reach 9·128·127² ≈ 1.9e7: the card's
    int32 sums equal a float64 conv of the same tensors on the card."""
    g = torch.Generator().manual_seed(1)
    xq = (torch.randint(0, 2, shape, generator=g) * 254 - 127).to(torch.int8).to(card)
    wq = (torch.randint(0, 2, (co, shape[1], k, k), generator=g) * 254 - 127).to(torch.int8).to(card)
    got = convs.conv2d_int8_sums_nchw(xq, wq)
    ref = F.conv2d(xq.double(), wq.double())
    assert got.dtype == torch.int32 and torch.equal(got.double(), ref)


def test_int8_conv_on_the_card_is_the_cpu_result(card):
    """Quantization, sums and dequantization on the card give the CPU's
    bits (the sums are exact on both)."""
    g = torch.Generator().manual_seed(2)
    x = torch.rand(2, 24, 20, 64, generator=g)
    w = torch.randn(64, 64, 3, 3, generator=g) * 0.06
    b = torch.randn(64, generator=g)
    wq, ws = convs.quantize_weight_int8(w)
    cpu = convs.conv2d_reflect_int8(x, wq, ws, b)
    got = convs.conv2d_reflect_int8(x.to(card), wq.to(card), ws.to(card), b.to(card))
    assert torch.equal(got.cpu(), cpu)
    assert torch.equal(convs.quantize_weight_int8(w.to(card))[0].cpu(), wq)
