"""The port's small-channel 3×3 reflect conv against the three TPU kernels.

The same numpy arrays, rounded to bf16 from the same f32 values, go
through ``wct_tpu``'s Pallas kernels (interpret mode on the CPU, as
``tests/test_convs.py`` runs them) and through the plain version the
port takes for a CPU tensor. Both sum exact bf16 × bf16 products in f32
and round once, so they differ only where the order of the f32 sum
moves a value across a bf16 rounding point: by one bf16 ulp, which is
at most 2⁻⁷·|ref|. Bound per element ``|Δ| ≤ 2⁻⁷·|ref| + 1e-5·max|ref|``
(the reference's own test allows 0.1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scripts.exp_nchw_conv import conv3x3_reflect_nchw, conv3x3_reflect_nhwc_io
from wct_tpu.ops import conv_pallas
from wct_tpu.ops import convs as jconvs
from wct_tpu_torch.ops import conv_small
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


def _bf16(a):
    """Round f32 numpy values to bf16, returned as f32 numpy."""
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _case(seed, shape, cin, cout):
    rng = np.random.default_rng(seed)
    x = _bf16(rng.standard_normal((*shape, cin)).astype(np.float32))
    w = _bf16((rng.standard_normal((3, 3, cin, cout)) * 0.1).astype(np.float32))
    b = (rng.standard_normal(cout) * 0.1).astype(np.float32)
    return x, w, b


def _t(x):
    return torch.from_numpy(np.array(x)).to(torch.bfloat16)


def _within_one_ulp(got, ref):
    got = got.float().numpy().astype(np.float64)
    ref = np.asarray(ref.astype(jnp.float32), np.float64)
    assert got.shape == ref.shape
    limit = 2.0**-7 * np.abs(ref) + 1e-5 * np.abs(ref).max()
    worst = (np.abs(got - ref) - limit).max()
    assert worst <= 0, f"{(np.abs(got - ref) > limit).sum()} elements past one bf16 ulp"


CASES = [
    ((2, 16, 24), 64, 3, False),   # the reference test's fulltap case
    ((1, 8, 16), 64, 64, True),    # rowpack
    ((2, 32, 16), 3, 64, True),    # rowpack, 3 input channels
    ((2, 16, 24), 64, 64, False),  # rowpack without ReLU
]
IDS = ["64to3", "64to64_relu", "3to64_relu", "64to64"]


@pytest.mark.parametrize("shape,cin,cout,relu", CASES, ids=IDS)
def test_plain_matches_conv3x3_reflect_pallas(shape, cin, cout, relu):
    x, w, b = _case(cin + cout, shape, cin, cout)
    xj, wj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    assert conv_pallas._eligible(xj, wj)
    ref = conv_pallas.conv3x3_reflect_pallas(xj, wj, jnp.asarray(b), relu)
    tw, tb = conv_small.weights_from_hwio(w, b, device="cpu")
    assert conv_small._eligible(_t(x), tw)
    got = conv_small.conv3x3_reflect_small(_t(x), tw, tb, relu)
    assert got.dtype == torch.bfloat16
    _within_one_ulp(got, ref)
    # the NCHW entry is the same function on the permuted map
    got_nchw = conv_small.conv3x3_reflect_small_nchw(tconvs.to_nchw(_t(x)), tw, tb, relu)
    assert torch.equal(tconvs.to_nhwc(got_nchw), got)
    # and the dispatcher routes an eligible conv the same way
    fused = conv_small.conv2d_reflect_fused(_t(x), tw, tb, relu, impl="pallas_small")
    assert torch.equal(fused, got)


def test_plain_matches_exp_nchw_kernel():
    """``scripts/exp_nchw_conv.conv3x3_reflect_nchw`` at [2, 64, 32, 128]."""
    x, w, b = _case(7, (32, 128, 2), 64, 64)  # drawn as [H, W, B, C]
    xn = np.ascontiguousarray(x.transpose(2, 3, 0, 1))
    ref = conv3x3_reflect_nchw(jnp.asarray(xn, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                               jnp.asarray(b), True)
    tw, tb = conv_small.weights_from_hwio(w, b, device="cpu")
    _within_one_ulp(conv_small.conv3x3_reflect_small_nchw(_t(xn), tw, tb, True), ref)


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "linear"])
def test_plain_matches_exp_nhwc_io_kernel(relu):
    """``conv3x3_reflect_nhwc_io`` (no test in the reference) at H = 16, W = 24."""
    x, w, b = _case(8, (2, 16, 24), 64, 64)
    ref = conv3x3_reflect_nhwc_io(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16),
                                  jnp.asarray(b), relu)
    tw, tb = conv_small.weights_from_hwio(w, b, device="cpu")
    _within_one_ulp(conv_small.conv3x3_reflect_small(_t(x), tw, tb, relu), ref)


ELIGIBILITY = [
    # (x shape NHWC, w shape HWIO, dtype, why)
    ((1, 8, 8, 64), (3, 3, 64, 64), "bfloat16"),
    ((2, 16, 24, 64), (3, 3, 64, 3), "bfloat16"),
    ((1, 32, 16, 3), (3, 3, 3, 64), "bfloat16"),
    ((1, 8, 20, 64), (3, 3, 64, 3), "bfloat16"),    # W not a multiple of 8
    ((1, 12, 16, 64), (3, 3, 64, 64), "bfloat16"),  # H not a multiple of 8
    ((1, 4, 16, 64), (3, 3, 64, 64), "bfloat16"),   # H below 8
    ((1, 16, 4, 64), (3, 3, 64, 64), "bfloat16"),   # W below 8
    ((1, 16, 16, 128), (3, 3, 128, 64), "bfloat16"),  # too many input channels
    ((1, 16, 16, 64), (3, 3, 64, 128), "bfloat16"),   # too many output channels
    ((1, 16, 16, 64), (1, 1, 64, 64), "bfloat16"),    # not 3×3
    ((1, 16, 16, 64), (3, 3, 64, 64), "float32"),     # not bf16
]


@pytest.mark.parametrize("xs,ws,dtype", ELIGIBILITY,
                         ids=[f"{x}-{w}-{d}".replace(" ", "") for x, w, d in ELIGIBILITY])
def test_eligible_agrees_with_reference(xs, ws, dtype):
    """Small widths only, where the reference's scratch-memory clause,
    the one the port drops, never decides."""
    ref = conv_pallas._eligible(jnp.zeros(xs, getattr(jnp, dtype)), jnp.zeros(ws, jnp.bfloat16))
    w = torch.zeros(ws).permute(3, 2, 0, 1)
    assert conv_small._eligible(torch.zeros(xs, dtype=getattr(torch, dtype)), w) == ref


@pytest.mark.parametrize("impl,width", [("pallas_small", 20), ("xla", 24)],
                         ids=["ineligible", "impl_xla"])
@pytest.mark.parametrize("relu", [False, True], ids=["linear", "relu"])
def test_dispatcher_returns_stock_conv(impl, width, relu):
    """Bit for bit the port's stock conv (+ ReLU), itself within an ulp
    or two of the reference's stock conv (both round the sum, then add
    the bf16 bias: |Δ| ≤ 2⁻⁷·(|ref| + max|b|))."""
    x, w, b = _case(9, (1, 8, width), 64, 3)
    tw, tb = conv_small.weights_from_hwio(w, b, device="cpu")
    got = conv_small.conv2d_reflect_fused(_t(x), tw, tb, relu, impl=impl)
    stock = tconvs.conv2d_reflect(_t(x), tw, tb)
    assert torch.equal(got, torch.relu(stock) if relu else stock)
    ref = conv_pallas.conv2d_reflect_fused(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16), jnp.asarray(b), relu, impl)
    ref = np.asarray(ref.astype(jnp.float32), np.float64)
    d = np.abs(got.float().numpy() - ref)
    assert (d <= 2.0**-7 * (np.abs(ref) + np.abs(b).max())).all()


def test_weights_from_hwio_is_the_checkpoint_layout():
    from wct_tpu_torch.train import checkpoint

    _, w, b = _case(3, (1, 8, 8), 5, 7)
    tw, tb = conv_small.weights_from_hwio(w, b, device="cpu")
    tree = checkpoint.params_from_numpy({"w": w, "b": b}, "cpu")
    assert torch.equal(tw, tree["w"]) and torch.equal(tb, tree["b"])
    assert tw.shape == (7, 5, 3, 3) and tw.dtype == torch.float32


@pytest.mark.parametrize("case", ["float32", "rank3", "w_not_8", "bad_bias", "bad_cin"])
def test_wrappers_reject_what_the_kernel_does_not_take(case):
    x, w, b = _case(4, (1, 8, 16), 64, 64)
    tw, tb = conv_small.weights_from_hwio(w, b, device="cpu")
    xt = _t(x)
    args = {
        "float32": (xt.float(), tw, tb),
        "rank3": (xt[0], tw, tb),
        "w_not_8": (xt[:, :, :12], tw, tb),
        "bad_bias": (xt, tw, tb[:3]),
        "bad_cin": (xt[..., :32], tw, tb),
    }[case]
    with pytest.raises((TypeError, ValueError)):
        conv_small.conv3x3_reflect_small(*args)


def test_kernel_wrapper_needs_the_card():
    x, w, b = _case(5, (1, 8, 8), 64, 3)
    tw, tb = conv_small.weights_from_hwio(w, b, device="cpu")
    before = conv_small.conv3x3_small_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        conv_small.conv3x3_small_cuda(_t(x), tw, tb, nhwc=True)
    assert conv_small.conv3x3_small_cuda.launches == before


def test_taps_layout():
    """The weights as the kernel lays them out in shared memory
    (``_weight_layout``, written by ``csrc/conv3x3_small.cu`` from OIHW):
    k-group ``tap·G + g`` of output channel ``n`` in 16-byte unit ``(kg %
    8) ^ (n % 8)`` of row ``n`` of chunk ``kg // 8``; zero-padded in
    channels, in ``n`` to 8 (C_out ≤ 8) or 64, and past the last k-group."""
    _, w, b = _case(6, (1, 8, 8), 3, 64)
    tw, tb = conv_small.weights_from_hwio(w, b, device="cpu")
    bits = lambda t: t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)  # noqa: E731

    def unit(lay, c, n, u, co_pad):
        off = c * co_pad * 128 + (n // 8) * 1024 + (n % 8) * 128 + 16 * (u ^ (n % 8))
        return lay[off // 2: off // 2 + 8]

    lay = conv_small._weight_layout(tw)
    assert lay.dtype == np.uint16 and lay.size == 2 * 64 * 64  # G = 1: 9 k-groups, two chunks
    for n in (0, 9, 63):  # tap 5 = (dy 1, dx 2), input channel 2
        assert unit(lay, 0, n, 5, 64)[2] == bits(tw[n, 2, 1, 2])
        assert not unit(lay, 0, n, 5, 64)[3:].any()
    np.testing.assert_array_equal(unit(lay, 1, 5, 0, 64)[:3], bits(tw[5, :, 2, 2]))  # k-group 8: tap 8
    assert all(not unit(lay, 1, n, u, 64).any() for n in range(64) for u in range(1, 8))
    w62 = tw.permute(1, 0, 2, 3)[:, :62].contiguous()  # 62 -> 3: G = 8, rows padded to 8
    lay = conv_small._weight_layout(w62)
    assert lay.size == 9 * 8 * 64
    for n in range(3):  # tap 7 = (dy 2, dx 1), group 3 = channels 24..31: k-group 59
        np.testing.assert_array_equal(unit(lay, 7, n, 3, 8), bits(w62[n, 24:32, 2, 1]))
        assert not unit(lay, 7, n, 7, 8)[6:].any()  # channels 62, 63
    assert all(not unit(lay, c, n, u, 8).any() for c in range(9) for n in range(3, 8) for u in range(8))


def test_reference_stock_conv_matches_port_bf16():
    """bf16 ``conv2d_reflect`` (64 → 128, outside the kernel's gate)
    against the reference: |Δ| ≤ 2⁻⁷·(|ref| + max|b|)."""
    rng = np.random.default_rng(10)
    x = _bf16(rng.standard_normal((2, 12, 10, 64)).astype(np.float32))
    w = (rng.standard_normal((3, 3, 64, 128)) * 0.1).astype(np.float32)
    b = (rng.standard_normal(128) * 0.1).astype(np.float32)
    ref = jconvs.conv2d_reflect(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), jnp.asarray(b))
    assert ref.dtype == jnp.bfloat16
    tw, tb = conv_small.weights_from_hwio(w, b, device="cpu")
    got = tconvs.conv2d_reflect(_t(x), tw, tb)
    assert got.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32), np.float64)
    d = np.abs(got.float().numpy() - ref)
    assert (d <= 2.0**-7 * (np.abs(ref) + np.abs(b).max())).all()
