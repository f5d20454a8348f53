"""The port's bf16 throughput path against ``wct_tpu``'s, on the CPU.

``CascadeConfig(compute_dtype="bfloat16", method="newton_schulz_fast",
compose_conv0=True)``: the JAX package's throughput preset without its
TPU-lane rewrite ``pack2_junction``. bf16 inputs are the same f32 numpy
values rounded to bf16 in both frameworks; every bf16 result is upcast
to f32 before numpy touches it. Each tolerance stands beside its test.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wct_tpu.models import cascade as jcascade
from wct_tpu.ops import sqrtm as jsqrtm
from wct_tpu.ops import wct as jwct
from wct_tpu.train import checkpoint as jck
from wct_tpu_torch.cli import common as tcommon
from wct_tpu_torch.cli import stylize as tstylize
from wct_tpu_torch.models import cascade as tcascade
from wct_tpu_torch.ops import reductions, sqrtm
from wct_tpu_torch.ops import wct as twct
from wct_tpu_torch.train import checkpoint as tck
from wct_tpu_torch.utils import device, images

BUNDLE = Path(__file__).resolve().parent.parent / "weights" / "bundle.npz"
THROUGHPUT = dict(compute_dtype="bfloat16", method="newton_schulz_fast", compose_conv0=True)
SIZE = 128


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
    return np.asarray(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _t16(a):
    return torch.from_numpy(np.array(a)).to(torch.bfloat16)


def _f32(x):
    """A JAX array, bf16 or not, as f32 numpy."""
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _feats(c, seed, offset=0.3, shape=(24, 20)):
    """Correlated relu-like features [H, W, C], rounded to bf16."""
    rng = np.random.default_rng(seed)
    mix = rng.standard_normal((c, c)) / np.sqrt(c)
    f = np.maximum(rng.standard_normal((shape[0] * shape[1], c)) @ mix + 0.3, 0) + offset
    return _bf16(f.reshape(*shape, c).astype(np.float32))


# ------------------------------------------------------------- numerics


def test_bf16_numerics_policy():
    device.set_bf16_numerics()
    assert not torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    assert torch.backends.cudnn.deterministic and not torch.backends.cudnn.benchmark


def test_matmul_f32acc_is_the_exact_product_sum():
    """bf16 operands give an f32 result equal, bit for bit, to the f32
    product of the upcast operands; a CPU tensor never takes the
    ``out_dtype`` route, which exists on the card only."""
    rng = np.random.default_rng(0)
    a, b = _t16(rng.standard_normal((3, 5, 700))), _t16(rng.standard_normal((3, 700, 4)))
    got = reductions.matmul_f32acc(a, b)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.bmm(a.float(), b.float()))
    assert isinstance(reductions.has_out_dtype(), bool)
    s = reductions.sum0(a)
    assert s.dtype == torch.float32 and torch.equal(s, a.float().sum(-2))
    assert reductions.mean0(a).dtype == torch.float32


@pytest.mark.parametrize("offset", [0.05, 40.0], ids=["relu_scale", "mean_far_above_std"])
def test_bf16_gram_matches_reference(offset):
    """The uncentred bf16 Gram, with μ, μμᵀ and the subtraction in f32:
    ≤ 1e-4 of max|cov| against the reference and against the centred
    float64 covariance of the same bf16 values (the cancellation costs
    about eps·μ²/σ², which the second case makes large on purpose)."""
    f = _feats(48, seed=3, offset=offset).reshape(-1, 48)
    j_cov, j_mean = jwct._gram(jnp.asarray(f, jnp.bfloat16))
    t_cov, t_mean = twct._gram(_t16(f))
    assert t_cov.dtype == t_mean.dtype == torch.float32
    scale = np.abs(_f32(j_cov)).max()
    # at mean 40 the f32 cancellation of n·μμᵀ leaves about 1e-4 of the
    # O(1) covariance in both packages; they differ by less than either is off
    bound = 1e-4 if offset < 1 else 5e-4
    assert np.abs(t_cov.numpy() - _f32(j_cov)).max() <= bound * scale
    np.testing.assert_allclose(t_mean.numpy(), _f32(j_mean), rtol=2e-6)
    f64 = f.astype(np.float64)
    c64 = np.cov(f64.T)
    assert np.abs(t_cov.numpy() - c64).max() <= bound * np.abs(c64).max()


def test_bf16_gram_batched_equals_single():
    f = torch.stack([_t16(_feats(32, seed=s).reshape(-1, 32)).mT for s in range(3)])
    cov, mean = twct._gram_cn(f)
    assert cov.shape == (3, 32, 32) and mean.shape == (3, 32)
    one_cov, one_mean = twct._gram(f[1].mT)
    assert torch.allclose(cov[1], one_cov, rtol=1e-6, atol=1e-7)
    assert torch.equal(mean[1], one_mean)


@pytest.mark.parametrize("method", ["eigh", "newton_schulz_fast"])
def test_bf16_alpha0_is_identity(method):
    """I rounds to bf16 exactly and x·I sums single exact products."""
    fc, fs = _feats(64, seed=2), _feats(64, seed=5, shape=(18, 16))
    stats = twct.style_stats(_t16(fs), method=method)
    assert stats.kernel.dtype == stats.mean.dtype == torch.float32
    out = twct.wct_from_stats(_t16(fc), stats, 0.0, method=method)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, _t16(fc))


@pytest.mark.parametrize("method", ["eigh", "newton_schulz_fast"])
@pytest.mark.parametrize("c", [16, 64])
def test_bf16_wct_from_stats_matches_reference(method, c):
    """α = 0.6, within 2 bf16 ulp of the reference: |Δ| ≤ 2⁻⁶·|ref| for
    the output's own rounding, plus 2⁻⁷·max|ref| for the C×C kernel's
    rounding to bf16 (the two f32 kernels differ by about 1e-5, which
    moves an entry across a bf16 rounding point now and then, and that
    entry multiplies a whole feature channel). The median stays far
    below one ulp."""
    fc, fs = _feats(c, seed=c), _feats(c, seed=c + 1, shape=(18, 16))
    j_stats = jwct.style_stats(jnp.asarray(fs, jnp.bfloat16), method=method)
    t_stats = twct.style_stats(_t16(fs), method=method)
    scale = np.abs(_f32(j_stats.kernel)).max()
    assert np.abs(t_stats.kernel.numpy() - _f32(j_stats.kernel)).max() <= 1e-4 * scale
    ref = _f32(jwct.wct_from_stats(jnp.asarray(fc, jnp.bfloat16), j_stats, 0.6, method=method))
    got = twct.wct_from_stats(_t16(fc), t_stats, 0.6, method=method).float().numpy()
    d = np.abs(got.astype(np.float64) - ref)
    assert (d <= 2.0**-6 * np.abs(ref) + 2.0**-7 * np.abs(ref).max()).all(), d.max()
    assert np.median(d) <= 2.0**-9 * np.abs(ref).max()


def _spd(b, c, seed, cond=100.0):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((b, c, c)))
    eigs = np.geomspace(1.0, 1.0 / cond, c)
    return ((q * eigs) @ q.transpose(0, 2, 1)).astype(np.float32)


@pytest.mark.parametrize("c", [64, 512])
def test_newton_schulz_fast_matches_reference(c):
    """On the CPU both packages run the iteration in f32: ≤ 1e-5
    relative Frobenius. And the bar the product has to clear on any
    device: ‖sqrt·sqrt − A‖_F ≤ 5e-5·‖A‖_F on a cond-100 SPD matrix."""
    a = _spd(1, c, seed=c)
    import jax

    ref_sq, ref_isq = jsqrtm.newton_schulz_sqrtm(
        jnp.asarray(a[0]), precision=jax.lax.Precision.HIGH)
    sq, isq = sqrtm.newton_schulz_sqrtm(torch.from_numpy(a), precision="high")
    for got, ref in ((sq[0], ref_sq), (isq[0], ref_isq)):
        ref = np.asarray(ref, np.float64)
        assert np.linalg.norm(got.numpy() - ref) <= 1e-5 * np.linalg.norm(ref)
    sq64 = sq[0].double().numpy()
    a_reg = a[0].astype(np.float64) + sqrtm.DEFAULT_REG * np.trace(a[0]) / c * np.eye(c)
    assert np.linalg.norm(sq64 @ sq64 - a_reg) <= 5e-5 * np.linalg.norm(a_reg)


def test_newton_schulz_precision_values():
    a = torch.from_numpy(_spd(2, 32, seed=1))
    hi = sqrtm.newton_schulz_sqrtm(a, precision="highest")
    fast = sqrtm.newton_schulz_sqrtm(a, precision="high")
    # both are the f32 product (ops/sqrtm.py::_PRECISIONS says why)
    assert all(torch.equal(x, y) for x, y in zip(hi, fast))
    with pytest.raises(ValueError, match="precision"):
        sqrtm.newton_schulz_sqrtm(a, precision="default")


# -------------------------------------------------------------- cascade


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(9)
    content = rng.random((SIZE, SIZE, 3)).astype(np.float32)
    style = rng.random((SIZE, SIZE, 3)).astype(np.float32)
    return (jck.load_pytree(BUNDLE), tck.params_from_numpy(tck.load_pytree(BUNDLE), "cpu"),
            content, style)


@pytest.fixture(scope="module")
def reference_levels(setup):
    """The reference's bf16 cascade run level by level: for each level
    its input image and its output, so that the port can be fed the
    reference's own input (teacher forcing, DESIGN.md §2b)."""
    jparams, _, content, style = setup
    x, runs = content, {}
    for level in tcascade.DEFAULT_TARGETS:
        cfg = jcascade.CascadeConfig(relu_targets=(level,), **THROUGHPUT)
        out = jcascade.stylize_pair(jparams, jnp.asarray(x), jnp.asarray(style), 0.6, cfg)
        assert out.dtype == jnp.bfloat16
        runs[level] = (x, _f32(out))
        x = runs[level][1]
    return runs


@pytest.mark.parametrize("level", tcascade.DEFAULT_TARGETS)
def test_bf16_level_matches_reference_teacher_forced(setup, reference_levels, level):
    """Port-bf16 against reference-bf16 on the trained bundle, α = 0.6:
    q99 |Δ| ≤ 2e-2 and median ≤ 4e-3 (one bf16 ulp of a pixel in
    [0.5, 1) is 3.9e-3; the activations pass up to 26 bf16 roundings
    whose order of summation differs between the frameworks)."""
    _, tparams, _, style = setup
    x, ref = reference_levels[level]
    cfg = tcascade.CascadeConfig(relu_targets=(level,), **THROUGHPUT)
    got = tcascade.stylize_pair(tparams, x, style, 0.6, cfg)
    assert got.dtype == torch.float32 and got.shape == (SIZE, SIZE, 3)
    got = got.numpy()
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    d = np.abs(got.astype(np.float64) - ref)
    assert np.quantile(d, 0.99) <= 2e-2, np.quantile(d, 0.99)
    assert np.median(d) <= 4e-3, np.median(d)


def _run(tparams, content, style, alpha, **kw):
    cfg = tcascade.CascadeConfig(**kw)
    cache = tcascade.precompute_style(tparams["encoder"], style, cfg)
    for lvl in cfg.relu_targets:
        assert cache[lvl].stats.kernel.dtype == torch.float32
    return tcascade.stylize(tparams, content[None], cache, alpha, cfg)[0].numpy().astype(np.float64)


@pytest.mark.parametrize("level", tcascade.DEFAULT_TARGETS)
def test_throughput_single_level_within_fidelity_gate(setup, level):
    """The reference's gate (tests/test_trained_fidelity.py:180-199):
    throughput against f32 + eigh, one level, α = 0.8, q99 < 0.05."""
    _, tparams, content, style = setup
    fid = _run(tparams, content, style, 0.8, relu_targets=(level,))
    fast = _run(tparams, content, style, 0.8, relu_targets=(level,), **THROUGHPUT)
    assert np.quantile(np.abs(fast - fid), 0.99) < 0.05


def test_throughput_cascade_within_fidelity_gate(setup):
    """The reference's composed gate (:248-249): five levels, α = 0.8,
    median < 0.2 and fewer than 90 % of the pixels off by more than 0.05."""
    _, tparams, content, style = setup
    fid = _run(tparams, content, style, 0.8)
    fast = _run(tparams, content, style, 0.8, **THROUGHPUT)
    dev = np.abs(fast - fid)
    assert np.median(dev) < 0.2, np.median(dev)
    assert (dev > 0.05).mean() < 0.9


def test_bf16_microbatched_output_independent_of_batch(setup):
    _, tparams, content, style = setup
    cfg = tcascade.CascadeConfig(**THROUGHPUT)
    rng = np.random.default_rng(1)
    batch = np.stack([content[:64, :64]] + [rng.random((64, 64, 3), np.float32) for _ in range(3)])
    cache = tcascade.precompute_style(tparams["encoder"], style, cfg)
    full = tcascade.stylize_microbatched(tparams, batch, cache, 0.6, cfg, microbatch=3)
    assert full.shape == (4, 64, 64, 3) and full.dtype == torch.float32
    for i in (0, 3):
        alone = tcascade.stylize_microbatched(tparams, batch[i : i + 1], cache, 0.6, cfg, 3)
        assert torch.equal(alone[0], full[i]), i
    a0 = tcascade.stylize_microbatched(tparams, batch, cache, 0.0, cfg, 3)
    assert float((a0 - full).abs().mean()) > 1e-3


def test_conv_precision_high_is_full_f32(setup):
    """``'high'`` runs the same convs as ``'highest'``: the same bits."""
    _, tparams, content, style = setup
    kw = dict(relu_targets=("relu2_1", "relu1_1"), method="newton_schulz")
    a = _run(tparams, content[:64, :64], style, 0.6, **kw)
    b = _run(tparams, content[:64, :64], style, 0.6, conv_precision="high", **kw)
    assert np.array_equal(a, b)
    assert jcascade.CascadeConfig(conv_precision="high").conv_precision == "high"


# ------------------------------------------------------------------ CLI


def _args(*extra):
    return tstylize.parse_args(["--content-path", "c", "--style-path", "s", "--out-path", "o", *extra])


@pytest.mark.parametrize(
    "flags,expect",
    [
        ((), ("float32", "eigh", False)),
        (("--preset", "fidelity"), ("float32", "eigh", False)),
        (("--preset", "balanced"), ("float32", "auto", False)),
        (("--preset", "throughput"), ("bfloat16", "newton_schulz_fast", True)),
        # The reference's precedence: the preset overwrites --dtype and
        # --method; an explicit --no-compose-conv0 still wins.
        (("--preset", "throughput", "--dtype", "float32"), ("bfloat16", "newton_schulz_fast", True)),
        (("--preset", "throughput", "--method", "eigh", "--no-compose-conv0"),
         ("bfloat16", "newton_schulz_fast", False)),
        (("--dtype", "bfloat16", "--compose-conv0", "--conv-precision", "high"),
         ("bfloat16", "eigh", True)),
    ],
    ids=["default", "fidelity", "balanced", "throughput", "explicit_dtype_wins",
         "explicit_method_and_compose_win", "flags_alone"],
)
def test_cli_presets(flags, expect):
    cfg = tcommon.config_from_args(_args(*flags))
    assert (cfg.compute_dtype, cfg.method, cfg.compose_conv0) == expect
    assert not cfg.pack2_junction
    if "--conv-precision" in flags:
        assert cfg.conv_precision == "high"


def test_cli_preset_table_is_the_references_without_pack2():
    from wct_tpu.cli import common as jcommon

    for name, (dtype, method, _fold, _pack2, compose0) in jcommon._PRESETS.items():
        assert tcommon.PRESETS[name] == (dtype, method, compose0)


def test_cli_throughput_preset_on_cpu(tmp_path):
    rng = np.random.default_rng(0)
    images.save_img(tmp_path / "c.png", rng.random((64, 72, 3)))
    images.save_img(tmp_path / "s.png", rng.random((64, 64, 3)))
    tstylize.main([
        "--weights", str(BUNDLE), "--device", "cpu", "--preset", "throughput",
        "--content-path", str(tmp_path / "c.png"), "--style-path", str(tmp_path / "s.png"),
        "--out-path", str(tmp_path / "out"), "--alpha", "0.6",
    ])
    outs = images.get_files(tmp_path / "out")
    assert [Path(p).name for p in outs] == ["c_s.png"]
    img = images.get_img(outs[0])
    assert img.shape == (64, 72, 3) and np.isfinite(img).all() and img.std() > 0.01
