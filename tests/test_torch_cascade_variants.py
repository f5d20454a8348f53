"""The cascade's other transforms against ``wct_tpu``'s, on the trained bundle.

AdaIN, style-swap at relu5_1, grouped WCT on the fused route and
multi-style interpolation, 128-px content and style from seed 9 as in
tests/test_torch_cascade.py (the truncation modes' and grouped WCT's
levels are in tests/test_torch_wct_modes.py). Each level runs
alone on the same input (teacher-forced, DESIGN.md §2b) and is held to
that file's per-level bounds, q99 ≤ 1e-4 and max ≤ 1e-3; a composed
cascade to its five-level bounds, q99 ≤ 5e-3 and max ≤ 3e-2. The JAX
side takes ``eigh`` or ``newton_schulz``, never interpret-mode Pallas;
the port's ``newton_schulz_pallas`` is the plain iteration on the CPU.
Measured values sit beside each case.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wct_tpu.models import cascade as jcascade
from wct_tpu.train import checkpoint as jck
from wct_tpu_torch.models import cascade as tcascade
from wct_tpu_torch.ops import junction as tjunction
from wct_tpu_torch.train import checkpoint as tck

BUNDLE = Path(__file__).resolve().parent.parent / "weights" / "bundle.npz"
SIZE = 128
LEVEL_Q99, LEVEL_MAX = 1e-4, 1e-3
CASCADE_Q99, CASCADE_MAX = 5e-3, 3e-2


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
def setup():
    rng = np.random.default_rng(9)
    content = rng.random((SIZE, SIZE, 3)).astype(np.float32)
    style = rng.random((SIZE, SIZE, 3)).astype(np.float32)
    return (jck.load_pytree(BUNDLE), tck.params_from_numpy(tck.load_pytree(BUNDLE), "cpu"),
            content, style)


def _configs(targets, kw):
    """The same configuration for both packages; the port's kernel method
    stands for the reference's plain Newton–Schulz."""
    jkw = {**kw, "method": "newton_schulz"} if kw.get("method") == "newton_schulz_pallas" else kw
    return (jcascade.CascadeConfig(relu_targets=targets, **jkw),
            tcascade.CascadeConfig(relu_targets=targets, **kw))


def _run(setup, targets, kw, alpha=0.6):
    jparams, tparams, content, style = setup
    jcfg, tcfg = _configs(targets, kw)
    ref = np.asarray(jcascade.stylize_pair(
        jparams, jnp.asarray(content), jnp.asarray(style), alpha, jcfg), np.float64)
    got = tcascade.stylize_pair(tparams, content, style, alpha, tcfg).numpy()
    assert got.shape == ref.shape == (SIZE, SIZE, 3)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    return got.astype(np.float64), ref


def _diff(a, b):
    d = np.abs(a - b)
    return np.quantile(d, 0.99), d.max()


ALL = ("relu5_1", "relu4_1", "relu3_1", "relu2_1", "relu1_1")
ADAIN = dict(transform="adain")
SWAP_EIGH = dict(swap5=True)
SWAP_NS = dict(swap5=True, method="newton_schulz_pallas")
GROUPS4 = dict(wct_groups=4, method="newton_schulz_pallas")
# (configuration, level), measured port-vs-JAX q99 / max: adain
# 1.8e-7–7.2e-7 / 3.6e-7–2.1e-6; swap5 eigh 2.7e-7 / 7.7e-7, Newton–Schulz
# 7.5e-7 / 2.6e-6.
LEVEL_CASES = [(ADAIN, lv) for lv in ALL] + [(SWAP_EIGH, "relu5_1"), (SWAP_NS, "relu5_1")]


@pytest.mark.parametrize("kw,level", LEVEL_CASES, ids=lambda v: v if isinstance(v, str) else
                         "-".join(f"{k}={x}" for k, x in v.items()))
def test_level_matches_reference(setup, kw, level):
    q99, dmax = _diff(*_run(setup, (level,), kw))
    assert q99 <= LEVEL_Q99, q99
    assert dmax <= LEVEL_MAX, dmax


def test_composed_cascade_matches_reference(setup):
    """Five levels, the swap at relu5_1 and AdaIN at the other four:
    measured q99 8.9e-6, max 2.2e-5."""
    q99, dmax = _diff(*_run(setup, ALL, dict(swap5=True, transform="adain"), alpha=0.8))
    assert q99 <= CASCADE_Q99, q99
    assert dmax <= CASCADE_MAX, dmax


@pytest.mark.parametrize("kw", [dict(), ADAIN, SWAP_NS], ids=["wct", "adain", "swap5"])
def test_interpolated_styles_match_reference(setup, kw):
    """Two styles blended by [0.3, 0.7] through ``interpolate_style_caches``
    and ``stylize_interp``, at relu1_1 (the swap at relu5_1): measured q99
    ≤ 1.1e-6, max ≤ 3.5e-6."""
    jparams, tparams, content, style = setup
    style2 = np.ascontiguousarray(style[::-1, :, ::-1])
    targets = ("relu5_1",) if kw is SWAP_NS else ("relu1_1",)
    jcfg, tcfg = _configs(targets, kw)
    w = [0.3, 0.7]
    jcaches = [jcascade.precompute_style(jparams["encoder"], jnp.asarray(s), jcfg)
               for s in (style, style2)]
    tcaches = [tcascade.precompute_style(tparams["encoder"], s, tcfg) for s in (style, style2)]
    ref = np.asarray(jcascade.stylize_interp(jparams, jnp.asarray(content[None]), jcaches,
                                             jnp.asarray(w, jnp.float32), 0.7, jcfg))
    got = tcascade.stylize_interp(tparams, content[None], tcaches, w, 0.7, tcfg).numpy()
    q99, dmax = _diff(got.astype(np.float64), ref)
    assert q99 <= LEVEL_Q99 and dmax <= LEVEL_MAX, (q99, dmax)
    blended = tcascade.interpolate_style_caches(tcaches, torch.tensor(w), tcfg)
    one = tcascade.interpolate_style_caches(tcaches, [1.0, 0.0], tcfg)
    for level in targets:
        if kw is SWAP_NS:  # the first style's whitened map
            assert blended[level].fs_white is tcaches[0][level].fs_white
        if kw is ADAIN:
            assert torch.equal(one[level].adain.std, tcaches[0][level].adain.std)
        else:
            assert torch.equal(one[level].stats.kernel, tcaches[0][level].stats.kernel)


@pytest.fixture
def routed(monkeypatch):
    """Counts the calls the cascade makes into the junction module."""
    calls = {"encoder_head": 0, "junction": 0, "decoder_tail": 0}
    for name in calls:
        fn = getattr(tjunction, f"{name}_nchw")

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(tjunction, f"{name}_nchw", counted)
    return calls


@pytest.mark.parametrize("kw", [ADAIN, GROUPS4, SWAP_NS], ids=["adain", "groups4", "swap5"])
def test_fused_route_folds_the_transform(setup, routed, kw):
    """With ``fuse_junction`` the relu1_1 tail folds AdaIN's diagonal affine
    (or the grouped WCT's block-diagonal one) into its conv, and the swap
    level runs unfused before the junction. Held to the port's unfused
    cascade (itself held to the reference above and in
    tests/test_torch_wct_modes.py) within the composed bounds (measured q99
    5.1e-6 AdaIN, 1.8e-5 groups, 1.5e-4 swap5; max 2.2e-5, 6.6e-5,
    7.7e-4), and the tail level alone within the per-level bounds
    (measured q99 1.8e-7, max 3.6e-7)."""
    _, tparams, content, style = setup
    for targets, q99_max, max_max in ((ALL, CASCADE_Q99, CASCADE_MAX),
                                      (("relu1_1",), LEVEL_Q99, LEVEL_MAX)):
        if kw is SWAP_NS and targets != ALL:
            continue  # the swap needs relu5_1
        fused = tcascade.CascadeConfig(relu_targets=targets, fuse_junction=True, **kw)
        plain = tcascade.CascadeConfig(relu_targets=targets, **kw)
        got = tcascade.stylize_pair(tparams, content, style, 0.6, fused).numpy()
        ref = tcascade.stylize_pair(tparams, content, style, 0.6, plain).numpy()
        q99, dmax = _diff(got.astype(np.float64), ref.astype(np.float64))
        assert q99 <= q99_max and dmax <= max_max, (targets, q99, dmax)
    assert routed["encoder_head"] == 1 and routed["junction"] == 3
    assert routed["decoder_tail"] == (1 if kw is SWAP_NS else 2)


def test_bf16_fused_adain_holds_the_bf16_gates(setup):
    """bf16 activations, AdaIN in f32 with the result rounded once, the tail's
    weights folded in f32: against the f32 AdaIN cascade, median < 0.2 and
    each level's q99 < 0.05, the reference's bf16 gates (measured median
    1.0e-2; per level q99 4.0e-3 at relu5_1, 5.0e-3 at relu1_1)."""
    _, tparams, content, style = setup
    kw16 = dict(compute_dtype="bfloat16", method="newton_schulz_fast", fuse_junction=True,
                transform="adain")
    cfg16 = tcascade.CascadeConfig(**kw16)
    cfg32 = tcascade.CascadeConfig(transform="adain")
    out16 = tcascade.stylize_pair(tparams, content, style, 0.6, cfg16)
    out32 = tcascade.stylize_pair(tparams, content, style, 0.6, cfg32)
    assert out16.dtype == torch.float32
    assert float((out16 - out32).abs().median()) < 0.2
    for level in ("relu5_1", "relu1_1"):
        one16 = tcascade.CascadeConfig(relu_targets=(level,), **kw16)
        one32 = tcascade.CascadeConfig(relu_targets=(level,), transform="adain")
        d = (tcascade.stylize_pair(tparams, content, style, 0.6, one16)
             - tcascade.stylize_pair(tparams, content, style, 0.6, one32)).abs()
        assert float(torch.quantile(d.flatten(), 0.99)) < 0.05, level


@pytest.mark.parametrize("kw", [SWAP_NS, ADAIN, GROUPS4], ids=["swap5", "adain", "groups4"])
def test_microbatched_output_independent_of_batch(setup, kw):
    _, tparams, content, style = setup
    cfg = tcascade.CascadeConfig(relu_targets=("relu5_1", "relu2_1"), **kw)
    rng = np.random.default_rng(1)
    batch = np.stack([content[:64, :64]] + [rng.random((64, 64, 3), np.float32) for _ in range(3)])
    cache = tcascade.precompute_style(tparams["encoder"], style, cfg)
    full = tcascade.stylize_microbatched(tparams, batch, cache, 0.6, cfg, microbatch=3)
    alone = tcascade.stylize_microbatched(tparams, batch[3:], cache, 0.6, cfg, microbatch=3)
    assert torch.equal(alone[0], full[3])


def test_swap5_on_undersized_input_raises_the_reference_error(setup):
    """A 32-px content has 2×2 relu5_1 maps: the cascade raises the
    reference's error (tests/test_torch_style_swap.py holds the message to
    the reference's)."""
    _, tparams, _, style = setup
    small = np.random.default_rng(2).random((32, 32, 3)).astype(np.float32)
    _, tcfg = _configs(("relu5_1",), SWAP_EIGH)
    with pytest.raises(ValueError, match=r"style_swap needs feature maps ≥ patch_size=3; "
                                         r"got content \(2, 2\), style \(8, 8\)"):
        tcascade.stylize_pair(tparams, small, style, 0.6, tcfg)
