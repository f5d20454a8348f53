"""The port's cascade against ``wct_tpu``'s, on the trained bundle.

``CascadeConfig(method="newton_schulz_pallas")``: the JAX cascade runs
its Pallas Newton–Schulz kernel in interpret mode, the port its plain
Newton–Schulz (the CUDA kernel's reference). 128-px content and style
from seed 9. The bounds are ceilings set from what a 1e-6 relative
input perturbation does to the JAX cascade itself (q99 2e-6 per level,
q99 2e-4 for the five-level cascade, which amplifies ≈100×); measured
port-vs-JAX values sit beside each bound.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wct_tpu.models import cascade as jcascade
from wct_tpu.train import checkpoint as jck
from wct_tpu_torch.models import cascade as tcascade
from wct_tpu_torch.train import checkpoint as tck

BUNDLE = Path(__file__).resolve().parent.parent / "weights" / "bundle.npz"
SIZE = 128
METHOD = "newton_schulz_pallas"


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(9)
    content = rng.random((SIZE, SIZE, 3)).astype(np.float32)
    style = rng.random((SIZE, SIZE, 3)).astype(np.float32)
    return (jck.load_pytree(BUNDLE), tck.params_from_numpy(tck.load_pytree(BUNDLE), "cpu"),
            content, style)


def _diff(setup, targets, alpha):
    jparams, tparams, content, style = setup
    jcfg = jcascade.CascadeConfig(relu_targets=targets, method=METHOD)
    tcfg = tcascade.CascadeConfig(relu_targets=targets, method=METHOD)
    ref = np.asarray(jcascade.stylize_pair(
        jparams, jnp.asarray(content), jnp.asarray(style), alpha, jcfg))
    got = tcascade.stylize_pair(tparams, content, style, alpha, tcfg).numpy()
    assert got.shape == ref.shape == (SIZE, SIZE, 3)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    d = np.abs(got.astype(np.float64) - ref)
    return np.quantile(d, 0.99), d.max()


@pytest.mark.parametrize("level", ["relu5_1", "relu4_1", "relu3_1", "relu2_1", "relu1_1"])
def test_each_level_alone(setup, level):
    """α=0.6. Measured q99 3e-7–2.3e-6, max 5.4e-7–5.4e-6."""
    q99, dmax = _diff(setup, (level,), 0.6)
    assert q99 <= 1e-4, q99
    assert dmax <= 1e-3, dmax


def test_full_cascade_alpha0(setup):
    """Five encode→decode round trips. Measured q99 3.9e-7, max 1.1e-6;
    the bound is the reference's own oracle gate
    (tests/test_trained_fidelity.py)."""
    q99, dmax = _diff(setup, tcascade.DEFAULT_TARGETS, 0.0)
    assert q99 <= 1e-5, q99
    assert dmax <= 5e-5, dmax


def test_full_cascade_alpha06(setup):
    """Measured q99 2.0e-4, max 4.8e-4."""
    q99, dmax = _diff(setup, tcascade.DEFAULT_TARGETS, 0.6)
    assert q99 <= 5e-3, q99
    assert dmax <= 3e-2, dmax


def test_microbatched_output_independent_of_batch(setup):
    """An image's output is the same bits whatever batch it came in."""
    _, tparams, content, style = setup
    cfg = tcascade.CascadeConfig(method=METHOD)
    rng = np.random.default_rng(1)
    batch = np.stack([content[:64, :64]] + [rng.random((64, 64, 3), np.float32) for _ in range(4)])
    cache = tcascade.precompute_style(tparams["encoder"], style, cfg)
    full = tcascade.stylize_microbatched(tparams, batch, cache, 0.6, cfg, microbatch=3)
    assert full.shape == (5, 64, 64, 3)
    for i in (0, 3):
        alone = tcascade.stylize_microbatched(tparams, batch[i : i + 1], cache, 0.6, cfg, 3)
        assert torch.equal(alone[0], full[i]), i
    empty = tcascade.stylize_microbatched(tparams, batch[:0], cache, 0.6, cfg, 3)
    assert empty.shape == (0, 64, 64, 3)
    with pytest.raises(ValueError):
        tcascade.stylize_microbatched(tparams, batch, cache, 0.6, cfg, microbatch=0)


@pytest.mark.parametrize("hw", [(40, 56), (9, 12)])
def test_unaligned_sizes_pad_and_crop(setup, hw):
    """Reflect (or, too small to reflect, edge) pad to the pool multiple, crop back."""
    jparams, tparams, content, style = setup
    targets = ("relu3_1", "relu1_1")
    c = content[: hw[0], : hw[1]]
    ref = np.asarray(jcascade.stylize_pair(
        jparams, jnp.asarray(c), jnp.asarray(style), 0.6,
        jcascade.CascadeConfig(relu_targets=targets, method=METHOD)))
    got = tcascade.stylize_pair(
        tparams, c, style, 0.6, tcascade.CascadeConfig(relu_targets=targets, method=METHOD)
    ).numpy()
    assert got.shape == ref.shape == (*hw, 3)
    assert np.abs(got - ref).max() <= 1e-3


@pytest.mark.parametrize(
    "kw",
    [dict(passes=2, clip_between_levels=True), dict(ns_iters=(("relu4_1", 10),)),
     dict(ns_iters=12, compose_conv0=True)],
    ids=["passes2_clip", "ns_iters_pairs", "ns_iters_int_compose"],
)
def test_cascade_options(setup, kw):
    jparams, tparams, content, style = setup
    targets = ("relu4_1", "relu2_1")
    c = content[:64, :64]
    ref = np.asarray(jcascade.stylize_pair(
        jparams, jnp.asarray(c), jnp.asarray(style), 0.7,
        jcascade.CascadeConfig(relu_targets=targets, method=METHOD, **kw)))
    got = tcascade.stylize_pair(
        tparams, c, style, 0.7, tcascade.CascadeConfig(relu_targets=targets, method=METHOD, **kw)
    ).numpy()
    assert np.quantile(np.abs(got - ref), 0.99) <= 1e-4


ILLEGAL = [
    dict(relu_targets=()),
    dict(relu_targets=("relu6_1",)),
    dict(relu_targets=("relu1_1", "relu1_1")),
    dict(transform="swap"),
    dict(swap5=True, relu_targets=("relu1_1",)),
    dict(passes=0),
    dict(compute_dtype="float16"),
    dict(conv_precision="low"),
    dict(method="svd"),
    dict(wct_groups=3),
    dict(fuse_junction=True, fold_transform=True),
    dict(rel_trunc=1e-3, soft_trunc=True),
    dict(rel_trunc=2.0),
    dict(rel_trunc=1e-3, method="newton_schulz"),
    dict(ns_iters=(("relu9_1", 3),)),
    dict(ns_iters=0),
    dict(pack2_junction=True, fold_transform=True),
    dict(pack2_tail_only=True),
    dict(pack2_junction_only=True),
    dict(compose_conv0=True, fuse_junction=True),
    dict(pack2_junction=True, pack2_junction_only=True, pack2_tail_only=True),
]


@pytest.mark.parametrize("kw", ILLEGAL, ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()))
def test_config_same_value_errors_as_reference(kw):
    with pytest.raises(ValueError) as ref:
        jcascade.CascadeConfig(**kw)
    with pytest.raises(ValueError) as got:
        tcascade.CascadeConfig(**kw)
    assert str(got.value) == str(ref.value)


@pytest.mark.parametrize(
    "kw",
    [dict(fuse_junction=True), dict(pack2_junction=True), dict(fold_transform=True),
     dict(ring_conv=True), dict(transform="adain"), dict(swap5=True), dict(wct_groups=2),
     dict(soft_trunc=True), dict(rel_trunc=1e-3), dict(compute_dtype="bfloat16"),
     dict(method="newton_schulz_fast"), dict(conv_precision="high")],
    ids=lambda kw: "-".join(f"{k}={v}" for k, v in kw.items()),
)
def test_config_unported_options_raise_not_implemented(kw):
    jcascade.CascadeConfig(**kw)  # legal in the reference
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item"):
        tcascade.CascadeConfig(**kw)
