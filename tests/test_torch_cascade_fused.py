"""The port's ``fuse_junction`` cascade against ``wct_tpu``'s, trained bundle.

``CascadeConfig(method="newton_schulz_pallas", fuse_junction=True)``,
five levels, 128 px (a multiple of 16, so the fused route is taken):
the JAX cascade runs its Pallas kernels in interpret mode, the port the
plain versions its CUDA kernels are held against. The JAX fused and
unfused cascades themselves differ at α=0.6 by q99 1.4e-4, max 5.0e-4
on these weights (conv0 folded, other summation orders, amplified
≈100× by five levels of whitening), so no bound here can be tighter
than that; the bounds are those of tests/test_torch_cascade.py.
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
KW = dict(method="newton_schulz_pallas", fuse_junction=True)


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


@pytest.fixture
def routed(monkeypatch):
    """Counts the calls the cascade makes into the junction module."""
    calls = {"encoder_head": 0, "junction": 0, "decoder_tail": 0}
    for name in calls:
        fn = getattr(tjunction, f"{name}_nchw")

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            if _name == "junction":
                assert kw["deep"] is True  # the 2→1 boundary stays unfused
            return _fn(*a, **kw)

        monkeypatch.setattr(tjunction, f"{name}_nchw", counted)
    return calls


def _quantiles(a, b):
    d = np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))
    return np.quantile(d, 0.99), d.max()


def _both(setup, alpha, content=None, **kw):
    jparams, tparams, c, style = setup
    c = c if content is None else content
    ref = np.asarray(jcascade.stylize_pair(
        jparams, jnp.asarray(c), jnp.asarray(style), alpha, jcascade.CascadeConfig(**KW, **kw)))
    got = tcascade.stylize_pair(tparams, c, style, alpha, tcascade.CascadeConfig(**KW, **kw)).numpy()
    assert got.shape == ref.shape == c.shape
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    return got, ref


def test_fused_cascade_alpha0(setup, routed):
    """Five round trips, no whitening. Measured q99 3.6e-7, max 1.1e-6."""
    got, ref = _both(setup, 0.0)
    q99, dmax = _quantiles(got, ref)
    assert q99 <= 1e-5, q99
    assert dmax <= 5e-5, dmax
    assert routed == {"encoder_head": 1, "junction": 3, "decoder_tail": 1}


def test_fused_cascade_alpha06(setup, routed):
    """Measured q99 1.8e-4, max 5.1e-4."""
    got, ref = _both(setup, 0.6)
    q99, dmax = _quantiles(got, ref)
    assert q99 <= 5e-3, q99
    assert dmax <= 3e-2, dmax
    assert routed == {"encoder_head": 1, "junction": 3, "decoder_tail": 1}


def test_fused_against_unfused_port(setup):
    """The two routes of the port. Measured q99 1.7e-4, max 6.0e-4 at
    α=0.6 (the reference's own two routes: 1.4e-4, 5.0e-4)."""
    _, tparams, content, style = setup
    fused = tcascade.stylize_pair(tparams, content, style, 0.6, tcascade.CascadeConfig(**KW))
    plain = tcascade.stylize_pair(
        tparams, content, style, 0.6, tcascade.CascadeConfig(method=KW["method"]))
    q99, dmax = _quantiles(fused.numpy(), plain.numpy())
    assert 0 < q99 <= 5e-3, q99
    assert dmax <= 3e-2, dmax


def test_ineligible_shape_takes_unfused_path(setup, routed):
    """24 × 40 through two levels needs no padding (multiples of 2) and
    fails the gate (not multiples of 16): both packages go unfused, and
    the port calls nothing of the junction module."""
    jparams, tparams, content, style = setup
    c = content[:24, :40]
    targets = ("relu2_1", "relu1_1")
    got, ref = _both(setup, 0.6, content=c, relu_targets=targets)
    assert routed == {"encoder_head": 0, "junction": 0, "decoder_tail": 0}
    unfused = tcascade.stylize_pair(
        tparams, c, style, 0.6,
        tcascade.CascadeConfig(method=KW["method"], relu_targets=targets)).numpy()
    np.testing.assert_array_equal(got, unfused)
    assert np.abs(got - ref).max() <= 1e-3


@pytest.mark.parametrize(
    "targets,expect",
    [(("relu3_1", "relu2_1", "relu1_1"), {"encoder_head": 1, "junction": 1, "decoder_tail": 1}),
     (("relu2_1", "relu1_1"), {"encoder_head": 1, "junction": 0, "decoder_tail": 1}),
     (("relu1_1",), {"encoder_head": 0, "junction": 0, "decoder_tail": 1}),
     (("relu4_1", "relu2_1"), {"encoder_head": 1, "junction": 1, "decoder_tail": 0})],
    ids=["3-2-1", "2-1", "1", "4-2"],
)
def test_routing_and_parity_on_shorter_cascades(setup, routed, targets, expect):
    """64 px, clip between levels on: each level boundary takes the route
    the reference takes. Bound as tests/test_torch_cascade.py's options."""
    _, _, content, _ = setup
    got, ref = _both(setup, 0.7, content=content[:64, :64], relu_targets=targets,
                     clip_between_levels=True)
    assert routed == expect
    assert np.quantile(np.abs(got - ref), 0.99) <= 1e-4


def test_fused_microbatched_output_independent_of_batch(setup):
    _, tparams, content, style = setup
    cfg = tcascade.CascadeConfig(**KW)
    rng = np.random.default_rng(1)
    batch = np.stack([content[:64, :64]] + [rng.random((64, 64, 3), np.float32) for _ in range(3)])
    cache = tcascade.precompute_style(tparams["encoder"], style, cfg)
    full = tcascade.stylize_microbatched(tparams, batch, cache, 0.6, cfg, microbatch=3)
    alone = tcascade.stylize_microbatched(tparams, batch[3:4], cache, 0.6, cfg, 3)
    assert torch.equal(alone[0], full[3])
