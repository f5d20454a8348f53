"""The port's bucketed serving (``wct_tpu_torch.utils.serving``) against
``wct_tpu.utils.serving``.

The bucket arithmetic and the padding are the reference's exactly. The
stylized outputs are held to ``test_torch_cascade.py``'s per-level bounds
(q99 ≤ 1e-4, max ≤ 1e-3) on the trained bundle, at 30–61 px with two
levels and ``method="newton_schulz"`` (the same plain iteration in both
packages).
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from wct_tpu.models import cascade as jcascade
from wct_tpu.train import checkpoint as jck
from wct_tpu.utils import serving as jserving
from wct_tpu_torch.models import cascade as tcascade
from wct_tpu_torch.train import checkpoint as tck
from wct_tpu_torch.utils import serving

BUNDLE = Path(__file__).resolve().parent.parent / "weights" / "bundle.npz"
TARGETS = ("relu2_1", "relu1_1")
METHOD = "newton_schulz"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite runs in
    parallel workers, and torch's OpenMP threads spinning on a loaded
    machine made a 30-step test take 150 s instead of 1."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("g", [16, 32, 128])
def test_bucket_shape_is_the_reference_arithmetic(g):
    for h, w in [(1, 1), (16, 16), (17, 15), (128, 128), (500, 513), (720, 1280), (33, 129)]:
        assert serving.bucket_shape(h, w, g) == jserving.bucket_shape(h, w, g)
    assert serving.bucket_shape(500, 513) == (512, 640)


@pytest.mark.parametrize("hw,g", [((50, 70), 64), ((20, 25), 32), ((5, 40), 32), ((64, 64), 64)],
                         ids=["reflect", "reflect_small", "edge", "exact"])
def test_pad_to_bucket_equals_the_reference(hw, g):
    img = np.random.default_rng(1).random((*hw, 3)).astype(np.float32)
    got, size = serving.pad_to_bucket(img, g)
    want, want_size = jserving.pad_to_bucket(img, g)
    assert size == want_size == hw
    assert got.shape == want.shape == (*serving.bucket_shape(*hw, g), 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[: hw[0], : hw[1]], img)


@pytest.fixture(scope="module")
def engines():
    rng = np.random.default_rng(2)
    style = rng.random((48, 48, 3)).astype(np.float32)
    t = serving.BucketedStylizer(
        tck.params_from_numpy(tck.load_pytree(BUNDLE), "cpu"),
        tcascade.CascadeConfig(relu_targets=TARGETS, method=METHOD), granularity=32)
    j = jserving.BucketedStylizer(
        jck.load_pytree(BUNDLE), jcascade.CascadeConfig(relu_targets=TARGETS, method=METHOD),
        granularity=32)
    t.set_style(style)
    j.set_style(style)
    return t, j


@pytest.mark.parametrize("hw", [(30, 40), (33, 61)])
def test_outputs_match_the_reference_at_their_input_size(engines, hw):
    t, j = engines
    img = np.random.default_rng(hw[1]).random((*hw, 3)).astype(np.float32)
    got, want = t.stylize(img, 0.7), j.stylize(img, 0.7)
    assert got.shape == want.shape == (*hw, 3)
    assert got.dtype == np.float32 and np.isfinite(got).all()
    d = np.abs(got.astype(np.float64) - want)
    assert np.quantile(d, 0.99) <= 1e-4, np.quantile(d, 0.99)
    assert d.max() <= 1e-3, d.max()


def test_one_padded_shape_per_bucket(engines, monkeypatch):
    t, _ = engines
    shapes = []
    real = tcascade.stylize

    def recording(params, content, cache, alpha, cfg):
        shapes.append(tuple(content.shape))
        return real(params, content, cache, alpha, cfg)

    monkeypatch.setattr(serving.cascade, "stylize", recording)
    rng = np.random.default_rng(3)
    sizes = [(20, 25), (30, 17), (32, 32), (33, 20), (64, 50)]
    outs = [t.stylize(rng.random((*hw, 3)).astype(np.float32)) for hw in sizes]
    assert [o.shape[:2] for o in outs] == sizes
    assert shapes == [(1, 32, 32, 3)] * 3 + [(1, 64, 32, 3), (1, 64, 64, 3)]


def test_no_style_raises():
    eng = serving.BucketedStylizer(
        tcascade.init_params(0, ("relu1_1",), device="cpu"),
        tcascade.CascadeConfig(relu_targets=("relu1_1",)))
    with pytest.raises(RuntimeError, match="no style"):
        eng.stylize(np.zeros((16, 16, 3), np.float32))
