"""The port's reconstruction loss and its gradients against ``wct_tpu``'s.

Parity runs on the trained ``weights/bundle.npz`` (random weights amplify
float differences chaotically, DESIGN.md §2), at crop 32 on procedural
images. Bounds:

- f32: loss within 1e-4 relative, every gradient leaf within 1e-3
  relative Frobenius (measured: loss ≤ 2e-5, leaves ≤ 2.7e-4, the
  largest on bias leaves, whose pixel sums cancel);
- bf16: loss within 2e-2 relative, all gradients together within 5e-2
  relative (the two packages round bf16 convs at other points: the port
  rounds each conv's f32 sum once and adds the bf16 bias, as cuDNN and
  ``ops/convs.py`` do).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wct_tpu.train import data as jdata
from wct_tpu.train import trainer as jt
from wct_tpu.train import checkpoint as jck
from wct_tpu_torch.models import decoder, vgg
from wct_tpu_torch.train import checkpoint as tck
from wct_tpu_torch.train import trainer as tt

BUNDLE = Path(__file__).resolve().parent.parent / "weights" / "bundle.npz"


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
def bundle():
    return tck.load_pytree(BUNDLE)


@pytest.fixture(scope="module")
def enc(bundle):
    return tck.params_from_numpy(bundle["encoder"], "cpu")


@pytest.fixture(scope="module")
def batch():
    return np.stack([jdata.synthetic_image(np.random.default_rng(i), 32) for i in range(2)])


def _cfgs(**kw):
    kw = dict(batch_size=2, crop_size=32, **kw)
    return jt.TrainConfig(**kw), tt.TrainConfig(**kw)


def _port_grads(bundle, enc, batch, cfg):
    dec = tck.params_from_numpy(bundle["decoders"][cfg.relu_target], "cpu")
    for p in tck.tree_leaves(dec):
        p.requires_grad_(True)
    loss, metrics = tt.reconstruction_loss(dec, enc, torch.from_numpy(batch), cfg)
    loss.backward()
    grads = tck.params_to_numpy(tck._map_tree(lambda p: p.grad, dec))
    return float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()}, grads


_JAX_GRAD = jax.jit(jax.value_and_grad(jt.reconstruction_loss, has_aux=True),
                    static_argnames=("cfg",))


def _jax_grads(bundle, batch, cfg):
    (loss, metrics), grads = _JAX_GRAD(
        bundle["decoders"][cfg.relu_target], bundle["encoder"], jnp.asarray(batch), cfg=cfg
    )
    return float(loss), {k: float(v) for k, v in metrics.items()}, jck._flatten(
        jax.device_get(grads))


@pytest.mark.parametrize("target", ["relu1_1", "relu2_1", "relu3_1"])
def test_loss_and_gradients_match_reference_f32(bundle, enc, batch, target):
    cfg_j, cfg_t = _cfgs(relu_target=target)
    lj, mj, gj = _jax_grads(bundle, batch, cfg_j)
    lt, mt, gt = _port_grads(bundle, enc, batch, cfg_t)
    assert set(mt) == set(mj) == {"loss", "pixel", "feature", "tv"}
    for k in ("loss", "pixel", "feature"):
        assert abs(mt[k] - mj[k]) <= 1e-4 * abs(mj[k]), (k, mt[k], mj[k])
    gt = tck._flatten(gt)
    assert sorted(gt) == sorted(gj)
    for k, ref in gj.items():
        ref = ref.astype(np.float64)
        err = np.linalg.norm(gt[k] - ref) / np.linalg.norm(ref)
        assert err <= 1e-3, (k, err)


def test_loss_and_gradients_match_reference_bf16(bundle, enc, batch):
    cfg_j, cfg_t = _cfgs(relu_target="relu2_1", compute_dtype="bfloat16")
    lj, _, gj = _jax_grads(bundle, batch, cfg_j)
    lt, _, gt = _port_grads(bundle, enc, batch, cfg_t)
    assert abs(lt - lj) <= 2e-2 * lj
    gt = tck._flatten(gt)
    ref = np.concatenate([gj[k].ravel() for k in sorted(gj)]).astype(np.float64)
    got = np.concatenate([gt[k].ravel() for k in sorted(gj)])
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 5e-2


def test_params_stay_f32_and_step_lowers_the_loss_in_bf16(enc, batch):
    cfg = tt.TrainConfig(relu_target="relu1_1", batch_size=2, crop_size=32,
                         compute_dtype="bfloat16", learning_rate=1e-3)
    state = tt.init_train_state(torch.Generator().manual_seed(3), cfg, "cpu")
    x = torch.from_numpy(batch)
    _, m0 = tt.train_step(state, enc, x, cfg)
    for _ in range(14):
        state, m = tt.train_step(state, enc, x, cfg)
    assert all(p.dtype == torch.float32 for p in tck.tree_leaves(state.params))
    assert state.step == 15
    assert np.isfinite(float(m["loss"])) and float(m["loss"]) < float(m0["loss"])


def test_uint8_batches_match_float(bundle, enc):
    """uint8 is cast and divided by 255 in the compute dtype on the device."""
    pool = jdata.synthetic_pool(np.random.default_rng(5), 2, 32)
    cfg = tt.TrainConfig(relu_target="relu2_1", batch_size=2, crop_size=32)
    dec = tck.params_from_numpy(bundle["decoders"]["relu2_1"], "cpu")
    l_u8, _ = tt.reconstruction_loss(dec, enc, torch.from_numpy(pool), cfg)
    l_f32, _ = tt.reconstruction_loss(
        dec, enc, torch.from_numpy(pool.astype(np.float32) / 255.0), cfg)
    assert float(l_u8) == float(l_f32)


def test_tv_term_and_feature_weight_zero(bundle, enc, batch):
    dec = tck.params_from_numpy(bundle["decoders"]["relu1_1"], "cpu")
    x = torch.from_numpy(batch)
    cfg_tv = tt.TrainConfig(relu_target="relu1_1", tv_weight=10.0)
    _, m = tt.reconstruction_loss(dec, enc, x, cfg_tv)
    decoded = decoder.decode(dec, vgg.encode(enc, x, "relu1_1"), "relu1_1")
    assert float(m["tv"]) > 0
    assert float(m["tv"]) == pytest.approx(float(tt.total_variation(decoded)), rel=1e-6)
    cfg_px = tt.TrainConfig(relu_target="relu1_1", feature_weight=0.0)
    loss, m = tt.reconstruction_loss(dec, enc, x, cfg_px)
    assert float(m["feature"]) == 0.0 and float(loss) == float(m["pixel"])


def test_feature_norm_divides_by_target_power(bundle, enc, batch):
    dec = tck.params_from_numpy(bundle["decoders"]["relu2_1"], "cpu")
    x = torch.from_numpy(batch)
    cfg = tt.TrainConfig(relu_target="relu2_1")
    _, raw = tt.reconstruction_loss(dec, enc, x, cfg)
    _, norm = tt.reconstruction_loss(dec, enc, x, tt.TrainConfig(relu_target="relu2_1",
                                                                  feature_norm=True))
    power = float(vgg.encode(enc, x, "relu2_1").pow(2).mean())
    assert float(norm["feature"]) == pytest.approx(float(raw["feature"]) / (power + 1e-8),
                                                   rel=1e-5)


def test_remat_gives_the_same_gradient_bits(bundle, enc, batch):
    grads = []
    for remat in (False, True):
        cfg = tt.TrainConfig(relu_target="relu2_1", remat=remat)
        _, _, g = _port_grads(bundle, enc, batch, cfg)
        grads.append(tck._flatten(g))
    for k in grads[0]:
        np.testing.assert_array_equal(grads[0][k], grads[1][k], err_msg=k)


def test_eval_step_metrics_without_gradients(bundle, enc, batch):
    dec = tck.params_from_numpy(bundle["decoders"]["relu1_1"], "cpu")
    for p in tck.tree_leaves(dec):
        p.requires_grad_(True)
    m = tt.eval_step(dec, enc, torch.from_numpy(batch), tt.TrainConfig(relu_target="relu1_1"))
    assert set(m) == {"loss", "pixel", "feature", "tv"}
    assert not m["loss"].requires_grad


def test_sharded_train_step_names_its_roadmap_item():
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 10"):
        tt.make_sharded_train_step(None, tt.TrainConfig())


def test_training_on_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tt.init_train_state(torch.Generator().manual_seed(0), tt.TrainConfig())
