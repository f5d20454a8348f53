"""The port's layerwise ridge init against ``wct_tpu/train/layerwise.py``.

On the trained bundle's encoder, at 32 px. Bounds: the port's traced
activations within 1e-4 of the reference's largest value (the trained
encoder amplifies f32 rounding: measured 1.5e-5 at conv3_3); every
regression's ``G`` and ``b`` within 1e-5 relative Frobenius (two f32
accumulations in other orders); solved weights, given the same
statistics, within 1e-6 relative (both solve in float64 on the host;
the rest is the f32 storage of the result).
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wct_tpu.train import data as jdata
from wct_tpu.train import layerwise as jlw
from wct_tpu_torch.models import decoder, vgg
from wct_tpu_torch.ops import convs
from wct_tpu_torch.train import checkpoint as tck
from wct_tpu_torch.train import layerwise as tlw

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


@pytest.fixture(scope="module")
def stats(bundle, enc, batch):
    """One pass of both packages over the same batch (subsample 4)."""
    ref = jlw.accumulate_stats(jlw.init_stats(jlw.regression_specs()),
                               jax.tree.map(jnp.asarray, bundle["encoder"]),
                               jnp.asarray(batch), subsample=4)
    ours = tlw.accumulate_stats(tlw.init_stats(tlw.regression_specs(), "cpu"), enc,
                                torch.from_numpy(batch), subsample=4)
    return jax.device_get(ref), ours


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_specs_equal_the_reference():
    assert tlw.regression_specs() == jlw.regression_specs()
    assert len(tlw.regression_specs()) == 13


def test_patch_matrix_reproduces_reflect_conv():
    """P @ w.reshape(-1, out) + b == the port's conv: pins the (kh, kw, in)
    order against the HWIO kernel layout and its OIHW transpose."""
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((2, 6, 7, 5)), dtype=torch.float32)
    w = rng.standard_normal((3, 3, 5, 4)).astype(np.float32)
    b = torch.tensor(rng.standard_normal(4), dtype=torch.float32)
    P = tlw._patches(x, 3)
    assert tuple(P.shape) == (2 * 6 * 7, 3 * 3 * 5 + 1)
    assert torch.equal(P[:, -1], torch.ones(P.shape[0]))
    np.testing.assert_array_equal(
        P.numpy(), np.asarray(jax.jit(jlw._patches, static_argnums=1)(jnp.asarray(x.numpy()), 3)))
    got = (P[:, :-1] @ torch.from_numpy(w.reshape(-1, 4)) + b).reshape(2, 6, 7, 4)
    want = convs.conv2d_reflect(x, torch.from_numpy(w.transpose(3, 2, 0, 1).copy()), b)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_encoder_trace_matches_reference(bundle, enc, batch):
    ref = jax.jit(jlw.encoder_trace)(jax.tree.map(jnp.asarray, bundle["encoder"]),
                                     jnp.asarray(batch))
    ours = tlw.encoder_trace(enc, torch.from_numpy(batch))
    assert sorted(ours) == sorted(ref)
    for k, v in ref.items():
        v = np.asarray(v)
        assert tuple(ours[k].shape) == v.shape, k
        assert np.abs(ours[k].numpy() - v).max() <= 1e-4 * np.abs(v).max(), k
    torch.testing.assert_close(ours["conv3_1"], vgg.encode(enc, torch.from_numpy(batch),
                                                           "relu3_1"), rtol=0, atol=0)


def test_stats_match_reference(stats):
    ref, ours = stats
    assert sorted(ours) == sorted(ref)
    for k in ref:
        for part in ("G", "b"):
            assert tuple(ours[k][part].shape) == ref[k][part].shape
            assert _rel(ours[k][part].numpy(), ref[k][part]) <= 1e-5, (k, part)


@pytest.mark.parametrize("dec", ["dec_conv1_1", "dec_conv2_1"])
def test_solve_matches_reference_on_the_same_stats(stats, dec):
    """A solve lands in the port's OIHW layout as the reference's HWIO."""
    ref, _ = stats
    gb = {k: np.array(v) for k, v in ref[dec].items()}
    [spec] = [s for s in jlw.regression_specs() if s["dec"] == dec]
    want = jax.device_get(jlw.solve_refit({dec: gb}, "relu2_1"))[dec]
    got = tlw.solve_refit({dec: {k: torch.from_numpy(v) for k, v in gb.items()}}, "relu2_1",
                          device="cpu")[dec]
    assert tuple(got["w"].shape) == (spec["y_c"], spec["x_c"], 3, 3)
    got = tck.params_to_numpy(got)
    for part in ("w", "b"):
        assert _rel(got[part], want[part]) <= 1e-6, part


def test_uint8_batches_accumulate_like_float(enc):
    img = (np.random.default_rng(3).random((2, 32, 32, 3)) * 255).astype(np.uint8)
    s_u8 = tlw.accumulate_stats(tlw.init_stats(tlw.regression_specs(), "cpu"), enc,
                                torch.from_numpy(img))
    s_f32 = tlw.accumulate_stats(tlw.init_stats(tlw.regression_specs(), "cpu"), enc,
                                 torch.from_numpy(img.astype(np.float32) / 255.0))
    for k in s_u8:
        assert torch.equal(s_u8[k]["G"], s_f32[k]["G"]), k


def test_refit_stats_match_reference_and_only_matches_full_pass(bundle, enc):
    rng = np.random.default_rng(7)
    x = rng.random((2, 32, 32, 3)).astype(np.float32)
    dec_np = bundle["decoders"]["relu2_1"]
    ref = jax.device_get(jlw.accumulate_refit_stats(
        jlw.init_refit_stats("relu2_1"), jax.tree.map(jnp.asarray, bundle["encoder"]),
        jax.tree.map(jnp.asarray, dec_np), jnp.asarray(x), target="relu2_1"))
    dec = tck.params_from_numpy(dec_np, "cpu")
    full = tlw.accumulate_refit_stats(tlw.init_refit_stats("relu2_1", device="cpu"), enc, dec,
                                      torch.from_numpy(x), target="relu2_1")
    assert sorted(full) == sorted(ref)
    for name in full:
        assert _rel(full[name]["G"].numpy(), ref[name]["G"]) <= 1e-5, name
        solo = tlw.accumulate_refit_stats(tlw.init_refit_stats("relu2_1", only=name,
                                                               device="cpu"),
                                          enc, dec, torch.from_numpy(x), target="relu2_1",
                                          only=name)
        assert set(solo) == {name}
        for part in ("G", "b"):
            assert torch.equal(solo[name][part], full[name][part]), (name, part)
    # The normal matrices are ill-conditioned: a 1e-5 change of G moves a
    # solve by 1e-2, so the solves are compared on the same statistics.
    solved = tck.params_to_numpy(tlw.solve_refit(
        {n: {k: torch.from_numpy(np.array(v)) for k, v in gb.items()} for n, gb in ref.items()},
        "relu2_1", device="cpu"))
    want = jax.device_get(jlw.solve_refit(ref, "relu2_1"))
    for name in want:
        for part in ("w", "b"):
            assert _rel(solved[name][part], want[name][part]) <= 1e-6, (name, part)


def test_solved_decoders_are_assembled_per_level(stats, monkeypatch):
    """Every level's tree has the decoder's convs in OIHW, each a copy of
    its regression's solve (the solves themselves are stubbed: the 4609²
    ones cost seconds, and the layout is what is checked here)."""
    _, ours = stats
    monkeypatch.setattr(tlw, "solve_ridge", lambda G, b, lam: np.arange(
        G.shape[0] * b.shape[1], dtype=np.float64).reshape(G.shape[0], b.shape[1]))
    decoders = tlw.solved_decoder_params(ours, verbose=False, device="cpu")
    assert sorted(decoders) == sorted(vgg.RELU_TARGETS)
    for t, tree in decoders.items():
        he = decoder.init_decoder_params(torch.Generator().manual_seed(0), t)
        assert {k: tuple(v["w"].shape) for k, v in tree.items()} == {
            k: tuple(v["w"].shape) for k, v in he.items()}
    [spec] = [s for s in tlw.regression_specs() if s["dec"] == "dec_conv2_1"]
    w = np.arange(spec["d"] * spec["y_c"], dtype=np.float64).reshape(spec["d"], spec["y_c"])
    hwio = w[:-1].reshape(3, 3, spec["x_c"], spec["y_c"]).astype(np.float32)
    for t in ("relu2_1", "relu5_1"):
        got = tck.params_to_numpy(decoders[t]["dec_conv2_1"])
        np.testing.assert_array_equal(got["w"], hwio)
        np.testing.assert_array_equal(got["b"], w[-1].astype(np.float32))
    assert decoders["relu2_1"]["dec_conv2_1"]["w"] is not decoders["relu5_1"]["dec_conv2_1"]["w"]


def test_solved_relu1_decoder_beats_he_init(enc):
    """The ridge relu1_1 decoder lands far above an untrained decoder on
    held-out images (``tests/test_layerwise.py:90`` holds > 20 dB)."""
    rng = np.random.default_rng(1)
    [spec] = [s for s in tlw.regression_specs() if s["dec"] == "dec_conv1_1"]
    stats = {"dec_conv1_1": tlw._zeros(spec, torch.device("cpu"))}
    for _ in range(4):
        acts = tlw.encoder_trace(enc, torch.from_numpy(
            np.stack([tdata_image(rng) for _ in range(4)])))
        tlw._accumulate(stats["dec_conv1_1"], tlw._patches(acts["conv1_1"], 3),
                        acts["input"].reshape(-1, 3))
    solved = tlw.solve_refit(stats, "relu1_1", device="cpu")
    held = torch.from_numpy(np.stack([tdata_image(np.random.default_rng(99)) for _ in range(2)]))
    code = vgg.encode(enc, held, "relu1_1")

    def psnr(params):
        out = decoder.decode(params, code, "relu1_1").clamp(0, 1)
        return float(10 * torch.log10(1.0 / (out - held).pow(2).mean()))

    assert psnr(solved) > 20.0, psnr(solved)
    assert psnr(solved) > psnr(decoder.init_decoder_params(torch.Generator().manual_seed(0),
                                                           "relu1_1")) + 10.0


def tdata_image(rng):
    from wct_tpu_torch.train.data import synthetic_image

    return synthetic_image(rng, 32)
