"""The port's offline tools against ``wct_tpu/tools``, on files the tests write.

The Torch7 reader and writer, the t7 → encoder converter, the TF
checkpoint → decoder converter (its CLI skips without TensorFlow), the
output comparator, the activation normaliser (on the port's encoder) and
the float64 oracle (to 1e-12 relative), each against the reference's
module on the same seeded inputs.
"""

import numpy as np
import pytest
import torch

from wct_tpu.models import decoder as jdec
from wct_tpu.tools import compare_outputs as jcompare
from wct_tpu.tools import convert_t7 as jconvert_t7
from wct_tpu.tools import convert_tf_ckpt as jconvert_tf
from wct_tpu.tools import normalize_encoder as jnorm
from wct_tpu.tools import oracle as joracle
from wct_tpu.tools import t7_reader as jt7
from wct_tpu.train import checkpoint as jck
from wct_tpu_torch.models import vgg as tvgg
from wct_tpu_torch.tools import compare_outputs, convert_t7, convert_tf_ckpt, normalize_encoder
from wct_tpu_torch.tools import oracle, t7_reader
from wct_tpu_torch.train import checkpoint as tck
from wct_tpu_torch.utils import images


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite runs in
    parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def bundle():
    from pathlib import Path

    return jck.load_pytree(Path(__file__).resolve().parent.parent / "weights" / "bundle.npz")


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else np.asarray(v) for k, v in tree.items()}


# ------------------------------------------------------------------ t7


def test_t7_roundtrip_primitives_tensors_and_objects(tmp_path, rng):
    w32 = rng.standard_normal((4, 3, 3, 3)).astype(np.float32)
    mod = t7_reader.TorchObject("nn.SpatialConvolution", {"weight": w32, "bias": np.zeros(4)})
    obj = {"num": 3.5, "flag": True, "name": "hello", "list": [1.0, 2.0, "x"], "none": None,
           "seq": t7_reader.TorchObject("nn.Sequential", {"modules": [mod]})}
    path = tmp_path / "obj.t7"
    t7_reader.write_t7(str(path), obj)
    back = t7_reader.load_t7(str(path))
    assert (back["num"], back["flag"], back["name"], back["list"], back["none"]) == (
        3.5, True, "hello", [1.0, 2.0, "x"], None)
    assert back["seq"]["modules"][0].torch_typename == "nn.SpatialConvolution"
    np.testing.assert_array_equal(back["seq"]["modules"][0]["weight"], w32)


def test_t7_files_cross_between_packages(tmp_path, rng):
    """A file the reference writes reads here, and the other way round,
    byte for byte the same file."""
    arr = rng.standard_normal((5, 2)).astype(np.float64)
    ref_obj = jt7.TorchObject("nn.Linear", {"weight": arr, "tag": "x"})
    jt7.write_t7(str(tmp_path / "a.t7"), ref_obj)
    t7_reader.write_t7(str(tmp_path / "b.t7"),
                       t7_reader.TorchObject("nn.Linear", {"weight": arr, "tag": "x"}))
    assert (tmp_path / "a.t7").read_bytes() == (tmp_path / "b.t7").read_bytes()
    np.testing.assert_array_equal(t7_reader.load_t7(str(tmp_path / "a.t7"))["weight"], arr)


def _fake_vgg_t7(rng, reader):
    """A synthetic ``nn.Sequential`` in the normalised-VGG layout."""
    modules = []
    for spec in tvgg.ENCODER_LAYERS:
        if spec[0] == "pool":
            modules.append(reader.TorchObject("nn.SpatialMaxPooling", {}))
            continue
        _, _, in_c, out_c, k = spec
        if k > 1:
            modules.append(reader.TorchObject("nn.SpatialReflectionPadding", {}))
        modules.append(reader.TorchObject("nn.SpatialConvolution", {
            "weight": rng.standard_normal((out_c, in_c, k, k)).astype(np.float32),
            "bias": rng.standard_normal(out_c).astype(np.float32)}))
        modules.append(reader.TorchObject("nn.ReLU", {}))
    return reader.TorchObject("nn.Sequential", {"modules": modules})


def test_convert_t7_matches_reference(tmp_path, rng):
    """One file, read by each package's reader into its own converter."""
    path = str(tmp_path / "vgg.t7")
    t7_reader.write_t7(path, _fake_vgg_t7(rng, t7_reader))
    got = convert_t7.t7_to_encoder_params(t7_reader.load_t7(path))
    ref = jconvert_t7.t7_to_encoder_params(jt7.load_t7(path))
    assert set(got) == set(ref) == {s[1] for s in tvgg.ENCODER_LAYERS if s[0] != "pool"}
    for name in ref:
        for k in ("w", "b"):
            np.testing.assert_array_equal(got[name][k], ref[name][k])
    assert got["conv1_1"]["w"].shape == (3, 3, 3, 64)


def test_convert_t7_cli_writes_an_encoder_the_port_runs(tmp_path, rng):
    path = tmp_path / "vgg.t7"
    t7_reader.write_t7(str(path), _fake_vgg_t7(rng, t7_reader))
    out = tmp_path / "encoder.npz"
    convert_t7.main([str(path), str(out)])
    enc = tck.params_from_numpy(tck.load_pytree(out)["encoder"], "cpu")
    f = tvgg.encode(enc, torch.from_numpy(rng.random((1, 32, 32, 3), np.float32)), "relu3_1")
    assert f.shape == (1, 8, 8, 256) and bool(torch.isfinite(f).all())


def test_convert_t7_truncated_fails_loudly(rng):
    t7 = _fake_vgg_t7(rng, t7_reader)
    t7.attrs["modules"] = t7.attrs["modules"][:5]
    with pytest.raises(ValueError, match="convolutions"):
        convert_t7.t7_to_encoder_params(t7)


# ------------------------------------------------------------- TF ckpt


def _tf_vars(rng, target):
    out = {}
    for i, spec in enumerate(s for s in jdec.decoder_layers(target) if s[0] == "conv"):
        _, _, in_c, out_c, k = spec
        out[f"decoder/conv{i}/kernel"] = rng.standard_normal((k, k, in_c, out_c)).astype(np.float32)
        out[f"decoder/conv{i}/bias"] = rng.standard_normal(out_c).astype(np.float32)
    return out


@pytest.mark.parametrize("target", ["relu1_1", "relu3_1"])
def test_tf_vars_map_as_the_reference_maps_them(rng, target):
    variables = _tf_vars(rng, target)
    got = convert_tf_ckpt.tf_vars_to_decoder_params(variables, target)
    ref = jconvert_tf.tf_vars_to_decoder_params(variables, target)
    assert set(got) == set(ref)
    for name in ref:
        for k in ("w", "b"):
            np.testing.assert_array_equal(got[name][k], ref[name][k])
    variables.pop(sorted(variables)[0])
    with pytest.raises(ValueError, match="kernels"):
        convert_tf_ckpt.tf_vars_to_decoder_params(variables, target)


def test_convert_tf_ckpt_cli_on_a_checkpoint_tensorflow_writes(tmp_path, rng):
    tf = pytest.importorskip("tensorflow")
    target = "relu2_1"
    variables = _tf_vars(rng, target)
    ckpt = tf.train.Checkpoint(**{n.replace("/", "_"): tf.Variable(v, name=n)
                                  for n, v in variables.items()})
    prefix = ckpt.write(str(tmp_path / "tf" / "ckpt"))
    out = tmp_path / "dec.npz"
    convert_tf_ckpt.main([prefix, str(out), "--relu-target", target])
    got = tck.load_pytree(out)
    ref = jconvert_tf.tf_vars_to_decoder_params(jconvert_tf.load_tf_checkpoint(prefix), target)
    assert set(got) == set(ref)
    for name in ref:
        for k in ("w", "b"):
            np.testing.assert_array_equal(got[name][k], ref[name][k])
    assert tck.params_from_numpy(got, "cpu")["dec_conv2_1"]["w"].shape == (64, 128, 3, 3)


# ------------------------------------------------------ compare_outputs


def test_compare_pair_matches_reference(rng):
    a = rng.random((8, 8, 3)).astype(np.float32)
    b = np.clip(a + 0.01, 0, 1)
    assert compare_outputs.compare_pair(a, b) == jcompare.compare_pair(a, b)
    assert compare_outputs.compare_pair(a, a)["psnr"] == float("inf")
    assert "shape_mismatch" in compare_outputs.compare_pair(a, a[:4])


def test_compare_outputs_cli_exit_codes(tmp_path, rng):
    ours, ref = tmp_path / "ours", tmp_path / "ref"
    ours.mkdir()
    ref.mkdir()
    img = rng.random((16, 16, 3)).astype(np.float32)
    for d in (ours, ref):
        images.save_img(d / "a.png", img)
    assert compare_outputs.main([str(ours), str(ref)]) == 0
    images.save_img(ours / "b.png", img)
    images.save_img(ref / "b.png", 1.0 - img)
    assert compare_outputs.main([str(ours), str(ref)]) == 1
    assert compare_outputs.main([str(ours), str(ref), "--tol", "1.0"]) == 0
    assert compare_outputs.main([str(ours), str(tmp_path)]) == 2


# ------------------------------------------------------ normalize_encoder


def _pool(n=5, size=32):
    return np.random.default_rng(7).random((n, size, size, 3)).astype(np.float32)


def test_channel_means_match_reference(bundle):
    """The port's encoder against the reference's on a 5-image pool in
    chunks of 2: every conv's channel means within 1e-5 of the largest
    (measured ≤ 3e-7)."""
    pool = _pool()
    ref = jnorm.channel_means(bundle["encoder"], pool, chunk=2)
    got = normalize_encoder.channel_means(tck.params_from_numpy(bundle["encoder"], "cpu"), pool, 2)
    assert set(got) == set(ref)
    for name in ref:
        assert np.abs(got[name] - ref[name]).max() <= 1e-5 * np.abs(ref[name]).max(), name


SHALLOW = ("conv1_1", "conv1_2", "conv2_1", "conv2_2", "conv3_1")


def _close_per_channel(got: dict, ref: dict, tol: float, names=None) -> None:
    """Each conv's weights and bias within ``tol`` of the reference's, per
    output channel, relative to the channel's largest weight."""
    for name in names or [n for n in ref if n != "conv0"]:
        w, r = got[name]["w"], ref[name]["w"]
        size = r.abs().amax(dim=(1, 2, 3))
        err = (w - r).abs().amax(dim=(1, 2, 3)) / size
        assert float(err.max()) <= tol, (name, float(err.max()))
        assert bool(((got[name]["b"] - ref[name]["b"]).abs() <= tol * size + 1e-7).all()), name


def test_normalize_encoder_matches_reference_and_normalises(bundle):
    """Against the reference's normalised weights, per output channel:
    through conv3_1 within 1e-4 (measured ≤ 5.3e-5); deeper within 5e-2
    (measured ≤ 1.9e-2). The deeper layers hold channels whose mean
    activation over this 5-image pool is near the 1e-4 floor: conv4_3's
    channel 5 takes a scale of 2948 from a few non-zero activations, and
    the two packages' convs, rounding those differently, move it by 1.9 %,
    which the next layers inherit. The dead-channel counts are the
    reference's. Evaluated again, each package's result has every live
    channel's mean activation at 1 within 0.1 and the median channel's
    within 1e-3: rerunning the scaled weights rounds otherwise than the
    scaled activations the normalisation used, and the near-dead channels
    amplify it (measured, port and reference alike: median ≤ 1.4e-4,
    max 3.9e-2 and 7.6e-2 in conv4)."""
    pool = _pool()
    enc = tck.params_from_numpy(bundle["encoder"], "cpu")
    got, report = normalize_encoder.normalize_encoder(enc, pool, chunk=2)
    ref, jreport = jnorm.normalize_encoder(bundle["encoder"], pool, chunk=2)
    assert report.keys() == jreport.keys()
    for name, r in jreport.items():
        assert report[name]["dead_channels"] == r["dead_channels"], name
    ref = tck.params_from_numpy(_numpy_tree(ref), "cpu")
    _close_per_channel(got, ref, 1e-4, SHALLOW)
    _close_per_channel(got, ref, 5e-2)
    for params in (got, ref):
        for name, m in normalize_encoder.channel_means(params, pool, chunk=2).items():
            if name != "conv0":
                dev = np.abs(m[m > 1e-3] - 1.0)
                assert dev.max() <= 0.1 and np.median(dev) <= 1e-3, name


def test_compensated_normalisation_preserves_the_function(bundle):
    """``decode(encode(x))`` of the compensated bundle equals the original's
    to 1e-4 of its range at relu3_1 and relu1_1, for both statistics, and
    its encoder matches the reference's compensated one per channel
    through conv3_1 within 1e-3 (measured 5.0e-4: each weight carries
    its own channel's scale and the one before it)."""
    from wct_tpu_torch.models import decoder as tdec

    pool = _pool()
    params = tck.params_from_numpy(bundle, "cpu")
    x = torch.from_numpy(pool[:2])
    for stat in ("mean", "rms"):
        normed, _ = normalize_encoder.normalize_bundle_compensated(params, pool, chunk=2, stat=stat)
        ref, _ = jnorm.normalize_bundle_compensated(bundle, pool, chunk=2, stat=stat)
        _close_per_channel(normed["encoder"],
                           tck.params_from_numpy(_numpy_tree(ref["encoder"]), "cpu"), 1e-3, SHALLOW)
        for level in ("relu3_1", "relu1_1"):
            def roundtrip(p):
                return tdec.decode(p["decoders"][level], tvgg.encode(p["encoder"], x, level), level)
            a, b = roundtrip(params), roundtrip(normed)
            assert float((a - b).abs().max()) <= 1e-4 * float(a.abs().max()), (stat, level)


def test_normalize_encoder_cli_on_the_cpu(tmp_path, bundle):
    src = tmp_path / "enc.npz"
    jck.save_pytree(src, {"encoder": bundle["encoder"]})
    out = tmp_path / "norm.npz"
    assert normalize_encoder.main([str(src), str(out), "--synthetic-pool", "3", "--size", "32",
                                   "--device", "cpu"]) == 0
    tree = tck.load_pytree(out)
    assert tree["encoder"]["conv1_1"]["w"].shape == (3, 3, 3, 64)
    np.testing.assert_array_equal(tree["encoder"]["conv0"]["w"], bundle["encoder"]["conv0"]["w"])


# ------------------------------------------------------------------ oracle


def _rel64(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == np.float64 and got.shape == ref.shape
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-300))


def test_oracle_matches_reference_in_float64(bundle):
    """Every function of the oracle on the trained bundle, 32 px, the
    same float64 arithmetic: 1e-12 relative (measured 0)."""
    rng = np.random.default_rng(8)
    img, style = rng.random((32, 32, 3)), rng.random((32, 32, 3))
    enc = bundle["encoder"]
    for t in ("relu1_1", "relu3_1"):
        fc, fs = oracle.encode_np(enc, img, t), oracle.encode_np(enc, style, t)
        assert _rel64(fc, joracle.encode_np(enc, img, t)) <= 1e-12
        assert _rel64(oracle.decode_np(bundle["decoders"][t], fc, t),
                      joracle.decode_np(bundle["decoders"][t], fc, t)) <= 1e-12
        assert _rel64(oracle.wct_np(fc, fs, 0.6), joracle.wct_np(fc, fs, 0.6)) <= 1e-12
        assert oracle.wct_ranks_np(fc, fs) == joracle.wct_ranks_np(fc, fs)
        assert _rel64(oracle.adain_np(fc, fs, 0.6), joracle.adain_np(fc, fs, 0.6)) <= 1e-12
    f5c, f5s = oracle.encode_np(enc, img, "relu3_1"), oracle.encode_np(enc, style, "relu3_1")
    assert _rel64(oracle.wct_style_swap_np(f5c, f5s, 0.6),
                  joracle.wct_style_swap_np(f5c, f5s, 0.6)) <= 1e-12
    targets = ("relu2_1", "relu1_1")
    got = oracle.cascade_np(bundle, img, style, 0.6, targets)
    assert _rel64(got, joracle.cascade_np(bundle, img, style, 0.6, targets)) <= 1e-12
    assert got.min() >= 0.0 and got.max() <= 1.0


def test_oracle_takes_the_ports_parameters_through_params_to_numpy(bundle):
    """The port's OIHW tensors, back in the file layout, give the oracle
    the same numbers."""
    params = tck.params_from_numpy(bundle, "cpu")
    img = np.random.default_rng(9).random((16, 16, 3))
    got = oracle.encode_np(tck.params_to_numpy(params)["encoder"], img, "relu2_1")
    assert _rel64(got, oracle.encode_np(bundle["encoder"], img, "relu2_1")) == 0.0
