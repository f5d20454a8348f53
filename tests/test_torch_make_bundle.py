"""``tools/make_bundle`` and the CLIs' ``--checkpoints`` / ``--vgg-path``
in the port, against ``wct_tpu``'s.

Mirrors ``tests/test_tools.py::TestMakeBundle`` (:130) and
``tests/test_cli.py::test_stylize_cli_per_level_checkpoints`` (:361) on
npz files the tests write: the same bundles, the same messages, the same
``SystemExit``s, and the same output bytes as ``--weights`` on the bundle
that ``make_bundle`` builds back from the files.
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from wct_tpu.cli import common as jcommon
from wct_tpu.models import decoder as jdec
from wct_tpu.models import vgg as jvgg
from wct_tpu.tools import make_bundle as jmake
from wct_tpu.train import checkpoint as jck
from wct_tpu_torch.cli import common as tcommon
from wct_tpu_torch.cli import stream as tstream
from wct_tpu_torch.cli import stylize as tstylize
from wct_tpu_torch.models import decoder as tdec
from wct_tpu_torch.models import vgg as tvgg
from wct_tpu_torch.tools import make_bundle as tmake
from wct_tpu_torch.train import checkpoint as tck
from wct_tpu_torch.utils import images

BUNDLE = Path(__file__).resolve().parent.parent / "weights" / "bundle.npz"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite runs in
    parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture()
def files(tmp_path):
    """An encoder npz and relu1_1 / relu2_1 decoders, written by the
    reference's checkpoint module (relu2_1 in the train-state form)."""
    enc = jvgg.init_encoder_params(jax.random.PRNGKey(0))
    jck.save_pytree(tmp_path / "enc.npz", {"encoder": enc})
    d1 = jdec.init_decoder_params(jax.random.PRNGKey(1), "relu1_1")
    d2 = jdec.init_decoder_params(jax.random.PRNGKey(2), "relu2_1")
    jck.save_pytree(tmp_path / "d1.npz", d1)
    jck.save_pytree(tmp_path / "d2.npz", {"params": d2})
    return tmp_path


def _argv(d, out, *extra):
    return ["--encoder", str(d / "enc.npz"), "--decoder", f"relu1_1={d / 'd1.npz'}",
            "--decoder", f"relu2_1={d / 'd2.npz'}", *extra, str(out)]


@pytest.mark.parametrize("target", jvgg.RELU_TARGETS)
def test_decoder_layers_are_the_references(target):
    """``validate_decoder`` reads ``(kind, name, in_c, out_c, k)`` from the
    port's ``decoder_layers``: the reference's specs, entry for entry."""
    assert tdec.decoder_layers(target) == jdec.decoder_layers(target)
    assert tvgg.layers_to(target) == jvgg.layers_to(target)


def test_end_to_end(files):
    out = files / "bundle.npz"
    tmake.main(_argv(files, out))
    bundle = tck.load_pytree(out)
    assert set(bundle["decoders"]) == {"relu1_1", "relu2_1"}
    assert "conv1_1" in bundle["encoder"]


def test_float16_storage_roundtrip(files):
    """--store-dtype float16 halves the artifact; load upcasts to f32."""
    out32, out16 = files / "b32.npz", files / "b16.npz"
    tmake.main(_argv(files, out32))
    tmake.main(_argv(files, out16, "--store-dtype", "float16"))
    assert out16.stat().st_size < 0.6 * out32.stat().st_size
    b32, b16 = tck.load_pytree(out32), tck.load_pytree(out16)
    w32, w16 = b32["encoder"]["conv1_1"]["w"], b16["encoder"]["conv1_1"]["w"]
    assert w16.dtype == np.float32  # upcast on load
    np.testing.assert_allclose(w16, w32, rtol=1e-3, atol=1e-4)
    raw = tck.load_pytree(out16, upcast_f16=False)
    assert all(v.dtype == np.float16 for v in tck._flatten(raw).values())
    assert np.array_equal(w16, w32.astype(np.float16).astype(np.float32))


def test_wrong_level_fails(files):
    with pytest.raises(ValueError, match="missing conv"):
        tmake.main(["--encoder", str(files / "enc.npz"), "--decoder", f"relu3_1={files / 'd1.npz'}",
                    str(files / "b.npz")])


def _message(fn, *args):
    with pytest.raises(ValueError) as e:
        fn(*args)
    return str(e.value)


def test_validate_decoder_messages_are_the_references():
    """A missing conv, and a weight in the port's OIHW instead of the
    file's HWIO: the same ``ValueError`` text from both packages."""
    d2 = {k: {n: np.asarray(a) for n, a in v.items()}
          for k, v in jdec.init_decoder_params(jax.random.PRNGKey(2), "relu2_1").items()}
    missing = {k: v for k, v in d2.items() if k != "dec_conv2_1"}
    assert _message(tmake.validate_decoder, missing, "relu2_1") == \
        _message(jmake.validate_decoder, missing, "relu2_1")
    oihw = dict(d2, dec_conv1_2={"w": d2["dec_conv1_2"]["w"].transpose(3, 2, 0, 1),
                                 "b": d2["dec_conv1_2"]["b"]})
    msg = _message(tmake.validate_decoder, oihw, "relu2_1")
    assert msg == _message(jmake.validate_decoder, oihw, "relu2_1")
    assert "dec_conv1_2" in msg
    tmake.validate_decoder(d2, "relu2_1")  # the file's own layout passes


def test_bundles_load_in_the_other_package(files):
    """A bundle built by either package's ``make_bundle`` loads in the
    other with equal leaves, and both packages build the same leaves."""
    jout, tout = files / "j.npz", files / "t.npz"
    jmake.main(_argv(files, jout))
    tmake.main(_argv(files, tout))
    j_in_t, t_in_j = tck._flatten(tck.load_pytree(jout)), tck._flatten(jck.load_pytree(tout))
    t_in_t = tck._flatten(tck.load_pytree(tout))
    assert j_in_t.keys() == t_in_j.keys() == t_in_t.keys()
    for k in j_in_t:
        assert np.array_equal(j_in_t[k], t_in_j[k]) and np.array_equal(j_in_t[k], t_in_t[k]), k
    params = tck.params_from_numpy(tck.load_pytree(jout), "cpu")
    assert tuple(params["decoders"]["relu2_1"]["dec_conv2_1"]["w"].shape) == (64, 128, 3, 3)


@pytest.fixture()
def per_level(tmp_path):
    """The trained bundle split into an encoder file and one decoder file
    per level (relu2_1 in the train-state form), and the bundle that the
    port's ``make_bundle`` builds back from them."""
    tree = tck.load_pytree(BUNDLE)
    enc = tmp_path / "vgg.npz"
    tck.save_pytree(enc, {"encoder": tree["encoder"]})
    ckpts = []
    for t in ("relu2_1", "relu1_1"):
        p = tmp_path / f"decoder_{t}.npz"
        tck.save_pytree(p, {"params": tree["decoders"][t]} if t == "relu2_1" else tree["decoders"][t])
        ckpts.append(str(p))
    rebuilt = tmp_path / "rebuilt.npz"
    tmake.main(["--encoder", str(enc), *[f"--decoder={t}={p}" for t, p in
                                         zip(("relu2_1", "relu1_1"), ckpts)], str(rebuilt)])
    return enc, ckpts, rebuilt


def _stylize(tmp_path, out, *flags):
    rng = np.random.default_rng(0)
    c_dir = tmp_path / "content"
    if not c_dir.exists():
        c_dir.mkdir()
        images.save_img(c_dir / "c.png", rng.random((32, 40, 3)))
    tstylize.main(["--relu-targets", "relu2_1", "relu1_1", "--content-path", str(c_dir),
                   "--style-path", str(c_dir), "--out-path", str(tmp_path / out), "--device", "cpu",
                   *flags])
    return [Path(p).read_bytes() for p in images.get_files(tmp_path / out)]


def test_stylize_cli_per_level_checkpoints(tmp_path, per_level):
    """The reference's per-level loading on the trained weights: the same
    PNG bytes as ``--weights`` on the rebuilt bundle, which holds the
    trained bundle's leaves."""
    enc, ckpts, rebuilt = per_level
    got = _stylize(tmp_path, "ckpt", "--vgg-path", str(enc), "--checkpoints", *ckpts)
    want = _stylize(tmp_path, "bundle", "--weights", str(rebuilt))
    assert len(got) == 1 and got == want
    trained, back = tck._flatten(tck.load_pytree(BUNDLE)), tck._flatten(tck.load_pytree(rebuilt))
    assert back.keys() == {k for k in trained if k.startswith("encoder/")
                           or k.split("/")[1] in ("relu2_1", "relu1_1")}
    assert all(np.array_equal(back[k], trained[k]) for k in back)


def test_stream_cli_per_level_checkpoints(tmp_path, per_level):
    cv2 = pytest.importorskip("cv2")
    enc, ckpts, rebuilt = per_level
    rng = np.random.default_rng(1)
    src = str(tmp_path / "in.mp4")
    w = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 10, (48, 32))
    for _ in range(3):
        w.write((rng.random((32, 48, 3)) * 255).astype(np.uint8))
    w.release()
    images.save_img(tmp_path / "s.png", rng.random((32, 32, 3)))

    def frames(name, *flags):
        out = str(tmp_path / name)
        tstream.main(["--video", src, "--out", out, "--style-path", str(tmp_path / "s.png"),
                      "--style-size", "32", "--width", "48", "--height", "32",
                      "--relu-targets", "relu2_1", "relu1_1", "--no-display", "--batch-size", "2",
                      "--device", "cpu", *flags])
        cap, got = cv2.VideoCapture(out), []
        while True:
            ok, f = cap.read()
            if not ok:
                return got
            got.append(f)

    got = frames("ckpt.mp4", "--vgg-path", str(enc), "--checkpoints", *ckpts)
    want = frames("bundle.mp4", "--weights", str(rebuilt))
    assert len(got) == len(want) == 3
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def _load(common, argv):
    import argparse

    p = argparse.ArgumentParser()
    common.add_model_flags(p)
    return common.load_params(p.parse_args(argv))


def test_each_refusal_is_the_references(per_level, tmp_path):
    """The four ``SystemExit``s of the reference's ``load_params``, with its
    messages: with ``--weights``, a count that is not the targets', no
    ``--vgg-path``, and a decoder of the wrong level."""
    enc, ckpts, _ = per_level
    targets = ["--relu-targets", "relu2_1", "relu1_1"]
    cases = [
        [*targets, "--vgg-path", str(enc), "--checkpoints", *ckpts, "--weights", str(BUNDLE)],
        [*targets, "--vgg-path", str(enc), "--checkpoints", ckpts[0]],
        [*targets, "--checkpoints", *ckpts],
        [*targets, "--vgg-path", str(enc), "--checkpoints", *ckpts[::-1]],
    ]
    for argv in cases:
        with pytest.raises(SystemExit) as ref:
            _load(jcommon, argv)
        with pytest.raises(SystemExit) as got:
            _load(tcommon, [*argv, "--device", "cpu"])
        assert str(got.value) == str(ref.value) and str(got.value)


def test_checkpoints_load_to_the_bundles_tensors(per_level):
    enc, ckpts, rebuilt = per_level
    argv = ["--relu-targets", "relu2_1", "relu1_1", "--device", "cpu"]
    a = _load(tcommon, [*argv, "--vgg-path", str(enc), "--checkpoints", *ckpts])
    b = _load(tcommon, [*argv, "--weights", str(rebuilt)])
    la, lb = tck._flatten(a), tck._flatten(b)
    assert la.keys() == lb.keys() and all(np.array_equal(la[k], lb[k]) for k in la)
    assert tuple(a["decoders"]["relu2_1"]["dec_conv2_1"]["w"].shape) == (64, 128, 3, 3)
