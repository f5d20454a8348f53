"""The port's stylize CLI with the flags of this slice, on the CPU.

Mirrors tests/test_cli.py (synthetic PNGs; interpolation with
``--keep-colors``, wrong ``--interp-weights``) and adds ``--adain``,
``--swap5``, ``--coral`` and ``--concat``; the flags' configurations are
held to the reference CLI's.
"""

import argparse
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from wct_tpu.cli import common as jcommon
from wct_tpu.cli import stylize as jstylize
from wct_tpu_torch.cli import common as tcommon
from wct_tpu_torch.cli import stylize as tstylize
from wct_tpu_torch.utils import colors, images

ROOT = Path(__file__).resolve().parent.parent
BUNDLE = ROOT / "weights" / "bundle.npz"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite runs in
    parallel workers, and torch's OpenMP threads spinning on a loaded
    machine made a 30-step test take 150 s instead of 1."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def tiny_imgs(tmp_path):
    rng = np.random.default_rng(0)
    c_dir, s_dir = tmp_path / "content", tmp_path / "style"
    c_dir.mkdir()
    s_dir.mkdir()
    images.save_img(c_dir / "c1.png", rng.random((40, 48, 3)))
    images.save_img(s_dir / "s1.png", rng.random((32, 32, 3)))
    images.save_img(s_dir / "s2.png", rng.random((36, 30, 3)))
    return c_dir, s_dir, tmp_path / "out"


def _main(c_dir, s_dir, o_dir, *flags):
    tstylize.main(["--device", "cpu", "--content-path", str(c_dir), "--style-path", str(s_dir),
                   "--out-path", str(o_dir), *flags])
    return images.get_files(o_dir)


def test_interp_and_keep_colors(tiny_imgs):
    c_dir, s_dir, o_dir = tiny_imgs
    outs = _main(c_dir, s_dir, o_dir, "--relu-targets", "relu1_1", "--content-size", "32",
                 "--interp-weights", "0.3", "0.7", "--keep-colors")
    assert len(outs) == 1 and "interp" in outs[0]  # one output per content
    assert images.get_img(outs[0]).shape == (32, 38, 3)


def test_wrong_interp_weights_and_coral_with_interp_exit(tiny_imgs):
    c_dir, s_dir, o_dir = tiny_imgs
    with pytest.raises(SystemExit, match="needs 2 weights"):
        _main(c_dir, s_dir, o_dir, "--relu-targets", "relu1_1", "--interp-weights", "1.0")
    with pytest.raises(SystemExit, match="--coral cannot combine"):
        _main(c_dir, s_dir, o_dir, "--relu-targets", "relu1_1", "--interp-weights", "0.5",
              "0.5", "--coral")


def test_swap5_keep_colors_concat_on_the_bundle(tiny_imgs, tmp_path):
    """The trained bundle with style-swap at relu5_1, luminance-only, the
    style pasted beside each output; the first output is held to the
    same cascade run by hand."""
    from wct_tpu_torch.models import cascade
    from wct_tpu_torch.train import checkpoint

    c_dir, s_dir, o_dir = tiny_imgs
    flags = ["--weights", str(ROOT / "weights" / "bundle.npz"), "--swap5",
             "--method", "newton_schulz_pallas", "--content-size", "64", "--style-size", "64",
             "--alpha", "0.6"]
    outs = _main(c_dir, s_dir, o_dir, *flags, "--keep-colors", "--concat")
    assert [Path(p).name for p in outs] == ["c1_s1.png", "c1_s2.png"]
    out = images.get_img(outs[0])
    assert out.shape == (64, 77 + 64, 3)  # the 64×64 style thumbnail beside it
    params = checkpoint.params_from_numpy(checkpoint.load_pytree(ROOT / "weights" / "bundle.npz"),
                                          "cpu")
    cfg = cascade.CascadeConfig(swap5=True, method="newton_schulz_pallas")
    content = images.resize_to(images.get_img(c_dir / "c1.png"), 64)
    style = images.resize_to(images.get_img(s_dir / "s1.png"), 64)
    cache = cascade.precompute_style(params["encoder"], style, cfg)
    ref = cascade.stylize_microbatched(params, content[None], cache, 0.6, cfg, 4)[0].numpy()
    ref = colors.preserve_colors_np(content, ref)
    assert np.abs(out[:, :77] - ref).max() <= 1.5 / 255  # the PNG's 8-bit rounding
    thumb = images.resize_exact(images.get_img(s_dir / "s1.png"), 64, 64)
    assert np.abs(out[:, 77:] - thumb).max() <= 1.5 / 255


@pytest.mark.parametrize("flags", [["--adain", "--interp-weights", "0.5", "0.5"], ["--adain", "--coral"]],
                         ids=["adain_interp", "adain_coral"])
def test_adain_with_interp_or_coral(tiny_imgs, flags):
    c_dir, s_dir, o_dir = tiny_imgs
    outs = _main(c_dir, s_dir, o_dir, "--relu-targets", "relu3_1", "relu1_1",
                 "--content-size", "32", *flags)
    assert len(outs) == (1 if "--interp-weights" in flags else 2)
    img = images.get_img(outs[0])
    assert img.shape == (32, 38, 3) and np.isfinite(img).all() and img.std() > 0


def _config(common, argv):
    """A CLI's CascadeConfig for ``argv``."""
    p = argparse.ArgumentParser()
    common.add_model_flags(p)
    return common.config_from_args(p.parse_args(argv))


@pytest.mark.parametrize("argv", [
    ["--adain"], ["--swap5", "--ss-alpha", "0.3", "--ss-patch-size", "5", "--ss-stride", "2"],
    ["--soft-trunc"], ["--rel-trunc", "1e-3"], ["--wct-groups", "4", "--method", "auto"],
    ["--adain", "--swap5", "--preset", "fidelity"],
], ids=["adain", "swap5", "soft", "rel", "groups", "adain_swap5_preset"])
def test_flags_give_the_reference_config(argv):
    jcfg, tcfg = _config(jcommon, argv), _config(tcommon, argv)
    for field in ("transform", "swap5", "ss_alpha", "ss_patch_size", "ss_stride", "soft_trunc",
                  "rel_trunc", "wct_groups", "method", "compute_dtype"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field


def _dests(module, monkeypatch):
    """The option names of a stylize CLI module's parser."""
    parsers = []

    def capture(self, args=None, namespace=None):
        parsers.append(self)
        raise SystemExit

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(SystemExit):
        module.parse_args([])
    monkeypatch.undo()
    return {a.dest for a in parsers[0]._actions}


def test_flags_the_port_does_not_carry_raise(tiny_imgs, monkeypatch):
    """Every flag of the reference's stylize CLI is accepted, and none
    raises: ``--fold`` and ``--ring-conv`` set their fields and run. Each
    computes the same math and rounds otherwise, so on the trained bundle
    (random decoders amplify rounding chaotically, DESIGN.md §2) its PNGs
    are within one 8-bit level of the run without it. Illegal
    combinations give the reference's
    error. ``--data-parallel`` is carried: on the CPU (a mesh of one) it
    writes the same files as the run without it, and refuses ``--coral``
    as the reference does."""
    c_dir, s_dir, o_dir = tiny_imgs
    flags = ("--relu-targets", "relu2_1", "relu1_1", "--content-size", "32")
    dp = _main(c_dir, s_dir, o_dir, *flags, "--data-parallel")
    ref = _main(c_dir, s_dir, o_dir.with_name("ref"), *flags)
    assert [Path(p).name for p in dp] == [Path(p).name for p in ref] == ["c1_s1.png", "c1_s2.png"]
    for a, b in zip(dp, ref):
        assert Path(a).read_bytes() == Path(b).read_bytes()
    with pytest.raises(SystemExit, match="--coral processes one pair"):
        _main(c_dir, s_dir, o_dir, "--data-parallel", "--coral")
    for flag, field in (("--fold", "fold_transform"), ("--ring-conv", "ring_conv")):
        assert _config(tcommon, [flag]) == dataclasses.replace(_config(tcommon, []), **{field: True})
        outs = _main(c_dir, s_dir, o_dir.with_name(field), *flags, "--weights", str(BUNDLE), flag)
        base = _main(c_dir, s_dir, o_dir.with_name(f"{field}_off"), *flags, "--weights", str(BUNDLE))
        assert [Path(p).name for p in outs] == ["c1_s1.png", "c1_s2.png"]
        for a, b in zip(outs, base):
            d = np.abs(images.get_img(a).astype(np.float64) - images.get_img(b))
            assert d.max() <= 1 / 255 + 1e-6
    argv = ["--rel-trunc", "1e-3", "--soft-trunc"]
    with pytest.raises(ValueError) as ref:
        _config(jcommon, argv)
    with pytest.raises(ValueError) as got:
        _config(tcommon, argv)
    assert str(got.value) == str(ref.value)
    missing = _dests(jstylize, monkeypatch) - _dests(tstylize, monkeypatch)
    assert missing == set()
