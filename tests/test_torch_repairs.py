"""The port's three repairs against the reference's behaviour, on the CPU.

- The conv choices (cuDNN or PyTorch's own conv, per shape) persist in
  one keyed JSON file, so every process on a card takes the same ones
  (``ops/convs.py``). A fake timer stands in for the card.
- ``--preset`` precedence: the port's ``config_from_args`` gives the
  reference's ``(compute_dtype, method, compose_conv0)`` for the same
  command lines, of both CLIs.
- Interpolation weights are filled in on the device
  (``utils/device.values_on``) with the bits ``torch.as_tensor`` gave.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wct_tpu.cli import common as jcommon
from wct_tpu.cli import stream as jstream_cli
from wct_tpu.cli import stylize as jstylize_cli
from wct_tpu_torch.cli import common as tcommon
from wct_tpu_torch.cli import stream as tstream_cli
from wct_tpu_torch.cli import stylize as tstylize_cli
from wct_tpu_torch.models import cascade as tcascade
from wct_tpu_torch.ops import adain as adain_ops
from wct_tpu_torch.ops import convs
from wct_tpu_torch.ops import wct as twct
from wct_tpu_torch.utils.device import values_on


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for these small CPU tensors: the suite runs in
    parallel workers."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------- the conv choices

CARD = "NVIDIA H100 80GB HBM3 | torch 2.11.0+cu128 | cudnn 91002"


class FakeTimer:
    """``cuda_ms`` without a card: the cuDNN and own-conv times given,
    read off the cuDNN flag in force; counts its calls."""

    def __init__(self, cudnn_ms: float, native_ms: float):
        self.times, self.calls = (cudnn_ms, native_ms), 0

    def __call__(self, fn, iters=5, warmup=2):
        self.calls += 1
        return self.times[0] if torch.backends.cudnn.enabled else self.times[1]


@pytest.fixture
def choices(tmp_path, monkeypatch):
    """A fresh process's view: empty tables, the choice file under
    ``tmp_path``, a fake card, no device to drain."""
    path = tmp_path / "build" / "conv_choices.json"
    monkeypatch.setattr(convs, "CHOICES_PATH", path)
    monkeypatch.setattr(convs, "_CUDNN_OK", {})
    monkeypatch.setattr(convs, "CONV_TIMES", {})
    monkeypatch.setattr(convs, "_card_key", lambda device: CARD)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    return path


def _conv_call(key_shape=(2, 4, 10, 10)):
    x = torch.ones(key_shape)
    w = torch.ones(3, key_shape[1], 3, 3)
    key = (tuple(x.shape), tuple(w.shape), x.dtype, torch.device("cpu"))
    return key, lambda: F.conv2d(x, w)


def test_choice_is_written_under_the_card_key(choices, monkeypatch):
    timer = FakeTimer(cudnn_ms=10.0, native_ms=1.0)  # cuDNN over 2× slower: own conv
    monkeypatch.setattr(convs, "cuda_ms", timer)
    key, conv = _conv_call()
    out = convs.conv_by_shape(key, conv)
    assert out.shape == (2, 3, 8, 8) and timer.calls == 2
    data = json.loads(choices.read_text())
    assert data == {CARD: {"inference": {"[2, 4, 10, 10] [3, 4, 3, 3] float32": False}}}
    assert sorted(p.name for p in choices.parent.iterdir()) == [
        "conv_choices.json", "conv_choices.json.lock"]  # the temporary file was replaced


def test_next_process_reads_the_choice_and_times_nothing(choices, monkeypatch):
    monkeypatch.setattr(convs, "cuda_ms", FakeTimer(cudnn_ms=10.0, native_ms=1.0))
    key, conv = _conv_call()
    convs.conv_by_shape(key, conv)
    # A later process: empty tables, a timer that would now choose cuDNN.
    monkeypatch.setattr(convs, "_CUDNN_OK", {})
    later = FakeTimer(cudnn_ms=1.0, native_ms=1.0)
    monkeypatch.setattr(convs, "cuda_ms", later)
    seen = []
    monkeypatch.setattr(convs, "_cudnn", _recording_cudnn(seen))
    convs.conv_by_shape(key, conv)
    assert later.calls == 0 and seen == [False] and convs._CUDNN_OK[key] is False


def _recording_cudnn(seen):
    real = convs._cudnn

    def rec(enabled):
        seen.append(enabled)
        return real(enabled)

    return rec


def test_writes_go_through_os_replace(choices, monkeypatch):
    monkeypatch.setattr(convs, "cuda_ms", FakeTimer(1.0, 1.0))
    calls = []
    real = convs.os.replace

    def replace(src, dst):
        calls.append((str(src), str(dst)))
        assert json.loads(open(src).read())  # the whole file is written before it is moved
        real(src, dst)

    monkeypatch.setattr(convs.os, "replace", replace)
    key, conv = _conv_call()
    convs.conv_by_shape(key, conv)
    assert len(calls) == 1 and calls[0][1] == str(choices) and calls[0][0].endswith(".tmp")


def test_foreign_card_key_is_not_read(choices, monkeypatch):
    key, conv = _conv_call()
    choices.parent.mkdir(parents=True)
    other = CARD.replace("cudnn 91002", "cudnn 90100")
    choices.write_text(json.dumps({other: {"inference": {convs._shape_key(key): True}}}))
    timer = FakeTimer(cudnn_ms=10.0, native_ms=1.0)
    monkeypatch.setattr(convs, "cuda_ms", timer)
    convs.conv_by_shape(key, conv)
    assert timer.calls == 2 and convs._CUDNN_OK[key] is False
    data = json.loads(choices.read_text())
    assert data[other]["inference"][convs._shape_key(key)] is True  # kept, not ours
    assert data[CARD]["inference"][convs._shape_key(key)] is False


@pytest.mark.parametrize("text", ["{not json", "[1, 2]"], ids=["unparsable", "not_an_object"])
def test_corrupt_file_raises(choices, monkeypatch, text):
    choices.parent.mkdir(parents=True)
    choices.write_text(text)
    monkeypatch.setattr(convs, "cuda_ms", FakeTimer(1.0, 1.0))
    key, conv = _conv_call()
    with pytest.raises(RuntimeError, match="conv-choice file"):
        convs.conv_by_shape(key, conv)
    assert choices.read_text() == text  # not discarded


def test_another_process_choice_wins_a_race(choices, monkeypatch):
    """A shape that another process wrote while this one timed it takes
    the file's choice."""
    key, conv = _conv_call()

    def decide():
        choices.parent.mkdir(parents=True, exist_ok=True)
        choices.write_text(json.dumps({CARD: {"inference": {convs._shape_key(key): True}}}))
        return False

    assert convs._choice(convs._CUDNN_OK, "inference", key, decide) is True
    assert convs._CUDNN_OK[key] is True


def test_training_rows_round_trip(choices):
    """A training row (times and both choices) comes back from the file
    as it was written, for the forward-and-backward route."""
    x = torch.zeros(8, 64, 34, 34)
    key = (tuple(x.shape), (64, 64, 3, 3), x.dtype, torch.device("cpu"))
    row = {"cudnn_fwd_ms": 1.25, "native_fwd_ms": 0.5, "cudnn_bwd_ms": 3.0,
           "native_bwd_ms": 2.5, "cudnn_fwd": False, "cudnn_bwd": True}
    assert convs._choice(convs.CONV_TIMES, "training", key, lambda: dict(row)) == row
    fresh = {}
    got = convs._choice(fresh, "training", key, lambda: pytest.fail("timed again"))
    assert got == row and fresh[key] == row
    assert "inference" not in json.loads(choices.read_text())[CARD]


def test_no_file_keeps_choices_in_the_process(choices, monkeypatch):
    monkeypatch.setattr(convs, "CHOICES_PATH", None)
    monkeypatch.setattr(convs, "cuda_ms", FakeTimer(10.0, 1.0))
    key, conv = _conv_call()
    convs.conv_by_shape(key, conv)
    assert convs._CUDNN_OK[key] is False and not choices.parent.exists()


# ------------------------------------------------------ --preset precedence

# The lists of tests/test_torch_throughput.py::test_cli_presets, with the
# reference's flags only.
PRESET_ARGS = [
    (),
    ("--preset", "fidelity"),
    ("--preset", "balanced"),
    ("--preset", "throughput"),
    ("--preset", "throughput", "--dtype", "float32"),
    ("--preset", "throughput", "--method", "eigh", "--no-compose-conv0"),
    ("--dtype", "bfloat16", "--compose-conv0", "--conv-precision", "high"),
    ("--preset", "balanced", "--dtype", "bfloat16", "--method", "newton_schulz"),
    ("--preset", "fidelity", "--compose-conv0"),
    ("--method", "newton_schulz_pallas"),
    ("--fold",),
    ("--preset", "throughput", "--fold"),
    ("--preset", "throughput", "--no-fold"),
    ("--preset", "balanced", "--no-fold", "--ring-conv"),
]


def _resolved(cfg):
    """Every field but ``pack2_junction``: the reference's throughput
    preset sets it (unless ``--fold``), the port's has no pack2."""
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
            if f.name != "pack2_junction"}


@pytest.mark.parametrize("flags", PRESET_ARGS, ids=lambda f: "_".join(f).replace("--", "") or "none")
@pytest.mark.parametrize("cli", ["stylize", "stream"])
def test_preset_precedence_matches_reference(cli, flags):
    if cli == "stylize":
        base = ["--content-path", "c", "--style-path", "s", "--out-path", "o"]
        ref_args, port_args = jstylize_cli.parse_args([*base, *flags]), tstylize_cli.parse_args(
            [*base, *flags])
    else:
        base = ["--style-path", "s.png"]
        ref_args, port_args = jstream_cli.parse_args([*base, *flags]), tstream_cli.parse_args(
            [*base, *flags])
    ref = _resolved(jcommon.config_from_args(ref_args))
    assert _resolved(tcommon.config_from_args(port_args)) == ref


# ------------------------------------------------- interpolation weights

WEIGHTS = [[0.25, 0.75], [1 / 3, 2 / 3], np.array([0.1, 0.9]), np.array([0.3, 0.7], np.float32),
           [1, 0], (0.5, 0.5, 0.0)]


@pytest.mark.parametrize("weights", WEIGHTS, ids=["list", "thirds", "np64", "np32", "ints", "tuple3"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_values_on_equals_as_tensor_bitwise(weights, dtype):
    old = torch.as_tensor(weights, device="cpu").to(dtype)
    new = values_on(weights, torch.device("cpu"), dtype)
    assert new.dtype == old.dtype and new.shape == old.shape and torch.equal(new, old)


def test_values_on_keeps_a_tensor():
    t = torch.tensor([0.2, 0.8], dtype=torch.float64)
    got = values_on(t, torch.device("cpu"), torch.float32)
    assert torch.equal(got, t.to(torch.float32))


def test_interpolated_stats_and_adain_bitwise(rng):
    """``interpolate_stats`` and the AdaIN blend of
    ``interpolate_style_caches`` give the bits of the old
    ``as_tensor`` expression."""
    k, c = 3, 8
    stats = [twct.StyleStats(kernel=torch.from_numpy(rng.standard_normal((c, c)).astype(np.float32)),
                             mean=torch.from_numpy(rng.standard_normal(c).astype(np.float32)))
             for _ in range(k)]
    weights = [0.2, 1 / 3, 0.4666]
    got = twct.interpolate_stats(stats, weights)
    w = torch.as_tensor(weights).to(torch.float32)
    assert torch.equal(got.kernel, torch.tensordot(w, torch.stack([s.kernel for s in stats]), 1))
    assert torch.equal(got.mean, torch.tensordot(w, torch.stack([s.mean for s in stats]), 1))

    cfg = tcascade.CascadeConfig(relu_targets=("relu1_1",), transform="adain")
    caches = [{"relu1_1": tcascade.LevelStyle(
        stats=None, fs_white=None,
        adain=adain_ops.AdainStats(mean=torch.from_numpy(rng.random(c).astype(np.float32)),
                                   std=torch.from_numpy(rng.random(c).astype(np.float32))))}
              for _ in range(k)]
    blend = tcascade.interpolate_style_caches(caches, np.array(weights), cfg)["relu1_1"].adain
    w64 = torch.as_tensor(np.array(weights)).to(torch.float32)
    means = torch.stack([c_["relu1_1"].adain.mean for c_ in caches])
    stds = torch.stack([c_["relu1_1"].adain.std for c_ in caches])
    assert torch.equal(blend.mean, torch.tensordot(w64, means, 1))
    assert torch.equal(blend.std, torch.tensordot(w64, stds, 1))
