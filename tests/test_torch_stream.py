"""The port's stream engine and stream CLI against ``wct_tpu``'s.

Every case of ``tests/test_cli.py::TestStreamEngine`` on the port's
``StreamStylizer`` (CPU, trained bundle, 32 px), then the same frames
through both packages' engines within ``test_torch_cascade.py``'s
per-level bounds (q99 ≤ 1e-4, max ≤ 1e-3), with ``method="newton_schulz"``
(the same plain iteration in both) and at most two levels. Where the
reference allows ``atol=1e-5`` between a grouped and a strict frame, the
port is held to the same bits: every dispatch has the engine's one batch
shape.
"""

import argparse
from pathlib import Path

import numpy as np
import pytest
import torch

from wct_tpu.cli import stream as jstream_cli
from wct_tpu.models import cascade as jcascade
from wct_tpu.train import checkpoint as jck
from wct_tpu.utils import stream as jstream
from wct_tpu_torch.cli import common
from wct_tpu_torch.cli import stream as stream_cli
from wct_tpu_torch.models import cascade as tcascade
from wct_tpu_torch.train import checkpoint as tck
from wct_tpu_torch.utils import images
from wct_tpu_torch.utils.stream import StreamStylizer

BUNDLE = Path(__file__).resolve().parent.parent / "weights" / "bundle.npz"
TWO = ("relu2_1", "relu1_1")
ONE = ("relu1_1",)
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


@pytest.fixture(scope="module")
def tparams():
    return tck.params_from_numpy(tck.load_pytree(BUNDLE), "cpu")


@pytest.fixture(scope="module")
def jparams():
    return jck.load_pytree(BUNDLE)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _cfg(targets):
    return tcascade.CascadeConfig(relu_targets=targets, method=METHOD)


def _frames(rng, n, hw=(32, 32)):
    return [rng.random((*hw, 3)).astype(np.float32) for _ in range(n)]


def _drain(eng, frames):
    piped = [eng.process_pipelined(f) for f in frames]
    while (tail := eng.collect()) is not None:
        piped.append(tail)
    return piped


def _close(got, want):
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert np.quantile(d, 0.99) <= 1e-4, np.quantile(d, 0.99)
    assert d.max() <= 1e-3, d.max()


# ---- tests/test_cli.py::TestStreamEngine, on the port ----


def test_process_frames_with_cached_style(tparams, rng):
    eng = StreamStylizer(tparams, _cfg(TWO), 32, 32)
    eng.set_style(rng.random((32, 32, 3)).astype(np.float32))
    out1 = eng.process(rng.random((32, 32, 3)).astype(np.float32))
    # A differently sized frame is resized to the fixed shape.
    out2 = eng.process(rng.random((48, 64, 3)).astype(np.float32))
    assert out1.shape == out2.shape == (32, 32, 3)
    assert out1.dtype == np.float32


def test_interpolation_weights_live(tparams, rng):
    eng = StreamStylizer(tparams, _cfg(ONE), 32, 32)
    s1, s2, frame = _frames(rng, 3)
    eng.set_styles_interpolated([s1, s2], np.array([1.0, 0.0]))
    out_a = eng.process(frame)
    eng.set_interp_weights(np.array([0.0, 1.0]))
    out_b = eng.process(frame)
    assert not np.allclose(out_a, out_b)
    eng.set_style(s2)
    with pytest.raises(RuntimeError, match="set_styles_interpolated"):
        eng.set_interp_weights(np.array([0.5, 0.5]))


def test_no_style_raises(tparams, rng):
    eng = StreamStylizer(tparams, _cfg(ONE), 32, 32)
    with pytest.raises(RuntimeError, match="no style"):
        eng.process(rng.random((32, 32, 3)).astype(np.float32))
    with pytest.raises(RuntimeError, match="no style"):
        eng.process_batch(_frames(rng, 2))


@pytest.mark.parametrize(
    "kw", [dict(readback="f16"), dict(pipeline_depth=0), dict(frame_batch=0)],
    ids=["readback", "pipeline_depth", "frame_batch"])
def test_bad_settings_raise(tparams, kw):
    with pytest.raises(ValueError):
        StreamStylizer(tparams, _cfg(ONE), 32, 32, **kw)


def test_pipelined_matches_strict_in_order(tparams, rng):
    """submit-ahead/sync-behind returns the SAME outputs as strict
    per-frame processing, shifted by pipeline_depth, and drains."""
    eng = StreamStylizer(tparams, _cfg(TWO), 32, 32)
    eng.set_style(rng.random((32, 32, 3)).astype(np.float32))
    frames = _frames(rng, 4)
    strict = [eng.process(f) for f in frames]
    piped = _drain(eng, frames)
    assert piped[0] is None  # priming
    piped = [p for p in piped if p is not None]
    assert len(piped) == len(strict)
    for a, b in zip(strict, piped):
        np.testing.assert_array_equal(a, b)
    assert eng.n_pending == 0


@pytest.mark.parametrize("depth,fb", [(1, 2), (2, 3)])
def test_frame_batch_matches_strict_in_order(tparams, rng, depth, fb):
    """Grouped frames give strict mode's bits, in order, and the drain
    flushes the partial group without losing frames (7 frames)."""
    eng = StreamStylizer(tparams, _cfg(TWO), 32, 32, pipeline_depth=depth, frame_batch=fb)
    eng.set_style(rng.random((32, 32, 3)).astype(np.float32))
    frames = _frames(rng, 7)
    strict = [eng.process(f) for f in frames]
    piped = [p for p in _drain(eng, frames) if p is not None]
    assert len(piped) == len(strict)
    for a, b in zip(strict, piped):
        np.testing.assert_array_equal(a, b)
    assert eng.n_pending == 0


def test_submit_ahead_beyond_the_ring_keeps_every_frame(tparams, rng):
    """More groups submitted than host slots: the oldest are read back
    first, and every output is still its frame's, in order."""
    eng = StreamStylizer(tparams, _cfg(ONE), 32, 32, frame_batch=2)
    eng.set_style(rng.random((32, 32, 3)).astype(np.float32))
    frames = _frames(rng, 9)
    want = [eng.process(f) for f in frames]
    for f in frames:
        eng.submit(f)
        assert len(eng._pending) <= len(eng._ring)
    assert eng.n_pending == 9
    got = []
    while (out := eng.collect()) is not None:
        got.append(out)
    assert len(got) == 9
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)


def test_frame_batch_settings_bind_at_group_start(tparams, rng):
    """A live alpha change between two buffered submits does NOT apply
    retroactively to the group's earlier frame; collect(flush=False)
    between submits dispatches no padded partial group."""
    cfg = _cfg(ONE)
    style = rng.random((32, 32, 3)).astype(np.float32)
    frames = _frames(rng, 2)
    strict = StreamStylizer(tparams, cfg, 32, 32)
    strict.set_style(style)
    strict.alpha = 0.3
    want = [strict.process(f) for f in frames]

    eng = StreamStylizer(tparams, cfg, 32, 32, frame_batch=2)
    eng.set_style(style)
    eng.alpha = 0.3
    eng.submit(frames[0])
    assert eng.collect(flush=False) is None
    assert len(eng._pending) == 0 and len(eng._inbuf) == 1
    eng.alpha = 0.9  # takes effect from the NEXT group
    eng.submit(frames[1])
    got = [eng.collect(), eng.collect()]
    for a, b in zip(want, got):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_uint8_readback_matches_host_quantization(tparams, rng):
    """Quantising on the device == clip(x, 0, 1) * 255 → uint8 on the host."""
    eng_f = StreamStylizer(tparams, _cfg(ONE), 32, 32)
    eng_u = StreamStylizer(tparams, _cfg(ONE), 32, 32, readback="uint8")
    style, frame = _frames(rng, 2)
    eng_f.set_style(style)
    eng_u.set_style(style)
    out_f, out_u = eng_f.process(frame), eng_u.process(frame)
    host_u8 = (np.clip(out_f, 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(host_u8, (np.clip(out_u, 0, 1) * 255).astype(np.uint8))
    np.testing.assert_array_equal(host_u8, np.rint(out_u * 255).astype(np.uint8))


@pytest.mark.parametrize("entry", ["process", "process_batch", "pipelined"])
def test_raw_returns_the_readback_bytes(tparams, rng, entry):
    """``raw=True`` hands over the uint8 readback itself: the bytes that the
    float32 outputs were made from, through each entry point."""
    eng = StreamStylizer(tparams, _cfg(ONE), 32, 32, readback="uint8", frame_batch=2)
    style, *frames = _frames(rng, 4)
    eng.set_style(style)
    if entry == "process":
        got = [eng.process(f, raw=True) for f in frames]
        want = [eng.process(f) for f in frames]
    elif entry == "process_batch":
        got = eng.process_batch(frames, pad_to=4, raw=True)
        want = eng.process_batch(frames, pad_to=4)
    else:
        got = [o for o in (eng.process_pipelined(f, raw=True) for f in frames) if o is not None]
        while (tail := eng.collect(raw=True)) is not None:
            got.append(tail)
        want = [p for p in _drain(eng, frames) if p is not None]
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == np.uint8 and g.shape == (32, 32, 3)
        np.testing.assert_array_equal(g.astype(np.float32) / 255.0, w)


def test_stage_timer_splits_the_strict_path(tparams, rng):
    """``timer`` records each stage of a strict call once, and the output
    is the untimed call's."""
    from wct_tpu_torch.utils.profiling import StageTimer

    eng = StreamStylizer(tparams, _cfg(ONE), 32, 32, readback="uint8")
    style, frame = _frames(rng, 2)
    eng.set_style(style)
    want = eng.process(frame)
    eng.timer = StageTimer()
    got = eng.process(frame)
    np.testing.assert_array_equal(got, want)
    stages = ("resize", "host_prep", "h2d", "device", "d2h", "host_post")
    assert dict(eng.timer.counts) == {name: 1 for name in stages}


# ---- the same frames through wct_tpu's engine and the port's ----


def _pair(tparams, jparams, targets, **kw):
    t = StreamStylizer(tparams, tcascade.CascadeConfig(relu_targets=targets, method=METHOD),
                       32, 40, **kw)
    j = jstream.StreamStylizer(jparams, jcascade.CascadeConfig(relu_targets=targets, method=METHOD),
                               32, 40, **kw)
    return t, j


def test_process_and_pipelined_match_the_reference(tparams, jparams, rng):
    t, j = _pair(tparams, jparams, TWO)
    style = rng.random((40, 36, 3)).astype(np.float32)
    for eng in (t, j):
        eng.set_style(style)
        eng.alpha = 0.7
    frames = _frames(rng, 3, (32, 40)) + [rng.random((50, 44, 3)).astype(np.float32)]
    for f in frames:
        _close(t.process(f), j.process(f))
    piped = [p for p in _drain(t, frames) if p is not None]
    for f, p in zip(frames, piped):
        _close(p, j.process(f))


def test_process_batch_with_keep_colors_matches_the_reference(tparams, jparams, rng):
    t, j = _pair(tparams, jparams, TWO, keep_colors=True)
    style = rng.random((32, 32, 3)).astype(np.float32)
    for eng in (t, j):
        eng.set_style(style)
    frames = _frames(rng, 3, (32, 40))
    got, want = t.process_batch(frames, pad_to=4), j.process_batch(frames, pad_to=4)
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        assert a.shape == (32, 40, 3)
        _close(a, b)


def test_two_style_interpolation_matches_the_reference(tparams, jparams, rng):
    t, j = _pair(tparams, jparams, ONE, readback="uint8")
    styles = _frames(rng, 2, (36, 36))
    frame = rng.random((32, 40, 3)).astype(np.float32)
    for w0 in (1.0, 0.3):
        for eng in (t, j):
            eng.set_styles_interpolated(styles, np.array([w0, 1.0 - w0]))
        got, want = t.process(frame), j.process(frame)
        # uint8 readback: both quantise the same f32 output; one step of
        # 1/255 where the two packages' f32 values straddle a step.
        assert np.abs(got - want).max() <= 1.0 / 255 + 1e-6
        assert np.mean(got != want) <= 1e-3


# ---- the CLI ----


def _options(parser_fn, argv):
    """{dest: default} of a CLI's parser (``argv`` fills the required flags)."""
    captured = {}
    real = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        captured["p"] = self
        return real(self, args, namespace)

    argparse.ArgumentParser.parse_args = grab
    try:
        parser_fn(argv)
    finally:
        argparse.ArgumentParser.parse_args = real
    return {a.dest: a.default for a in captured["p"]._actions if a.dest != "help"}


def test_every_reference_option_exists_with_its_default():
    """Every option of the reference's stream parser, with its default,
    ``--checkpoints`` / ``--vgg-path`` included. ``--method`` and
    ``--dtype`` are also read back through ``config_from_args``, as the
    configuration resolves them."""
    argv = ["--style-path", "s.png"]
    ref, port = _options(jstream_cli.parse_args, argv), _options(stream_cli.parse_args, argv)
    assert set(ref) - set(port) == set()
    assert set(port) - set(ref) == {"device"} and port["device"] == "cuda"
    cfg = common.config_from_args(stream_cli.parse_args(argv))
    resolved = {**port, "method": cfg.method, "dtype": cfg.compute_dtype}
    for dest in set(ref) & set(port):
        assert resolved[dest] == ref[dest], (dest, resolved[dest], ref[dest])


def test_stream_cli_defaults_to_the_card_and_raises_without_one(tmp_path):
    pytest.importorskip("cv2")
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stream_cli.main(["--style-path", str(tmp_path), "--video", "in.mp4", "--no-display"])


def test_video_source_reads_a_file(tmp_path, rng):
    cv2 = pytest.importorskip("cv2")
    from wct_tpu_torch.utils.stream import VideoSource

    src = str(tmp_path / "in.mp4")
    w = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 10, (48, 32))
    for _ in range(3):
        w.write((rng.random((32, 48, 3)) * 255).astype(np.uint8))
    w.release()
    vs = VideoSource(src).start()
    vs._thread.join(timeout=10)
    assert not vs._thread.is_alive() and vs.stopped
    frame = vs.read()
    assert frame is not None and frame.shape == (32, 48, 3) and frame.dtype == np.uint8
    vs.stop()
    with pytest.raises(RuntimeError, match="cannot open"):
        VideoSource(str(tmp_path / "missing.mp4"))


def test_stream_cli_offline_video(tmp_path, rng):
    """Offline video conversion on the CPU: every frame processed, batched."""
    cv2 = pytest.importorskip("cv2")

    src = str(tmp_path / "in.mp4")
    w = cv2.VideoWriter(src, cv2.VideoWriter_fourcc(*"mp4v"), 10, (48, 32))
    for _ in range(7):
        w.write((rng.random((32, 48, 3)) * 255).astype(np.uint8))
    w.release()
    s_dir = tmp_path / "style"
    s_dir.mkdir()
    images.save_img(s_dir / "s.png", rng.random((32, 32, 3)))
    out = str(tmp_path / "out.mp4")
    stream_cli.main([
        "--video", src, "--out", out, "--style-path", str(s_dir), "--style-size", "32",
        "--width", "48", "--height", "32", "--relu-targets", "relu1_1", "--no-display",
        "--batch-size", "4", "--weights", str(BUNDLE), "--device", "cpu",
    ])
    cap = cv2.VideoCapture(out)
    n = 0
    while cap.read()[0]:
        n += 1
    assert n == 7  # no frames dropped in offline mode
