"""Streaming video stylization: threaded capture + persistent style cache.

Counterpart of ``wct_tpu/utils/stream.py``:

- ``VideoSource`` — a daemon capture thread with a latest-frame mailbox,
  decoupling camera/file IO from compute.
- ``StreamStylizer`` — a per-frame engine with a persistent style
  cache: a style is encoded once per switch, and every frame of the
  fixed ``height × width`` stream reuses its cached statistics. It has
  live alpha and two-style interpolation, a strict-latency mode and a
  submit-ahead mode.

On the card, submit-ahead is built from CUDA streams and pinned host
memory. Frames are staged into pinned buffers and copied to the card
with ``non_blocking=True``; the cascade runs on the current stream; the
output goes back to a pinned buffer on a copy stream that waits for the
cascade's event, so the host can stage and enqueue the next group while
the card works and the copy runs. With ``device="cpu"`` parameters the
same code runs without streams.

cv2 is imported lazily and only needed for camera/video sources; the
engine itself is array-in/array-out and is exercised by CPU tests.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from collections import deque

import numpy as np
import torch

from wct_tpu_torch.models import cascade
from wct_tpu_torch.utils import colors as color_utils
from wct_tpu_torch.utils import images as img_utils
from wct_tpu_torch.utils.device import params_device
from wct_tpu_torch.utils.profiling import span

# Each stage's span, named once so that a span costs no string per call.
_STAGE_SPANS = {name: f"wct.stream.{name}" for name in
                ("resize", "host_prep", "h2d", "device", "d2h", "host_post")}


def _require_cv2():
    try:
        import cv2  # noqa: PLC0415

        return cv2
    except ImportError as e:  # pragma: no cover
        raise RuntimeError(
            "OpenCV (cv2) is required for camera/video capture"
        ) from e


class VideoSource:
    """Threaded frame grabber with a latest-frame mailbox.

    The capture thread always overwrites the newest frame, so compute
    never processes a backlog (drop frames, not latency).
    """

    def __init__(self, src: int | str = 0, width: int = 0, height: int = 0):
        cv2 = _require_cv2()
        self._cap = cv2.VideoCapture(src)
        if width:
            self._cap.set(cv2.CAP_PROP_FRAME_WIDTH, width)
        if height:
            self._cap.set(cv2.CAP_PROP_FRAME_HEIGHT, height)
        if not self._cap.isOpened():
            raise RuntimeError(f"cannot open video source {src!r}")
        self._lock = threading.Lock()
        self._frame: np.ndarray | None = None
        self._stopped = False
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def start(self) -> "VideoSource":
        self._thread.start()
        return self

    def _loop(self):
        while not self._stopped:
            ok, frame = self._cap.read()
            if not ok:
                self._stopped = True
                break
            with self._lock:
                self._frame = frame

    def read(self) -> np.ndarray | None:
        """Latest BGR uint8 frame, or None if the source ended."""
        with self._lock:
            return None if self._frame is None and self._stopped else self._frame

    @property
    def stopped(self) -> bool:
        return self._stopped

    def stop(self):
        # Join the capture thread BEFORE releasing: release() while a
        # read() is in flight is not thread-safe in OpenCV.
        self._stopped = True
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
        self._cap.release()


@dataclasses.dataclass
class _Slot:
    """One group's host buffers: frames in (f32) and outputs back."""

    host_in: torch.Tensor  # [K, H, W, 3] f32, pinned on the card's host
    host_out: torch.Tensor  # [K, H, W, 3] f32 or uint8, pinned likewise


@dataclasses.dataclass
class _Group:
    """A dispatched group: its resized frames, the slot its output lands
    in, the copy's event (None on the CPU) and how many frames are real."""

    frames: list[np.ndarray]
    slot: _Slot
    copied: torch.cuda.Event | None
    n: int


class StreamStylizer:
    """Fixed-shape per-frame stylization engine with style-stat caching.

    Two serving modes:

    - ``process(frame)`` — strict latency: stage, copy, stylize, copy
      back and return THIS frame's output. Each call pays the whole
      round trip serially.
    - ``submit(frame)`` / ``collect()`` (or ``process_pipelined``) —
      submit-ahead/sync-behind: frame N+1's host preparation, H2D copy
      and cascade are enqueued BEFORE frame N's output is read back, so
      the host work and the readback overlap the card's compute. The
      card runs one stream in order, so the results are those of strict
      mode; the cost is ``pipeline_depth`` groups of display latency.

    ``readback='uint8'`` clips and quantizes ON THE CARD, so the D2H copy
    moves a quarter of the bytes; ``(x.clamp(0, 1) * 255).to(uint8)``
    truncates as numpy's ``astype`` does, so it is bitwise the host's
    ``clip(x, 0, 1) * 255 → uint8``. Outputs are still returned as
    float32 in [0, 1]; ``raw=True`` on ``process``, ``process_batch``,
    ``collect`` and ``process_pipelined`` returns them in the readback's
    type instead (uint8 bytes as they landed), which is what a caller
    that encodes video wants: the host then converts nothing.

    ``frame_batch=K`` groups K consecutive frames into ONE cascade call in
    the pipelined path: K−1 more frames of latency, fewer and larger
    launches. K=1 keeps strict frame-at-a-time semantics.

    Every dispatch goes through one path (``_dispatch``: a pinned slot,
    H2D, the cascade, the readback on the copy stream). Strict and
    grouped dispatches run the cascade on the one shape
    ``[frame_batch, height, width, 3]`` (a short group and a strict frame
    are padded with their last frame), as ``stylize_microbatched`` does:
    a stock conv's result for one image depends on the batch it runs in
    (cuDNN picks its algorithm by shape, batch included; ``chip_smoke.py``
    phase ``stream_batch_gap`` finds the first op at which a frame alone
    and in a batch part), so only a fixed shape makes a frame's output
    the same bits whichever mode and group it went in. ``process_batch``
    runs at ``[max(n, pad_to), height, width, 3]`` through the same
    path. The reference's strict mode is a batch-1
    dispatch whatever ``frame_batch``; here a strict call on an engine
    with ``frame_batch=K`` costs a K-frame cascade, and the stream CLI's
    strict mode (``--no-pipeline``) runs with ``frame_batch=1``.

    Host buffers: a ring of ``pipeline_depth + 1`` pinned slots, one per
    group in flight plus the one being filled. A group's slot is reused
    only after its readback was synchronised; ``submit`` reads back the
    oldest group first when every slot is in flight, so no host buffer
    is rewritten while a copy reads or writes it.

    Each stage runs in a span ``wct.stream.<stage>`` (``resize`` in
    strict mode, ``host_prep``: staging into the pinned buffer, ``h2d``,
    ``device``, ``d2h`` and ``host_post``), which a profiler records
    without synchronising anything. ``timer`` (None by default) takes a
    ``profiling.StageTimer``: each dispatch then synchronises at every
    stage boundary and records the same stages. That serialises the
    stages, so it is for measuring the strict path's split, not for
    serving.
    """

    def __init__(
        self,
        params: dict,
        cfg: cascade.CascadeConfig,
        height: int,
        width: int,
        keep_colors: bool = False,
        readback: str = "float32",
        pipeline_depth: int = 1,
        frame_batch: int = 1,
    ):
        self.params = params
        self.cfg = cfg
        self.height = height
        self.width = width
        self.keep_colors = keep_colors
        self.alpha = 1.0
        self.timer = None
        self._cache: cascade.StyleCache | None = None
        self._caches: list[cascade.StyleCache] = []
        if readback not in ("float32", "uint8"):
            raise ValueError(f"readback must be 'float32'|'uint8', got {readback!r}")
        self._out_dtype = torch.uint8 if readback == "uint8" else torch.float32
        if pipeline_depth < 1:
            raise ValueError(f"pipeline_depth must be >= 1, got {pipeline_depth}")
        self.pipeline_depth = pipeline_depth
        if frame_batch < 1:
            raise ValueError(f"frame_batch must be >= 1, got {frame_batch}")
        self.frame_batch = frame_batch
        self.device = params_device(params)
        on_card = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) if on_card else None
        self._ring = [self._new_slot(frame_batch) for _ in range(pipeline_depth + 1)]
        self._next_slot = 0
        self._strict_slot = self._new_slot(frame_batch)
        self._batch_slots: dict[int, _Slot] = {}  # process_batch's, by size
        self._pending: deque[_Group] = deque()
        self._inbuf: list[np.ndarray] = []  # frames awaiting a full group
        self._outbuf: deque[np.ndarray] = deque()  # materialized, undelivered
        # (alpha, style cache) snapshotted when a group's FIRST frame is
        # submitted, so a live setting change never applies retroactively
        # to frames already buffered.
        self._group_settings: tuple[float, cascade.StyleCache | None] | None = None

    def _new_slot(self, k: int) -> _Slot:
        pin = self.device.type == "cuda"
        shape = (k, self.height, self.width, 3)
        return _Slot(
            host_in=torch.empty(shape, dtype=torch.float32, pin_memory=pin),
            host_out=torch.empty(shape, dtype=self._out_dtype, pin_memory=pin),
        )

    def _stage(self, name: str, sync_on=None):
        """The stage's span ``wct.stream.<name>``, with the ``timer``'s
        synchronised stage inside it when one is set."""
        if self.timer is None:
            return span(_STAGE_SPANS[name])
        return self._timed_stage(name, sync_on)

    @contextlib.contextmanager
    def _timed_stage(self, name: str, sync_on):
        with span(_STAGE_SPANS[name]), self.timer.stage(name, sync_on=sync_on):
            yield

    # -- style management (encode ONCE per style switch) --
    def set_style(self, style_img: np.ndarray) -> None:
        self._cache = cascade.precompute_style(
            self.params["encoder"], np.asarray(style_img, np.float32), self.cfg
        )
        self._caches = []

    def set_styles_interpolated(
        self, style_imgs: list[np.ndarray], weights: np.ndarray
    ) -> None:
        """Cache K styles; blend with ``weights`` (reference --interpolate)."""
        self._caches = [
            cascade.precompute_style(
                self.params["encoder"], np.asarray(s, np.float32), self.cfg
            )
            for s in style_imgs
        ]
        self.set_interp_weights(weights)

    def set_interp_weights(self, weights: np.ndarray) -> None:
        if not self._caches:
            raise RuntimeError("call set_styles_interpolated first")
        self._cache = cascade.interpolate_style_caches(
            self._caches, np.asarray(weights, np.float32), self.cfg
        )

    # -- batched offline path (video files) --
    def process_batch(
        self, frames_rgb: list[np.ndarray], pad_to: int = 0, raw: bool = False
    ) -> list[np.ndarray]:
        """Stylize N frames in one cascade call (offline video throughput).

        ``pad_to`` pads a short trailing batch up to the steady-state
        size (repeating the last frame; extra outputs dropped), so every
        call has the same shape and meets no new conv shape. The batch
        goes through the pinned slot of its size and the copy stream, as
        every dispatch does.
        """
        if self._cache is None:
            raise RuntimeError("no style set")
        sized = [self._resize(f) for f in frames_rgb]
        k = max(len(sized), pad_to)
        if k not in self._batch_slots:
            self._batch_slots[k] = self._new_slot(k)
        slot = self._batch_slots[k]
        copied = self._dispatch(sized, slot)
        return self._read_slot(sized, slot, copied, len(sized), raw)

    # -- per-frame hot path --
    def _resize(self, frame_rgb: np.ndarray) -> np.ndarray:
        if frame_rgb.shape[:2] != (self.height, self.width):
            frame_rgb = img_utils.resize_exact(frame_rgb, self.height, self.width)
        return frame_rgb

    def _dispatch(
        self,
        frames: list[np.ndarray],
        slot: _Slot,
        alpha: float | None = None,
        cache: cascade.StyleCache | None = None,
    ) -> torch.cuda.Event | None:
        """Stage ``frames`` (padded with the last to the slot's batch) in
        the slot, enqueue H2D, the cascade and the readback into the
        slot's output buffer; return the readback's event (None on the
        CPU, where all of it has run when this returns)."""
        cache = cache if cache is not None else self._cache
        if cache is None:
            raise RuntimeError("no style set")
        alpha = self.alpha if alpha is None else alpha
        k = slot.host_in.shape[0]
        with self._stage("host_prep"):
            host_in = slot.host_in.numpy()
            for i in range(k):
                host_in[i] = frames[min(i, len(frames) - 1)]
        # The stage lambdas read x and y when their block exits.
        with self._stage("h2d", sync_on=lambda: x):
            x = slot.host_in.to(self.device, non_blocking=True)
        with self._stage("device", sync_on=lambda: y):
            y = cascade.stylize(self.params, x, cache, alpha, self.cfg)
            if self._out_dtype == torch.uint8:
                y = (y.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
        if self._copy_stream is None:
            with self._stage("d2h"):
                slot.host_out.copy_(y)
            return None
        copied = torch.cuda.Event()
        with self._stage("d2h", sync_on=lambda: copied):
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            self._copy_stream.wait_event(done)
            with torch.cuda.stream(self._copy_stream):
                slot.host_out.copy_(y, non_blocking=True)
                # The caching allocator must not hand y's memory to the
                # next group while this copy still reads it.
                y.record_stream(self._copy_stream)
                copied.record(self._copy_stream)
        return copied

    def _read_slot(
        self, frames: list[np.ndarray], slot: _Slot, copied, n: int,
        raw: bool | None = None,
    ) -> list[np.ndarray]:
        """Wait for a slot's readback; its first ``n`` outputs as new
        arrays (the slot's buffer is reused afterwards): in the readback's
        type, or with ``keep_colors`` as float32 with the frames' colours;
        then, unless ``raw`` is None, as ``_deliver`` gives them."""
        if copied is not None:
            copied.synchronize()
        with self._stage("host_post"):
            outs = list(slot.host_out.numpy()[:n].copy())
            if self.keep_colors:
                outs = [color_utils.preserve_colors_np(f, self._deliver(o, False))
                        for f, o in zip(frames, outs)]
            if raw is not None:
                outs = [self._deliver(o, raw) for o in outs]
        return outs

    def _deliver(self, out: np.ndarray, raw: bool) -> np.ndarray:
        """An output as the caller asked for it: float32 in [0, 1], or
        (``raw``) in the readback's type."""
        if not raw:
            return out.astype(np.float32) / 255.0 if out.dtype == np.uint8 else out
        if self._out_dtype == torch.uint8 and out.dtype != np.uint8:
            return (np.clip(out, 0.0, 1.0) * 255.0).astype(np.uint8)
        return out

    def _launch_group(self, frames: list[np.ndarray]) -> None:
        """Dispatch ≤frame_batch resized frames as one padded batch,
        using the settings snapshotted at the group's first submit."""
        alpha, cache = (
            self._group_settings
            if self._group_settings is not None
            else (self.alpha, self._cache)
        )
        self._group_settings = None
        # Every slot in flight: read back the oldest group (the slot's
        # owner) before its host buffers are rewritten.
        while len(self._pending) >= len(self._ring):
            self._materialize_group()
        slot = self._ring[self._next_slot]
        self._next_slot = (self._next_slot + 1) % len(self._ring)
        copied = self._dispatch(frames, slot, alpha, cache)
        self._pending.append(_Group(frames, slot, copied, len(frames)))

    def _materialize_group(self) -> None:
        """Read back the oldest in-flight group into the output buffer."""
        g = self._pending.popleft()
        self._outbuf.extend(self._read_slot(g.frames, g.slot, g.copied, g.n))

    def process(self, frame_rgb: np.ndarray, raw: bool = False) -> np.ndarray:
        """Stylize one RGB float [0,1] frame (any size → fixed size).

        Strict-latency mode: blocks for this frame's readback; one
        dispatch of the frame padded to ``frame_batch``.
        """
        with self._stage("resize"):
            frame = self._resize(frame_rgb)
        copied = self._dispatch([frame], self._strict_slot)
        return self._read_slot([frame], self._strict_slot, copied, 1, raw)[0]

    # -- pipelined mode (submit-ahead / sync-behind) --
    def submit(self, frame_rgb: np.ndarray) -> None:
        """Enqueue a frame's stylization without waiting for its output.

        Frames accumulate until ``frame_batch`` are buffered, then fly
        as one dispatch. Alpha/style/interp settings are snapshotted
        when a group's FIRST frame is submitted and apply to that whole
        group — a live change takes effect from the next group, never
        retroactively.
        """
        if not self._inbuf:
            self._group_settings = (self.alpha, self._cache)
        self._inbuf.append(self._resize(frame_rgb))
        if len(self._inbuf) >= self.frame_batch:
            self._launch_group(self._inbuf)
            self._inbuf = []

    def collect(self, flush: bool = True, raw: bool = False) -> np.ndarray | None:
        """Read back the OLDEST in-flight frame (None if none pending).

        With ``flush=True`` (default) a partially-filled frame group is
        dispatched first (padded), so draining with ``while (out :=
        eng.collect()) is not None`` loses no frames. Pollers calling
        ``collect()`` BETWEEN submits mid-stream should pass
        ``flush=False`` so polling doesn't silently defeat batching
        with padded dispatches.
        """
        if self._outbuf:
            return self._deliver(self._outbuf.popleft(), raw)
        if self._inbuf and flush:
            self._launch_group(self._inbuf)
            self._inbuf = []
        if not self._pending:
            return None
        self._materialize_group()
        return self._deliver(self._outbuf.popleft(), raw)

    def process_pipelined(
        self, frame_rgb: np.ndarray, raw: bool = False
    ) -> np.ndarray | None:
        """Submit this frame; return a PREVIOUS frame's output.

        Returns None while the pipeline primes (the first
        ``pipeline_depth × frame_batch`` frames, plus group-fill gaps);
        call ``collect()`` after the stream ends to drain the in-flight
        tail. Output order is submission order.
        """
        self.submit(frame_rgb)
        if self._outbuf:
            return self._deliver(self._outbuf.popleft(), raw)
        if len(self._pending) > self.pipeline_depth:
            self._materialize_group()
            return self._deliver(self._outbuf.popleft(), raw)
        return None

    @property
    def n_pending(self) -> int:
        """Frames in flight (dispatched or buffered), not yet delivered."""
        return (
            sum(g.n for g in self._pending)
            + len(self._inbuf)
            + len(self._outbuf)
        )
