"""Webcam / video stylization CLI, counterpart of ``wct_tpu/cli/stream.py``.

    python -m wct_tpu_torch.cli.stream --weights weights/bundle.npz \
        --style-path styles/ [--source 0 | --video in.mp4] [--out out.mp4] \
        [--width 1280 --height 720] [--device cuda]

Interactive keys (with a display): n/p next/prev style, +/- alpha, k
toggle keep-colors, i toggle 2-style interpolation sweep, q quit. With
``--out`` and no display, frames stream to a video file instead; with
``--video`` and ``--no-display`` every frame of the file is converted,
in batches of ``--batch-size``.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from wct_tpu_torch.cli import common
from wct_tpu_torch.utils import images
from wct_tpu_torch.utils.stream import StreamStylizer, VideoSource


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    common.add_model_flags(p)
    p.add_argument("--style-path", required=True, help="style image or dir")
    p.add_argument("--style-size", type=int, default=512)
    p.add_argument("--source", type=int, default=0, help="camera index")
    p.add_argument("--video", default=None, help="video file instead of camera")
    p.add_argument("--out", default=None, help="write stylized video here")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--fps", type=float, default=30.0, help="output video fps")
    p.add_argument("--keep-colors", action="store_true")
    p.add_argument("--no-display", action="store_true")
    p.add_argument("--interpolate", action="store_true",
                   help="sweep blend weights between the first two styles")
    p.add_argument("--max-frames", type=int, default=0, help="0 = unlimited")
    p.add_argument("--batch-size", type=int, default=1,
                   help=">1 batches frames for offline video throughput "
                        "(adds latency; only sensible with --video)")
    p.add_argument("--frame-batch", type=int, default=1,
                   help=">1 groups consecutive frames into one dispatch "
                        "in the pipelined path (higher throughput, "
                        "frame-batch-1 extra frames of latency)")
    p.add_argument("--no-pipeline", action="store_true",
                   help="strict per-frame latency: wait for each frame's "
                        "readback before submitting the next. Default is "
                        "submit-ahead/sync-behind (one frame of extra "
                        "latency, readback overlaps the next frame's "
                        "compute)")
    return p.parse_args(argv)


def _to_bgr_u8(img: np.ndarray) -> np.ndarray:
    """An engine output taken with ``raw=True`` (the card's uint8 bytes) as BGR."""
    return img[..., ::-1]


def _convert_video(args, engine, writer, cv2) -> None:
    """Offline video → stylized video, batched (no frame dropping)."""
    cap = cv2.VideoCapture(args.video)
    if not cap.isOpened():
        raise SystemExit(f"cannot open {args.video}")
    n = 0
    t0 = time.perf_counter()
    batch: list[np.ndarray] = []

    def flush():
        nonlocal n
        if not batch:
            return
        # Pad a short final batch to the steady-state size so it meets
        # no new shape (pad only once full batches have run).
        pad_to = args.batch_size if n > 0 else 0
        for out in engine.process_batch(batch, pad_to=pad_to, raw=True):
            if writer is not None:
                writer.write(_to_bgr_u8(out))
        n += len(batch)
        batch.clear()

    while True:
        ok, frame_bgr = cap.read()
        if not ok:
            break
        batch.append(frame_bgr[..., ::-1].astype(np.float32) / 255.0)
        if len(batch) >= max(args.batch_size, 1):
            flush()
        if args.max_frames and n + len(batch) >= args.max_frames:
            del batch[args.max_frames - n :]  # honor --max-frames exactly
            break
    flush()
    cap.release()
    if writer is not None:
        writer.release()
    dt = time.perf_counter() - t0
    print(f"{n} frames in {dt:.1f}s = {n / max(dt, 1e-9):.1f} fps")


def main(argv=None) -> None:
    args = parse_args(argv)
    import cv2

    cfg = common.config_from_args(args)
    params = common.load_params(args)

    style_files = images.list_images(args.style_path)
    if not style_files:
        raise SystemExit(f"no style images under {args.style_path}")
    styles = [
        images.resize_to(images.get_img(f), args.style_size) for f in style_files
    ]

    engine = StreamStylizer(
        params, cfg, args.height, args.width, keep_colors=args.keep_colors,
        readback="uint8",  # quantize on the card: 1/4 the D2H bytes
        frame_batch=1 if args.no_pipeline else max(1, args.frame_batch),
    )
    engine.alpha = args.alpha
    style_idx = 0
    interp_phase = 0.0
    if args.interpolate and len(styles) >= 2:
        engine.set_styles_interpolated(styles[:2], np.array([1.0, 0.0]))
    else:
        args.interpolate = False
        engine.set_style(styles[style_idx])

    writer = None
    if args.out:
        writer = cv2.VideoWriter(
            args.out,
            cv2.VideoWriter_fourcc(*"mp4v"),
            args.fps,
            (args.width, args.height),
        )

    if args.video and args.no_display:
        # Offline file conversion: read EVERY frame sequentially (the
        # live path's latest-frame mailbox drops frames by design) and
        # batch them for throughput.
        _convert_video(args, engine, writer, cv2)
        return

    source = VideoSource(
        args.video if args.video else args.source, args.width, args.height
    ).start()

    n = 0
    t_start = time.perf_counter()
    # Sustained-fps clock starts at the FIRST DELIVERED frame, not at
    # t_start: t_start includes the kernels' build, the per-shape conv
    # timing and pipeline priming.
    t_first = None
    n_first = 0
    try:
        while not source.stopped:
            frame_bgr = source.read()
            if frame_bgr is None:
                time.sleep(0.005)
                continue
            frame_rgb = frame_bgr[..., ::-1].astype(np.float32) / 255.0

            if args.interpolate:
                # Sweep the 2-style blend like the reference demo.
                interp_phase += 0.02
                w0 = 0.5 * (1 + np.cos(interp_phase))
                engine.set_interp_weights(np.array([w0, 1 - w0]))

            if args.no_pipeline:
                t0 = time.perf_counter()
                stylized = engine.process(frame_rgb, raw=True)
                dt = time.perf_counter() - t0
            else:
                # Submit-ahead/sync-behind: this call returns the
                # PREVIOUS frame's output while this frame computes, so
                # a per-call time means nothing; report sustained fps.
                stylized = engine.process_pipelined(frame_rgb, raw=True)
                if stylized is None:
                    continue  # pipeline priming (first frame / group fill)
                dt = None

            out_bgr = _to_bgr_u8(stylized)
            if writer is not None:
                writer.write(out_bgr)
            n += 1
            if t_first is None:
                t_first = time.perf_counter()
                n_first = n
            if n % 30 == 0:
                if dt is None:
                    if n > n_first:
                        fps = (n - n_first) / (time.perf_counter() - t_first)
                        print(f"frame {n}: {fps:.1f} fps sustained (pipelined)")
                else:
                    print(f"frame {n}: {dt * 1000:.0f} ms ({1 / dt:.1f} fps)")

            if not args.no_display:
                cv2.imshow("wct_tpu_torch", out_bgr)
                key = cv2.waitKey(1) & 0xFF
                if key == ord("q"):
                    break
                elif key == ord("n"):
                    args.interpolate = False  # single-style mode now
                    style_idx = (style_idx + 1) % len(styles)
                    engine.set_style(styles[style_idx])
                elif key == ord("p"):
                    args.interpolate = False
                    style_idx = (style_idx - 1) % len(styles)
                    engine.set_style(styles[style_idx])
                elif key in (ord("+"), ord("=")):
                    engine.alpha = min(1.0, engine.alpha + 0.1)
                    print(f"alpha={engine.alpha:.1f}")
                elif key == ord("-"):
                    engine.alpha = max(0.0, engine.alpha - 0.1)
                    print(f"alpha={engine.alpha:.1f}")
                elif key == ord("k"):
                    engine.keep_colors = not engine.keep_colors
                elif key == ord("i") and len(styles) >= 2:
                    args.interpolate = not args.interpolate
                    if args.interpolate:
                        engine.set_styles_interpolated(
                            styles[:2], np.array([1.0, 0.0])
                        )
                    else:
                        engine.set_style(styles[style_idx])
            if args.max_frames and n >= args.max_frames:
                break
    finally:
        # Drain the in-flight pipeline tail so --out loses no frames.
        while (tail := engine.collect(raw=True)) is not None:
            if writer is not None:
                writer.write(_to_bgr_u8(tail))
            n += 1
        elapsed = time.perf_counter() - t_start
        print(f"{n} frames in {elapsed:.1f}s = {n / max(elapsed, 1e-9):.1f} fps "
              "(wall clock incl. kernel build, conv timing and priming)")
        if t_first is not None and n > n_first:
            steady = (n - n_first) / (time.perf_counter() - t_first)
            print(f"steady-state (from first delivered frame): {steady:.1f} fps")
        source.stop()
        if writer is not None:
            writer.release()
        if not args.no_display:
            cv2.destroyAllWindows()


if __name__ == "__main__":
    main()
