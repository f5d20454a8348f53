"""Batch stylization CLI, the port of ``wct_tpu/cli/stylize.py``.

    python -m wct_tpu_torch.cli.stylize --weights weights/bundle.npz \
        --content-path c.jpg --style-path styles/ --out-path out/ \
        --alpha 0.8 --content-size 512 --method newton_schulz_pallas
    python -m wct_tpu_torch.cli.stylize --weights weights/bundle.npz \
        --content-path c.jpg --style-path s.jpg --out-path out/ \
        --preset throughput [--keep-colors] [--concat] [--swap5] [--adain]

Content × style cartesian product (file or directory each). Each
style's statistics are computed once and reused for every content
image; same-shape content images are batched (``--batch-size``) and
served through ``stylize_microbatched``, so an output does not depend
on how many same-shape files were in the run. ``--interp-weights``
blends every style of ``--style-path`` into one; ``--coral`` recolours
the style toward each content image, one pair at a time.
``--data-parallel`` splits each batch over every card of ``--device``
(``parallel.stylize_sharded``). Runs on ``--device`` (default cuda).
"""

from __future__ import annotations

import argparse
import functools
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

from wct_tpu_torch.cli import common
from wct_tpu_torch.models import cascade
from wct_tpu_torch.parallel import mesh as mesh_lib
from wct_tpu_torch.utils import colors, images


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__)
    common.add_model_flags(p)
    p.add_argument("--content-path", required=True, help="image file or dir")
    p.add_argument("--style-path", required=True, help="image file or dir")
    p.add_argument("--out-path", required=True, help="output dir")
    p.add_argument("--content-size", type=int, default=0,
                   help="resize content shorter side (0 = keep)")
    p.add_argument("--style-size", type=int, default=0,
                   help="resize style shorter side (0 = keep)")
    p.add_argument("--crop-size", type=int, default=0,
                   help="center-crop content to this square (0 = off)")
    p.add_argument("--batch-size", type=int, default=4,
                   help="batch same-shaped content images per dispatch")
    p.add_argument("--keep-colors", action="store_true",
                   help="luminance-only transfer (reference --keep-colors)")
    p.add_argument("--coral", action="store_true",
                   help="CORAL-match style colors to content first "
                        "(forces per-pair processing)")
    p.add_argument("--concat", action="store_true",
                   help="paste style thumbnail beside the output")
    p.add_argument("--random-crop-style", action="store_true",
                   help="random square crop of the style (reference --random)")
    p.add_argument("--interp-weights", type=float, nargs="+", default=None,
                   help="blend ALL styles in --style-path with these weights "
                        "instead of iterating them")
    p.add_argument("--data-parallel", action="store_true",
                   help="shard each batch over all local devices "
                        "(parallel.stylize_sharded); --batch-size must be a "
                        "multiple of the device count")
    return p.parse_args(argv)


def _prep_content(path: str, args) -> np.ndarray:
    img = images.get_img(path)
    if args.content_size:
        img = images.resize_to(img, args.content_size)
    if args.crop_size:
        img = images.center_crop(img, args.crop_size)
    return img


def _content_shape(path: str, args) -> tuple[int, int]:
    """Post-prep (H, W) from the image header only (no pixel decode)."""
    from PIL import Image

    with Image.open(path) as im:
        w, h = im.size
    if args.content_size:
        s = args.content_size
        h, w = (s, max(1, round(w * s / h))) if h < w else (max(1, round(h * s / w)), s)
    if args.crop_size:
        return args.crop_size, args.crop_size
    return h, w


def _prep_style(path: str, args, rng, content: np.ndarray | None) -> np.ndarray:
    img = images.get_img(path)
    if args.style_size:
        img = images.resize_to(img, args.style_size)
    if args.random_crop_style:
        img = images.random_crop(img, min(img.shape[:2]), rng)
    if args.coral and content is not None:
        img = colors.coral_numpy(img, content)
    return img


_thumb_cache: dict[tuple, np.ndarray] = {}


def _style_thumb(s_path: str, size: int) -> np.ndarray:
    """Square style thumbnail for ``--concat``, decoded once per (style, size)."""
    key = (s_path, size)
    if key not in _thumb_cache:
        _thumb_cache[key] = images.resize_exact(images.get_img(s_path), size, size)
    return _thumb_cache[key]


def _save_outputs(stylized_batch, contents, names, s_path, args, out_dir):
    """Write each output as ``<content>_<style>.png`` (``interp`` for a blend),
    luminance-only with ``--keep-colors``, the style beside it with ``--concat``."""
    for out, content, name in zip(stylized_batch, contents, names):
        out = np.asarray(out, dtype=np.float32)
        if args.keep_colors:
            out = colors.preserve_colors_np(content, out)
        if args.concat and s_path is not None:
            out = np.concatenate([out, _style_thumb(s_path, out.shape[0])], axis=1)
        s_name = Path(s_path).stem if s_path else "interp"
        out_file = out_dir / f"{name}_{s_name}.png"
        images.save_img(out_file, out)
        print(out_file)


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = common.config_from_args(args)
    params = common.load_params(args)
    out_dir = Path(args.out_path)
    out_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)

    content_files = images.list_images(args.content_path)
    style_files = images.list_images(args.style_path)
    print(f"{len(content_files)} content × {len(style_files)} style images")

    if args.interp_weights is not None:
        if len(args.interp_weights) != len(style_files):
            raise SystemExit(
                f"--interp-weights needs {len(style_files)} weights "
                f"(one per style), got {len(args.interp_weights)}"
            )
        if args.coral:
            raise SystemExit(
                "--coral cannot combine with --interp-weights: CORAL "
                "recolors the style per content image while interpolation "
                "blends one shared style-stat cache"
            )

    stylize_fn = None  # the default: cascade.stylize on one device
    if args.data_parallel:
        mesh = mesh_lib.create_mesh(device=args.device)
        n_dev = len(mesh.devices)
        if args.batch_size % n_dev:
            raise SystemExit(
                f"--data-parallel: --batch-size {args.batch_size} must be "
                f"a multiple of the device count ({n_dev})"
            )
        if args.coral:
            raise SystemExit(
                "--coral processes one pair at a time and cannot shard; "
                "drop --data-parallel or --coral"
            )
        stylize_fn = functools.partial(mesh_lib.stylize_sharded, mesh=mesh)
        print(f"[stylize] data-parallel over {n_dev} devices")

    t_start = time.perf_counter()
    n_out = 0

    if args.coral:
        # CORAL recolours the style for each content image: one pair at a time.
        for c_path in content_files:
            content = _prep_content(c_path, args)
            for s_path in style_files:
                style = _prep_style(s_path, args, rng, content)
                cache = cascade.precompute_style(params["encoder"], style, cfg)
                out = cascade.stylize(params, content[None], cache, args.alpha, cfg)
                _save_outputs(out.cpu().numpy(), [content], [Path(c_path).stem], s_path,
                              args, out_dir)
                n_out += 1
    else:
        # Group by post-prep shape from image headers only; pixels are
        # decoded per chunk.
        groups: dict[tuple, list[str]] = defaultdict(list)
        for c_path in content_files:
            groups[_content_shape(c_path, args)].append(c_path)

        def style_cache(s_path):
            return cascade.precompute_style(
                params["encoder"], _prep_style(s_path, args, rng, None), cfg
            )

        if args.interp_weights is not None:
            caches = [style_cache(s) for s in style_files]
            pairs = [(None, cascade.interpolate_style_caches(caches, args.interp_weights, cfg))]
        else:
            pairs = [(s_path, style_cache(s_path)) for s_path in style_files]

        for s_path, cache in pairs:
            for group in groups.values():
                for i in range(0, len(group), args.batch_size):
                    chunk = group[i : i + args.batch_size]
                    arrs = [_prep_content(p, args) for p in chunk]
                    # One fixed batch shape for every chunk: the microbatch
                    # must not depend on len(group).
                    out = cascade.stylize_microbatched(
                        params, np.stack(arrs), cache, args.alpha, cfg,
                        microbatch=args.batch_size, stylize_fn=stylize_fn,
                    )
                    _save_outputs(out.cpu().numpy(), arrs, [Path(p).stem for p in chunk],
                                  s_path, args, out_dir)
                    n_out += len(chunk)

    dt = time.perf_counter() - t_start
    print(f"{n_out} outputs in {dt:.1f}s ({n_out / max(dt, 1e-9):.2f} img/s)")


if __name__ == "__main__":
    main()
