"""Batch stylization CLI, the port of ``wct_tpu/cli/stylize.py``.

    python -m wct_tpu_torch.cli.stylize --weights weights/bundle.npz \
        --content-path c.jpg --style-path styles/ --out-path out/ \
        --alpha 0.8 --content-size 512 --method newton_schulz_pallas
    python -m wct_tpu_torch.cli.stylize --weights weights/bundle.npz \
        --content-path c.jpg --style-path s.jpg --out-path out/ \
        --preset throughput

Content × style cartesian product (file or directory each). Each
style's statistics are computed once and reused for every content
image; same-shape content images are batched (``--batch-size``) and
served through ``stylize_microbatched``, so an output does not depend
on how many same-shape files were in the run. Runs on ``--device``
(default cuda).
"""

from __future__ import annotations

import argparse
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

from wct_tpu_torch.cli import common
from wct_tpu_torch.models import cascade
from wct_tpu_torch.utils import images


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


def _prep_style(path: str, args) -> np.ndarray:
    img = images.get_img(path)
    if args.style_size:
        img = images.resize_to(img, args.style_size)
    return img


def main(argv=None) -> None:
    args = parse_args(argv)
    cfg = common.config_from_args(args)
    params = common.load_params(args)
    out_dir = Path(args.out_path)
    out_dir.mkdir(parents=True, exist_ok=True)

    content_files = images.list_images(args.content_path)
    style_files = images.list_images(args.style_path)
    print(f"{len(content_files)} content × {len(style_files)} style images")

    t_start = time.perf_counter()
    n_out = 0
    # Group by post-prep shape from image headers only; pixels are
    # decoded per chunk.
    groups: dict[tuple, list[str]] = defaultdict(list)
    for c_path in content_files:
        groups[_content_shape(c_path, args)].append(c_path)

    for s_path in style_files:
        cache = cascade.precompute_style(
            params["encoder"], _prep_style(s_path, args), cfg
        )
        for group in groups.values():
            for i in range(0, len(group), args.batch_size):
                chunk = group[i : i + args.batch_size]
                arrs = [_prep_content(p, args) for p in chunk]
                # One fixed batch shape for every chunk: the microbatch
                # must not depend on len(group).
                out = cascade.stylize_microbatched(
                    params, np.stack(arrs), cache, args.alpha, cfg,
                    microbatch=args.batch_size,
                )
                out = out.cpu().numpy()
                for img, c_path in zip(out, chunk):
                    out_file = out_dir / f"{Path(c_path).stem}_{Path(s_path).stem}.png"
                    images.save_img(out_file, img)
                    print(out_file)
                n_out += len(chunk)

    dt = time.perf_counter() - t_start
    print(f"{n_out} outputs in {dt:.1f}s ({n_out / max(dt, 1e-9):.2f} img/s)")


if __name__ == "__main__":
    main()
