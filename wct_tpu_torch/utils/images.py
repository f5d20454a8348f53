"""Host-side image IO: load, save, resize, crop, file listing.

A copy of the helpers of ``wct_tpu/utils/images.py`` that the port
uses (importing that module would load JAX through ``wct_tpu``).
Images are float32 RGB ``[H, W, 3]`` numpy arrays in [0, 1].
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np
from PIL import Image, ImageOps

IMG_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp", ".tiff")


def get_files(img_dir: str | os.PathLike) -> list[str]:
    """Sorted image paths under ``img_dir``."""
    p = Path(img_dir)
    return sorted(
        str(f) for f in p.iterdir() if f.suffix.lower() in IMG_EXTS
    )


def list_images(path: str | os.PathLike) -> list[str]:
    """``path`` as an image list: a directory's images, or [path] itself."""
    return get_files(path) if os.path.isdir(path) else [str(path)]


def get_img(path: str | os.PathLike) -> np.ndarray:
    """Load to float32 RGB in [0, 1], ``[H, W, 3]``, honouring EXIF orientation."""
    img = Image.open(path)
    img = ImageOps.exif_transpose(img).convert("RGB")
    return np.asarray(img, dtype=np.float32) / 255.0


def save_img(path: str | os.PathLike, img: np.ndarray) -> None:
    """Save float [0,1] RGB ``[H, W, 3]`` as 8-bit."""
    arr = np.clip(np.asarray(img), 0.0, 1.0)
    Image.fromarray((arr * 255.0 + 0.5).astype(np.uint8)).save(path)


def resize_to(img: np.ndarray, size: int) -> np.ndarray:
    """Resize so the shorter side equals ``size``."""
    h, w = img.shape[:2]
    if h < w:
        new_h, new_w = size, max(1, round(w * size / h))
    else:
        new_h, new_w = max(1, round(h * size / w)), size
    return _resize(img, new_h, new_w)


def resize_exact(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Resize to exactly ``[h, w]``."""
    return _resize(img, h, w)


def _resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    pil = Image.fromarray((np.clip(img, 0, 1) * 255.0 + 0.5).astype(np.uint8))
    out = pil.resize((w, h), Image.BILINEAR)
    return np.asarray(out, dtype=np.float32) / 255.0


def center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """Center crop to size×size, resizing up first if needed."""
    h, w = img.shape[:2]
    if min(h, w) < size:
        img = resize_to(img, size)
        h, w = img.shape[:2]
    top, left = (h - size) // 2, (w - size) // 2
    return img[top : top + size, left : left + size]


def random_crop(img: np.ndarray, size: int, rng: np.random.Generator) -> np.ndarray:
    """Random size×size crop, resizing up first if needed."""
    h, w = img.shape[:2]
    if min(h, w) < size:
        img = resize_to(img, size)
        h, w = img.shape[:2]
    top = int(rng.integers(0, h - size + 1))
    left = int(rng.integers(0, w - size + 1))
    return img[top : top + size, left : left + size]


def get_img_random_crop(
    path: str | os.PathLike, size: int = 256, rng: np.random.Generator | None = None
) -> np.ndarray:
    """Load, resize up if needed, and crop a random size×size square."""
    rng = rng or np.random.default_rng()
    return random_crop(get_img(path), size, rng)
