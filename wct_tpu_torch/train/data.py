"""Training data: image batches, procedural pools, and device prefetch.

Counterpart of ``wct_tpu/train/data.py``. The generators are numpy and
give the same bits as the JAX package's for the same seed:
``batch_generator`` (random crops of image files, decoded on a thread
pool), ``synthetic_image`` and ``synthetic_image_v2`` (procedural
images), ``rich_pool``, ``synthetic_batches`` and ``synthetic_pool``.
cv2 is imported inside the functions that need it.

Two ways to the device:

- ``device_pool_batches``: a uint8 pool uploaded once; each batch is a
  gather plus a random rot90 and flip, drawn on the device from a
  ``torch.Generator`` seeded by ``(seed, step)``, so a run resumed at
  ``start_step`` sees the batches an uninterrupted run would. (jax.random's
  bits cannot be reproduced here; the distribution is the same.)
- ``DevicePrefetcher``: a worker thread copies numpy batches into pinned
  host buffers and on to the card on a copy stream (``non_blocking``);
  the consumer's stream waits on the copy's event, and a pinned buffer
  is reused only after its copy ended.
"""

from __future__ import annotations

import queue
import threading
from collections.abc import Iterator

import numpy as np
import torch

from wct_tpu_torch.utils import images as img_utils
from wct_tpu_torch.utils.device import resolve_device


def batch_generator(
    paths: list[str],
    batch_size: int,
    crop_size: int = 256,
    seed: int = 0,
    loop: bool = True,
    decode_workers: int = 4,
) -> Iterator[np.ndarray]:
    """Yield ``[B, crop, crop, 3]`` float32 batches of random crops.

    Reference train.py's generator (get_img_random_crop loop) with
    shuffling per epoch. Image decode runs on a ``decode_workers``
    thread pool (PIL releases the GIL). Corrupt/unreadable files are
    skipped with a warning rather than killing a long run.
    """
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(seed)
    if not paths:
        raise ValueError("no training images found")

    def load(args):
        path, crop_seed = args
        try:
            return img_utils.get_img_random_crop(
                path, crop_size, np.random.default_rng(crop_seed)
            )
        except Exception as e:  # noqa: BLE001 — skip bad files
            print(f"[data] skipping {path}: {e}")
            return None

    def bounded_map(pool, jobs, window):
        """Like Executor.map but submits at most ``window`` ahead —
        plain map would eagerly submit (and buffer) the whole epoch."""
        jobs = iter(jobs)
        pending = deque()
        for job in jobs:
            pending.append(pool.submit(load, job))
            if len(pending) >= window:
                break
        while pending:
            done = pending.popleft()
            nxt = next(jobs, None)
            if nxt is not None:
                pending.append(pool.submit(load, nxt))
            yield done.result()

    workers = max(1, decode_workers)
    with ThreadPoolExecutor(max_workers=workers) as pool:
        while True:
            order = rng.permutation(len(paths))
            jobs = [
                (paths[idx], int(rng.integers(0, 2**31))) for idx in order
            ]
            batch: list[np.ndarray] = []
            for img in bounded_map(pool, jobs, window=2 * workers):
                if img is None:
                    continue
                batch.append(img)
                if len(batch) == batch_size:
                    yield np.stack(batch)
                    batch = []
            if not loop:
                if batch:
                    yield np.stack(batch)
                return


def _fractal_noise(
    rng: np.random.Generator, size: int, octaves: int = 5
) -> np.ndarray:
    """Multi-octave value noise ``[size, size, 3]`` roughly in [-1, 1].

    Bilinearly-upsampled random grids at doubling frequencies with 1/f
    amplitude falloff — the classic natural-image power spectrum that a
    plaid background cannot provide.
    """
    import cv2

    out = np.zeros((size, size, 3), np.float32)
    amp = 1.0
    cells = 4
    for _ in range(octaves):
        grid = rng.standard_normal((cells + 1, cells + 1, 3)).astype(np.float32)
        out += amp * cv2.resize(grid, (size, size), interpolation=cv2.INTER_LINEAR)
        amp *= 0.55
        cells = min(cells * 2, size)
    return out / 2.2


def synthetic_image(
    rng: np.random.Generator, size: int, _grids: dict = {}
) -> np.ndarray:
    """One procedural RGB image in [0,1] with natural-image-like variety.

    Decoder training needs feature-space COVERAGE (edges at all
    orientations, flat regions, texture, color gradients) — a pure
    sinusoid plaid exercises only smooth low frequencies and trains
    decoders that cannot reconstruct edges. It composites: a background drawn from
    {plaid, multi-octave fractal noise, smooth two-corner gradient};
    3–8 shapes from {soft ellipse, rectangle, rotated stripe band,
    convex polygon}; occasional checker or oriented-sinusoid texture
    patch; low-amplitude pixel noise.
    """
    if size not in _grids:
        _grids[size] = np.mgrid[0:size, 0:size].astype(np.float32) / size
    yy, xx = _grids[size]

    bg = rng.random()
    if bg < 0.4:  # plaid (the v1 background)
        f = rng.uniform(1, 10, size=(2, 3)).astype(np.float32)
        ph = rng.uniform(0, 6.28, size=(2, 3)).astype(np.float32)
        img = 0.5 + 0.18 * (
            np.sin(f[0] * 6.28 * yy[:, :, None] + ph[0])
            + np.sin(f[1] * 6.28 * xx[:, :, None] + ph[1])
        )
    elif bg < 0.75:  # fractal value noise around a random base color
        base = rng.uniform(0.25, 0.75, 3).astype(np.float32)
        img = base + rng.uniform(0.1, 0.3) * _fractal_noise(rng, size)
    else:  # smooth bilinear gradient between four corner colors
        corners = rng.uniform(0, 1, (2, 2, 3)).astype(np.float32)
        img = (
            corners[0, 0] * ((1 - yy) * (1 - xx))[:, :, None]
            + corners[0, 1] * ((1 - yy) * xx)[:, :, None]
            + corners[1, 0] * (yy * (1 - xx))[:, :, None]
            + corners[1, 1] * (yy * xx)[:, :, None]
        )
    # linear color gradient (global illumination variety)
    g = rng.uniform(-0.3, 0.3, size=(2, 3)).astype(np.float32)
    img += g[0] * (yy[:, :, None] - 0.5) + g[1] * (xx[:, :, None] - 0.5)

    for _ in range(rng.integers(3, 9)):
        cy, cx = rng.uniform(0.1, 0.9, 2)
        ry, rx = rng.uniform(0.05, 0.35, 2)
        color = rng.uniform(0, 1, 3).astype(np.float32)
        kind = rng.random()
        if kind < 0.35:  # soft-edged ellipse
            d = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2
            mask = np.clip((1.0 - d) * rng.uniform(4, 40), 0.0, 1.0)
        elif kind < 0.65:  # soft-edged rectangle
            sharp = rng.uniform(20, 200)
            mask = (
                np.clip((ry - np.abs(yy - cy)) * sharp, 0, 1)
                * np.clip((rx - np.abs(xx - cx)) * sharp, 0, 1)
            )
        elif kind < 0.82:  # rotated stripe band (edges at any orientation)
            th = rng.uniform(0, np.pi)
            proj = np.cos(th) * (xx - cx) + np.sin(th) * (yy - cy)
            freq = rng.uniform(3, 25)
            duty = rng.uniform(-0.5, 0.5)
            stripes = np.clip(
                (np.sin(freq * 6.2832 * proj) - duty) * rng.uniform(5, 60), 0, 1
            )
            extent = np.clip((ry * 1.5 - np.abs(proj)) * 20, 0, 1)
            mask = stripes * extent
        else:  # convex polygon: intersection of 3–5 soft half-planes
            mask = np.ones_like(yy)
            sharp = rng.uniform(30, 250)
            for th in np.sort(rng.uniform(0, 2 * np.pi, int(rng.integers(3, 6)))):
                d = (
                    np.cos(th) * (xx - cx) + np.sin(th) * (yy - cy)
                    - rng.uniform(0.05, 0.3)
                )
                mask = mask * np.clip(-d * sharp, 0, 1)
        alpha = mask[:, :, None] * rng.uniform(0.5, 1.0)
        img = img * (1 - alpha) + color * alpha

    tex = rng.random()
    if tex < 0.3:  # high-frequency checker patch
        k = int(rng.integers(2, 8))
        checker = ((yy * size // k).astype(int) + (xx * size // k).astype(int)) % 2
        cy, cx = rng.uniform(0.2, 0.8, 2)
        r = rng.uniform(0.1, 0.3)
        inside = ((yy - cy) ** 2 + (xx - cx) ** 2) < r * r
        amp = rng.uniform(0.2, 0.5)
        img += (inside * checker * amp - inside * amp / 2)[:, :, None]
    elif tex < 0.5:  # oriented sinusoid texture patch
        th = rng.uniform(0, np.pi)
        freq = rng.uniform(10, 60)
        cy, cx = rng.uniform(0.2, 0.8, 2)
        r = rng.uniform(0.1, 0.35)
        inside = np.clip((r * r - ((yy - cy) ** 2 + (xx - cx) ** 2)) * 200, 0, 1)
        wave = np.sin(freq * 6.2832 * (np.cos(th) * xx + np.sin(th) * yy))
        img += (inside * wave * rng.uniform(0.1, 0.3))[:, :, None]

    img += rng.normal(0, 0.01, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def train_photo_paths() -> list:
    """Real photographs bundled with the environment that are LEGAL for
    training: the held-out real-photo eval (scripts/eval_bundle.py)
    scores the α=0 cascade on matplotlib's grace_hopper.jpg, so that
    file is excluded here; sklearn's china/flower (used only as style
    images at eval, which the α=0 reconstruction metric never touches)
    provide the only genuinely natural training statistics available
    offline.
    """
    import site
    from pathlib import Path

    out = []
    for cand in (
        "sklearn/datasets/images/china.jpg",
        "sklearn/datasets/images/flower.jpg",
    ):
        for sp in site.getsitepackages():
            f = Path(sp) / cand
            if f.exists():
                out.append(f)
                break
    return out


def _load_photos(size_hint: int = 512) -> list:
    """Decode the training photos once (module cache), shorter side ≥ hint."""
    global _PHOTO_CACHE
    try:
        return _PHOTO_CACHE
    except NameError:
        pass
    photos = []
    for p in train_photo_paths():
        try:
            img = img_utils.get_img(p)  # float [0,1] RGB
            photos.append(np.ascontiguousarray(img))
        except Exception as e:  # noqa: BLE001
            print(f"[data] skipping photo {p}: {e}")
    _PHOTO_CACHE = photos
    return photos


def synthetic_image_v2(
    rng: np.random.Generator, size: int, photos: list | None = None
) -> np.ndarray:
    """The second pool recipe: v1 composites + natural-statistics variants.

    v2 keeps the v1 generator (``synthetic_image``, so its distribution
    stays a subset) and adds, with equal probability:

    - photo-patch mosaics: random rescaled crops of the bundled
      training photographs (``train_photo_paths`` — the real-photo eval
      content is EXCLUDED) blended over a v1 background with random
      per-patch color jitter/flips — real second-order statistics,
      edges-with-texture, and true camera grain;
    - warped fractal fields: multi-octave value noise sampled through a
      noise-displaced coordinate grid (cv2.remap) — the curved,
      non-axis-aligned structure photographs have and plaids do not;
    - defocus composites: a v1 composite with a depth-of-field split —
      one soft-masked region Gaussian-blurred — plus global gamma,
      vignette, and sensor-noise finishing.
    """
    import cv2

    if photos is None:
        photos = _load_photos()
    kind = rng.random()
    if kind < 0.4 or not photos:  # v1 recipe
        img = synthetic_image(rng, size)
        if kind >= 0.4:
            kind = 0.41  # photo path unavailable → treat as defocus base
    if kind < 0.4 and rng.random() < 0.5:
        return img  # pure v1, no finishing (keeps the exact v1 subset)
    if 0.4 <= kind < 0.7 and photos:
        # photo-patch mosaic over a v1 background
        img = synthetic_image(rng, size)
        for _ in range(int(rng.integers(2, 6))):
            ph = photos[int(rng.integers(0, len(photos)))]
            h, w = ph.shape[:2]
            # crop size in source pixels; rescaled to target patch size
            ps = int(rng.integers(size // 4, size))
            ss = int(rng.integers(min(64, h // 2, w // 2), min(h, w)))
            y0 = int(rng.integers(0, h - ss + 1))
            x0 = int(rng.integers(0, w - ss + 1))
            patch = cv2.resize(ph[y0 : y0 + ss, x0 : x0 + ss], (ps, ps),
                               interpolation=cv2.INTER_AREA)
            if rng.random() < 0.5:
                patch = patch[:, ::-1]
            if rng.random() < 0.25:
                patch = np.rot90(patch, int(rng.integers(1, 4)))
                ps = patch.shape[0]
            # per-patch color jitter: channel gains + brightness shift
            gain = rng.uniform(0.6, 1.3, 3).astype(np.float32)
            patch = np.clip(patch * gain + rng.uniform(-0.15, 0.15), 0, 1)
            ty = int(rng.integers(-ps // 3, size - 2 * ps // 3))
            tx = int(rng.integers(-ps // 3, size - 2 * ps // 3))
            sy, sx = max(ty, 0), max(tx, 0)
            ey, ex = min(ty + ps, size), min(tx + ps, size)
            if ey <= sy or ex <= sx:
                continue
            pview = patch[sy - ty : ey - ty, sx - tx : ex - tx]
            # soft-edged alpha so patch borders don't dominate gradients
            yy = np.linspace(0, 1, pview.shape[0], dtype=np.float32)
            xx = np.linspace(0, 1, pview.shape[1], dtype=np.float32)
            edge = rng.uniform(6, 30)
            ay = np.clip(np.minimum(yy, 1 - yy) * edge, 0, 1)
            ax = np.clip(np.minimum(xx, 1 - xx) * edge, 0, 1)
            a = (ay[:, None] * ax[None, :] * rng.uniform(0.7, 1.0))[..., None]
            img[sy:ey, sx:ex] = img[sy:ey, sx:ex] * (1 - a) + pview * a
    elif 0.7 <= kind:
        # warped fractal field: sample noise through displaced coords
        base = 0.5 + 0.5 * _fractal_noise(rng, size, octaves=6)
        amp = rng.uniform(0.02, 0.12) * size
        dy = _fractal_noise(rng, size, octaves=3)[:, :, 0] * amp
        dx = _fractal_noise(rng, size, octaves=3)[:, :, 1] * amp
        gy, gx = np.mgrid[0:size, 0:size].astype(np.float32)
        img = cv2.remap(
            base.astype(np.float32),
            np.clip(gx + dx, 0, size - 1), np.clip(gy + dy, 0, size - 1),
            interpolation=cv2.INTER_LINEAR,
        )
        tint = rng.uniform(0.4, 1.0, 3).astype(np.float32)
        img = np.clip(img * tint + rng.uniform(0, 0.25, 3), 0, 1)
    # (0.4 <= kind < 0.7 without photos falls through with the v1 img)

    # defocus split: blur one soft region (depth-of-field statistics)
    if rng.random() < 0.4:
        k = int(rng.integers(2, 7)) * 2 + 1
        blurred = cv2.GaussianBlur(img, (k, k), 0)
        cy, cx = rng.uniform(0, 1, 2)
        r = rng.uniform(0.3, 0.8)
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
        d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
        m = np.clip((d - r) * rng.uniform(3, 10) + 0.5, 0, 1)[..., None]
        img = img * (1 - m) + blurred * m
    # global finishing: gamma, vignette, sensor noise
    if rng.random() < 0.5:
        img = np.clip(img, 0, 1) ** rng.uniform(0.7, 1.4)
    if rng.random() < 0.3:
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32) / size
        v = 1.0 - rng.uniform(0.1, 0.4) * (
            (yy - 0.5) ** 2 + (xx - 0.5) ** 2
        ) * 4
        img = img * v[..., None]
    img = img + rng.normal(0, rng.uniform(0.002, 0.015), img.shape)
    return np.clip(img, 0.0, 1.0).astype(np.float32)


def rich_pool(
    pool_size: int, crop_size: int, seed: int = 0, verbose: bool = False
) -> np.ndarray:
    """``pool_size`` v2 images as one uint8 array (16384 images at 256 px
    are 3.2 GB)."""
    rng = np.random.default_rng(seed)
    photos = _load_photos()
    out = np.empty((pool_size, crop_size, crop_size, 3), np.uint8)
    for i in range(pool_size):
        out[i] = (synthetic_image_v2(rng, crop_size, photos) * 255).astype(
            np.uint8
        )
        if verbose and (i + 1) % 2048 == 0:
            print(f"[data] pool {i + 1}/{pool_size}", flush=True)
    return out


def synthetic_batches(
    batch_size: int, crop_size: int = 256, seed: int = 0,
    pool_size: int = 0,
) -> Iterator[np.ndarray]:
    """Procedural image batches — decoder training / smoke runs without
    a dataset (MS-COCO is not shippable with the repo). See
    ``synthetic_image`` for the composition.

    ``pool_size > 0`` pre-generates that many images once (stored
    uint8) and yields batches sampled from the pool with random
    flip/rotate augmentation: a fresh image costs milliseconds of one
    host core, pool sampling a memcpy. This also mirrors the
    reference's finite-dataset + random-crop regime (train.py:~80).
    """
    rng = np.random.default_rng(seed)
    if pool_size <= 0:
        while True:
            yield np.stack(
                [synthetic_image(rng, crop_size) for _ in range(batch_size)]
            )
    pool = synthetic_pool(rng, pool_size, crop_size)
    while True:
        idx = rng.integers(0, pool_size, batch_size)
        # Stay uint8 end to end: augmentation on 1-byte pixels and a
        # uint8 host-to-device copy, 4× fewer bytes than f32;
        # reconstruction_loss divides by 255 on the device.
        batch = pool[idx]
        out = np.empty_like(batch)
        for i in range(batch_size):
            img = batch[i]
            k = rng.integers(0, 4)
            if k:
                img = np.rot90(img, k)
            if rng.random() < 0.5:
                img = img[:, ::-1]
            out[i] = img
        yield out


def synthetic_pool(
    rng: np.random.Generator, pool_size: int, crop_size: int
) -> np.ndarray:
    """Pre-generate ``pool_size`` procedural images as one uint8 array."""
    return np.stack(
        [
            (synthetic_image(rng, crop_size) * 255).astype(np.uint8)
            for _ in range(pool_size)
        ]
    )


# The eight rot90/flip variants, in the order (rotation k, flip): out of
# variant 2k + f at (i, j) reads the source at _VARIANT_SRC[2k + f](i, j)
# of an n × n image (np.rot90(x, k), then x[:, ::-1] when f).
def _variant_index(n: int, device: torch.device) -> torch.Tensor:
    """``[8, n·n]`` flat source indices of the eight variants."""
    i = torch.arange(n, device=device)[:, None].expand(n, n)
    j = torch.arange(n, device=device)[None, :].expand(n, n)
    m = n - 1
    rots = [(i, j), (j, m - i), (m - i, m - j), (m - j, i)]  # np.rot90 k = 0..3
    out = []
    for si, sj in rots:
        out.append(si * n + sj)
        # then x[:, ::-1]: column j reads the rotated column m - j
        out.append(si.flip(1) * n + sj.flip(1))
    return torch.stack(out).reshape(8, n * n)


def _step_seed(seed: int, step: int) -> int:
    return ((seed & 0xFFFFFFFF) << 32) | (step & 0xFFFFFFFF)


def make_pool_sampler(batch_size: int):
    """On-device batch sampler over a device-resident ``[N, n, n, 3]`` pool.

    ``sample(pool, seed, step) -> uint8 [B, n, n, 3]``: ``batch_size``
    random pool entries, each in one of its eight rot90/flip variants,
    all drawn from a generator on the pool's device seeded by
    ``(seed, step)``. Nothing is read back to the host.
    """
    cache: dict = {}

    def sample(pool: torch.Tensor, seed: int, step: int) -> torch.Tensor:
        n_pool, h, w, c = pool.shape
        if h != w:
            raise ValueError(f"pool images must be square for rot90, got {h}×{w}")
        key = (h, pool.device)
        if key not in cache:
            cache[key] = _variant_index(h, pool.device)
        gen = torch.Generator(device=pool.device)
        gen.manual_seed(_step_seed(seed, step))
        idx = torch.randint(0, n_pool, (batch_size,), generator=gen, device=pool.device)
        variant = torch.randint(0, 8, (batch_size,), generator=gen, device=pool.device)
        src = cache[key][variant]  # [B, n·n]
        flat = pool[idx].reshape(batch_size, h * w, c)
        out = torch.gather(flat, 1, src[:, :, None].expand(batch_size, h * w, c))
        return out.reshape(batch_size, h, w, c)

    return sample


def device_pool_batches(
    pool_np: np.ndarray, batch_size: int, seed: int = 0, start_step: int = 0,
    device: str | torch.device = "cuda",
) -> Iterator[torch.Tensor]:
    """Yield uint8 batches sampled on ``device`` from a pool uploaded once.

    Batch ``s`` depends on ``(seed, s)`` only, so a run resumed at
    ``start_step`` continues the stream of an uninterrupted run.
    """
    pool = torch.from_numpy(np.ascontiguousarray(pool_np)).to(resolve_device(device))
    sample = make_pool_sampler(batch_size)
    step = start_step
    while True:
        yield sample(pool, seed, step)
        step += 1


class DevicePrefetcher:
    """Overlap host batch production and the host→device copy with compute.

    One worker thread pulls numpy batches from ``it``, copies each into a
    pinned host buffer and on to ``device`` on a copy stream, and queues
    it; ``depth`` bounds the queue. ``__next__`` makes the current stream
    wait on that copy's event, so the consumer never blocks the host on
    it. The worker reuses a pinned buffer only after its copy ended. On
    the CPU the batches are the numpy arrays as tensors.

    Producer errors are raised to the consumer, and after exhaustion or
    an error ``__next__`` keeps raising (it never blocks on an empty queue).
    """

    _END = object()

    def __init__(self, it: Iterator[np.ndarray], depth: int = 2,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._error: BaseException | None = None
        self._finished = False
        on_card = self.device.type == "cuda"
        self._copy_stream = torch.cuda.Stream(self.device) if on_card else None
        # depth queued, one being filled: a buffer's copy has ended by the
        # time its turn comes again, and the worker checks that it has.
        self._slots = depth + 1
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _to_device(self, batch: np.ndarray, ring: list, i: int):
        if self._copy_stream is None:
            return torch.from_numpy(np.array(batch)), None
        src = torch.from_numpy(np.ascontiguousarray(batch))
        slot = ring[i % self._slots]
        if slot is not None and slot[0].shape == src.shape and slot[0].dtype == src.dtype:
            host, done = slot
            done.synchronize()  # this buffer's previous copy has ended
        else:
            host = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        host.copy_(src)
        done = torch.cuda.Event()
        with torch.cuda.stream(self._copy_stream):
            out = host.to(self.device, non_blocking=True)
            done.record(self._copy_stream)
        ring[i % self._slots] = (host, done)
        return out, done

    def _run(self):
        ring: list = [None] * self._slots
        try:
            for i, batch in enumerate(self._it):
                self._q.put(self._to_device(batch, ring, i))
        except BaseException as e:  # noqa: BLE001 — re-raised in __next__
            self._error = e
        finally:
            self._q.put(self._END)

    def __iter__(self):
        return self

    def __next__(self) -> torch.Tensor:
        if self._finished:
            if self._error is not None:
                raise self._error
            raise StopIteration
        item = self._q.get()
        if item is self._END:
            self._finished = True
            if self._error is not None:
                # A producer failure fails the consumer: a run whose data
                # vanished must not look like a clean end of data.
                raise self._error
            raise StopIteration
        out, copied = item
        if copied is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(copied)
            out.record_stream(stream)
        return out
