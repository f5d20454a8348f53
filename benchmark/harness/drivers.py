"""The load generator, read from a traffic file's parameters.

``offline`` is a closed loop of jobs. Each job is ``job_images`` seeded
images drawn from a pool made in set-up, each copied from pinned host
memory to the card, stylized by ``stylize_microbatched`` at ``microbatch``,
quantised to uint8 on the card and copied back. The next job is enqueued
before the previous one's readback is waited on, so at most two are in
flight. After ``seconds`` no job is started; the window ends when the
last one started has come back, so a rate is all the work over all the
time. Set-up runs ``warmup_jobs`` jobs through the same loop.

Every seed runs the same sizes and the same number of images; the seed
draws the pixels and the order in which the pool is sent. The style is
one seeded square image of the configuration's ``style_size`` pixels a
side (512 where the file names none).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch
from torch.profiler import record_function

from harness import inputs, program


@dataclasses.dataclass
class Window:
    seconds: float  # from the first enqueue to the last delivery
    attempted: int
    delivered: int
    enqueue_s: list[float]  # host time to enqueue each job
    samples: list[tuple[int, np.ndarray]]  # (pool index, uint8 output) kept for the check


def style_image(config: dict, seed: int, device) -> np.ndarray:
    """The seed's style image ``[S, S, 3]`` uint8 on the host, ``S`` the
    configuration's ``style_size``."""
    size = int(config.get("style_size", 512))
    return inputs.images(1, size, size, seed, device)[0].cpu().numpy()


def pool_order(n: int, seed: int) -> np.ndarray:
    """The order in which the seed's traffic sends its pool of ``n`` images."""
    return np.random.default_rng([int(seed) & (2**63 - 1), 3]).permutation(n)


class _Reservoir:
    """A sample, drawn from the seed, of the outputs delivered: one
    occurrence of each input, uniform over that input's deliveries, and of
    those inputs ``k`` at random, so the check sees ``k`` different images."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng([int(seed) & (2**63 - 1), 7])
        self.kept: dict[int, tuple[int, np.ndarray]] = {}

    def offer(self, index: int, get):
        seen, out = self.kept.get(index, (0, None))
        seen += 1
        if self.rng.integers(seen) == 0:
            out = get()
        self.kept[index] = (seen, out)

    @property
    def items(self) -> list[tuple[int, np.ndarray]]:
        keys = sorted(self.kept)
        chosen = self.rng.choice(keys, size=min(self.k, len(keys)), replace=False) if keys else []
        return [(int(i), self.kept[int(i)][1]) for i in sorted(chosen)]


class Driver:
    """Set-up shared by every kind of traffic: the program's parameters,
    the style, the pool of content images and their order."""

    def __init__(self, config: dict, traffic: dict, seed: int, device="cuda"):
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.h, self.w = int(traffic["height"]), int(traffic["width"])
        self.alpha = float(config["alpha"])
        self.cfg = program.cascade_config(config)
        self.params = program.load_params(config, self.device)
        self.style = style_image(config, self.seed, self.device)
        pool = inputs.images(int(traffic["pool_images"]), self.h, self.w, self.seed + 1, self.device)
        self.pool = pool.cpu().pin_memory() if self.on_card else pool.cpu()
        self.order = pool_order(len(self.pool), self.seed)
        self.check_images = int(traffic["check_images"])

    def pool_index(self, i: int) -> int:
        return int(self.order[i % len(self.order)])

    def sync(self):
        if self.on_card:
            torch.cuda.synchronize(self.device)

    def free(self):
        """Drop the program's state before the reference runs."""
        for name in ("params", "cache", "pool", "_out"):
            if hasattr(self, name):
                delattr(self, name)
        if self.on_card:
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()


class Offline(Driver):
    def __init__(self, config, traffic, seed, device="cuda"):
        super().__init__(config, traffic, seed, device)
        self.job_images = int(traffic["job_images"])
        self.microbatch = int(traffic["microbatch"])
        self.cache = program.precompute_style(self.params, self.style, self.cfg)
        self.style_stats = program.style_statistics(self.cache)
        shape = (self.job_images, self.h, self.w, 3)
        self._out = [torch.empty(shape, dtype=torch.uint8, pin_memory=self.on_card)
                     for _ in range(2)]
        self.next_job = 0
        self.warmup = self._loop(jobs=int(traffic["warmup_jobs"]))

    def _start(self):
        """Enqueue the next job; return (job number, slot, readback event)."""
        k, slot = self.next_job, self.next_job % 2
        self.next_job += 1
        with record_function("bench.job"):
            x = torch.empty((self.job_images, self.h, self.w, 3), dtype=torch.uint8,
                            device=self.device)
            for j in range(self.job_images):
                x[j].copy_(self.pool[self.pool_index(k * self.job_images + j)], non_blocking=True)
            x = x.float().div_(255.0)
            with record_function("bench.stylize"):
                y = program.stylize_job(self.params, x, self.cache, self.alpha, self.cfg,
                                        self.microbatch)
            q = (y.clamp(0.0, 1.0) * 255.0).to(torch.uint8)
            self._out[slot].copy_(q, non_blocking=True)
            event = None
            if self.on_card:
                event = torch.cuda.Event()
                event.record()
        return k, slot, event

    def _finish(self, job):
        k, slot, event = job
        with record_function("bench.readback"):
            if event is not None:
                event.synchronize()
        return k, slot

    def _loop(self, jobs: int | None = None, seconds: float | None = None,
              sample: _Reservoir | None = None) -> Window:
        """The closed loop, two jobs in flight: ``jobs`` jobs, or as many as
        start within ``seconds``; each delivered output offered to ``sample``."""
        self.sync()
        t0 = time.perf_counter()
        end = t0 + seconds if seconds is not None else None
        inflight: deque = deque()
        enqueue_s: list[float] = []
        started = delivered = 0
        t_last = t0
        while True:
            more = started < jobs if end is None else time.perf_counter() < end
            if more:
                t = time.perf_counter()
                inflight.append(self._start())
                enqueue_s.append(time.perf_counter() - t)
                started += 1
            elif not inflight:
                break
            if len(inflight) >= 2 or (inflight and not more):
                k, slot = self._finish(inflight.popleft())
                t_last = time.perf_counter()
                delivered += self.job_images
                if sample is not None:
                    out = self._out[slot]
                    for j in range(self.job_images):
                        sample.offer(self.pool_index(k * self.job_images + j),
                                     lambda j=j, out=out: out[j].numpy().copy())
        return Window(t_last - t0, started * self.job_images, delivered, enqueue_s,
                      sample.items if sample is not None else [])

    def window(self, seconds: float) -> Window:
        return self._loop(seconds=seconds, sample=_Reservoir(self.check_images, self.seed))

    def traced(self, jobs: int) -> int:
        """``jobs`` jobs in the same closed loop, the card drained before
        and after, inside the ``bench.window`` range. Returns the images
        completed."""
        with record_function("bench.window"):
            w = self._loop(jobs=jobs)
            self.sync()
        return w.delivered


def make(config: dict, traffic: dict, seed: int, device="cuda") -> Offline:
    if traffic["driver"] != "offline":
        raise ValueError(f"no driver {traffic['driver']!r}")
    return Offline(config, traffic, seed, device)
