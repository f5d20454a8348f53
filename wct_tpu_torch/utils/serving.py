"""Shape-bucketed serving: images of any size, a bounded set of shapes.

Counterpart of ``wct_tpu/utils/serving.py``. PyTorch compiles nothing
per shape, but the port does pay once for each new conv shape on the
card: ``ops/convs.py::conv_by_shape`` times cuDNN against PyTorch's own
conv the first time it meets a shape key and records the choice in
``convs._CUDNN_OK`` (a few synchronising timed runs per conv of the
cascade). ``BucketedStylizer`` reflect-pads each image's H and W up to
the next multiple of ``granularity``, stylizes at the bucketed shape
and crops the output back, so every input size is served exactly and
that per-shape work happens at most once per bucket:
(maxH/granularity)·(maxW/granularity) buckets in all. Buckets of a
multiple of 16 also keep the ``fuse_junction`` routes on their kernels.

The padded border takes part in the content Gram like any reflected
border pixel of the reflect-padded convs; its effect on the global
statistics is proportional to the padded fraction (< granularity/size).
"""

from __future__ import annotations

import numpy as np
import torch

from wct_tpu_torch.models import cascade
from wct_tpu_torch.utils.device import params_device


def bucket_shape(h: int, w: int, granularity: int = 128) -> tuple[int, int]:
    """Smallest (H, W) multiple of ``granularity`` covering (h, w)."""
    up = lambda v: -(-v // granularity) * granularity  # noqa: E731
    return up(h), up(w)


def pad_to_bucket(
    img: np.ndarray, granularity: int = 128
) -> tuple[np.ndarray, tuple[int, int]]:
    """Reflect-pad ``[H, W, 3]`` to its bucket; returns (padded, (h, w))."""
    h, w = img.shape[:2]
    bh, bw = bucket_shape(h, w, granularity)
    if (bh, bw) == (h, w):
        return img, (h, w)
    # np.pad reflect needs pad < dim; tiny images fall back to edge.
    mode = "reflect" if (bh - h < h and bw - w < w) else "edge"
    return np.pad(img, ((0, bh - h), (0, bw - w), (0, 0)), mode=mode), (h, w)


class BucketedStylizer:
    """Serve single images of any size through bucketed shapes, on the
    device the parameters live on."""

    def __init__(
        self,
        params: dict,
        cfg: cascade.CascadeConfig,
        granularity: int = 128,
    ):
        self.params = params
        self.cfg = cfg
        self.granularity = granularity
        self._cache: cascade.StyleCache | None = None

    def set_style(self, style_img: np.ndarray) -> None:
        self._cache = cascade.precompute_style(
            self.params["encoder"], np.asarray(style_img, np.float32), self.cfg
        )

    def stylize(self, img: np.ndarray, alpha: float = 1.0) -> np.ndarray:
        """Stylize one [H, W, 3] image of ANY size; output size == input."""
        if self._cache is None:
            raise RuntimeError("no style set")
        padded, (h, w) = pad_to_bucket(np.asarray(img, np.float32), self.granularity)
        x = torch.from_numpy(np.ascontiguousarray(padded)).to(params_device(self.params))
        out = cascade.stylize(self.params, x[None], self._cache, alpha, self.cfg)
        return out[0, :h, :w, :].cpu().numpy()
