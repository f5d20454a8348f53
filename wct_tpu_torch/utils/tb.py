"""Optional TensorBoard scalar/image writer.

Counterpart of ``wct_tpu/utils/tb.py``: the training CLI's primary log
is dependency-free JSONL; this writer adds TensorBoard event files when
``torch.utils.tensorboard`` imports (it needs the ``tensorboard``
package) and does nothing otherwise. TensorBoard is never required.
"""

from __future__ import annotations

import os

import numpy as np


class SummaryWriter:
    """``torch.utils.tensorboard.SummaryWriter`` wrapper; a no-op when it
    cannot be imported."""

    def __init__(self, log_dir: str | os.PathLike):
        self._writer = None
        try:
            from torch.utils.tensorboard import SummaryWriter as _Writer  # noqa: PLC0415

            self._writer = _Writer(str(log_dir))
        except Exception:  # noqa: BLE001 — observability must never be fatal
            self._writer = None

    @property
    def active(self) -> bool:
        return self._writer is not None

    def scalars(self, step: int, values: dict[str, float]) -> None:
        if self._writer is None:
            return
        for name, val in values.items():
            self._writer.add_scalar(name, val, step)
        self._writer.flush()

    def images(self, step: int, name: str, imgs) -> None:
        """imgs: [N, H, W, 3] float [0,1]; the first four are written."""
        if self._writer is None:
            return
        self._writer.add_images(name, np.asarray(imgs)[:4], step, dataformats="NHWC")
        self._writer.flush()

    def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
