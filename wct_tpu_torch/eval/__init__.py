"""The stylization-quality protocol (``wct_tpu/eval``), in the port.

Two independent legs:

- ``eval.texture`` — pixel-space texture statistics (radial FFT
  spectrum, colour quantile EMD, multi-scale local contrast), numpy
  only;
- ``eval.frozen`` — Gram and mean/std distances under a pinned-seed,
  never-trained CReLU-orthogonal evaluator encoder, run on the port's
  encoder.
"""

from wct_tpu_torch.eval import frozen, texture  # noqa: F401

__all__ = ["texture", "frozen"]
