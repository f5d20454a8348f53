"""Feature-transform ops and the kernels' wrappers.

- ``wct``        — whitening–coloring transform + style-stat cache
- ``sqrtm``      — Newton–Schulz matrix ±sqrt (plain + CUDA kernel)
- ``convs``      — reflect-pad conv, maxpool, NN-upsample primitives
- ``reductions`` — f32 sum reductions of the WCT stage
"""

from wct_tpu_torch.ops import convs, reductions, sqrtm, wct  # noqa: F401

__all__ = ["convs", "reductions", "sqrtm", "wct"]
