"""Feature-transform ops and the kernels' wrappers.

- ``wct``        — whitening–coloring transform + style-stat cache
- ``sqrtm``      — Newton–Schulz matrix ±sqrt (plain + CUDA kernel)
- ``junction``   — fused encoder head, decoder tail and level junction
                   (plain + CUDA kernels)
- ``convs``      — reflect-pad conv, maxpool, NN-upsample primitives,
                   the ring, per-image and int8 convs
- ``pack2``      — image-pair channel packing of the 64-channel tier
- ``reductions`` — f32 sum reductions of the WCT stage
"""

from wct_tpu_torch.ops import convs, junction, reductions, sqrtm, wct  # noqa: F401

__all__ = ["convs", "junction", "reductions", "sqrtm", "wct"]
