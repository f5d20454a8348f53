"""Operations and bytes of the cascade's work, from shapes alone.

The model's own count, the same whatever implements it, so a later
change that replaces a kernel or fuses two ops still gets a reading:

- every 3×3 conv of each level's encoder and of its mirrored decoder,
  2·9·Cin·Cout·H·W (the 1×1 preprocessing conv is left out);
- each level's covariance and its C×C apply, 2·C²·N each;
- the matrix square root or ``eigh`` is not counted (its work depends
  on the method, not on the model); ``eigh_work`` is the least an
  eigendecomposition needs, for its roofline.

By this count a 512×512 frame is 0.829 TFLOP, a 1280×720 frame 2.92
and a 2048×2048 image 13.27.

A kernel's roofline work counts each input byte read once and each
output byte written once, whatever the kernel reads again.
"""

from __future__ import annotations

# (name, cin, cout) for convs, ("pool",) for a 2×2 pool; VGG-19 to relu5_1.
ENCODER = (
    ("conv1_1", 3, 64), ("conv1_2", 64, 64), ("pool",),
    ("conv2_1", 64, 128), ("conv2_2", 128, 128), ("pool",),
    ("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256), ("conv3_4", 256, 256),
    ("pool",),
    ("conv4_1", 256, 512), ("conv4_2", 512, 512), ("conv4_3", 512, 512), ("conv4_4", 512, 512),
    ("pool",),
    ("conv5_1", 512, 512),
)
LEVEL_CONV = {"relu1_1": "conv1_1", "relu2_1": "conv2_1", "relu3_1": "conv3_1",
              "relu4_1": "conv4_1", "relu5_1": "conv5_1"}


def conv3x3_flops(cin: int, cout: int, h: int, w: int) -> float:
    return 2.0 * 9 * cin * cout * h * w


def level_shape(level: str, h: int, w: int) -> tuple[int, int]:
    """(channels, pixels) of ``level``'s features for an ``h``×``w`` image."""
    scale, channels = 1, 3
    for layer in ENCODER:
        if layer[0] == "pool":
            scale *= 2
            continue
        channels = layer[2]
        if layer[0] == LEVEL_CONV[level]:
            return channels, (h // scale) * (w // scale)
    raise KeyError(level)


def level_flops(level: str, h: int, w: int) -> float:
    """One level's encoder and decoder convs, covariance and apply."""
    total, scale = 0.0, 1
    for layer in ENCODER:
        if layer[0] == "pool":
            scale *= 2
            continue
        name, cin, cout = layer
        total += 2 * conv3x3_flops(cin, cout, h // scale, w // scale)
        if name == LEVEL_CONV[level]:
            break
    c, n = level_shape(level, h, w)
    return total + 2 * (2.0 * c * c * n)


def frame_flops(h: int, w: int, levels) -> float:
    """The model FLOPs of one ``h``×``w`` frame through ``levels``."""
    return sum(level_flops(level, h, w) for level in levels)


def gram_work(b: int, c: int, n: int, elt: int) -> tuple[float, float]:
    """(FLOPs, bytes) of the centred Gram of ``x [b, c, n]``: the distinct
    entries' products, N·C·(C+1) an image; x read once, the mean and the
    Gram written once in f32."""
    return float(b * n * c * (c + 1)), float(b * (n * c * elt + (c * c + c) * 4))


def junction_work(b: int, h: int, w: int, elt: int, deep: bool = True) -> tuple[float, float]:
    """(FLOPs, bytes) of one junction on the decoder state ``[b, 64, h, w]``
    (half the image's size): the decoder's 64→64 and 64→3 convs and the
    encoder's 3→64 and, when ``deep``, 64→64 convs at full size; the state
    read once, the pooled encoder state (deep) or the relu1_1 map written
    once."""
    px = 4 * h * w
    ops = b * 2.0 * px * 9 * (64 * 64 + 64 * 3 + 3 * 64 + (64 * 64 if deep else 0))
    nbytes = b * 64.0 * (h * w + (h * w if deep else px)) * elt
    return ops, nbytes


def eigh_work(b: int, c: int) -> tuple[float, float]:
    """(FLOPs, bytes) of the symmetric eigendecomposition of ``b`` matrices
    ``[c, c]`` in f32: 9·C³ FLOPs a matrix (Golub and Van Loan's count of
    the symmetric QR algorithm with eigenvectors), whatever method computes
    it; the matrix read once, the eigenvalues and vectors written once."""
    return 9.0 * b * c**3, float(b * (2 * c * c + c) * 4)


def bound_seconds(flops: float, nbytes: float, rate: float, bandwidth: float) -> float:
    """The least time for the work: the larger of FLOPs over the rate and
    bytes over the bandwidth."""
    return max(flops / rate, nbytes / bandwidth)
