"""The transform layer's share of the card's busy time: device time
launched under the program's span ``wct.transform`` (each level's Gram,
its matrix powers by ``eigh``, the plain Newton–Schulz loop or
``ns_sqrtm``, and the apply or the affine; ``models/cascade.py``) over
the traced window's busy time, in per cent. None where the program sets
no such span."""


def read(ctx):
    t = ctx.trace
    transform = t.device_seconds(under="wct.transform")
    if transform <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * transform / t.busy_s
