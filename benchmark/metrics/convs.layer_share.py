"""The conv layer's share of the card's busy time: device time launched
under the program's span ``wct.op.conv`` (one per conv of
``ops/convs.py``: its reflect pad, weight casts, the conv and its bias;
the ReLU after it is the caller's) over the traced window's busy time,
in per cent. Unlike ``convs.device_share``, which reads
``aten::convolution``, it counts the pads and casts around the conv.
None where the program sets no such span."""


def read(ctx):
    t = ctx.trace
    conv = t.device_seconds(under="wct.op.conv")
    if conv <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * conv / t.busy_s
