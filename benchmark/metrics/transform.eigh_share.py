"""``eigh``'s share of the card's busy time: device time launched under
``aten::linalg_eigh`` (``ops/wct.py``'s matrix powers on the default
route) over the traced window's busy time, in per cent."""


def read(ctx):
    t = ctx.trace
    eigh = t.device_seconds(under="aten::linalg_eigh")
    if eigh <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * eigh / t.busy_s
