"""The eigendecomposition's share of the card's busy time: device time
launched under the program's span ``wct.op.eigh`` (``ops/eigh.py``: the
eigh kernel on the card, inside ``wct.op.sqrt``) over the traced window's
busy time, in per cent. None where the program sets no such span."""


def read(ctx):
    t = ctx.trace
    eigh = t.device_seconds(under="wct.op.eigh")
    if eigh <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * eigh / t.busy_s
