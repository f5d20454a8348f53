"""The convs' share of the card's busy time: device time launched under
``aten::convolution`` (every stock conv of ``ops/convs.py``, cuDNN or
PyTorch's own) over the traced window's busy time, in per cent."""


def read(ctx):
    t = ctx.trace
    conv = t.device_seconds(under="aten::convolution")
    if conv <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * conv / t.busy_s
