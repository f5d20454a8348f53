"""The card's idle share of the traced window: 1 − the union of its
kernel, copy and memset intervals over the window, in per cent."""


def read(ctx):
    t = ctx.trace
    if t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
