"""The eigendecomposition's share of its roofline: the least time the card
could take for the eigendecompositions the traced window ran over the
device time under the program's span ``wct.op.eigh``, in per cent.

A call is one launch of ``ops/eigh.py``'s kernel (its launch counter,
declared below) on the content covariances of one microbatch at one
level, ``[microbatch, C, C]``; the cascade makes one per level per
microbatch. Its work (``harness/costs.py::eigh_work``): 9·C³ FLOPs a
matrix at the f32 rate outside the tensor cores (``fp32``, what the
kernel's arithmetic runs on), whatever method computes it, or the bytes
at the memory's rate where that is larger. None where the counter does
not resolve, counts no calls, or the span carries no device time."""

COUNTERS = {"eigh": "ops.eigh.eigh_cuda.launches"}


def read(ctx):
    t = ctx.trace
    n = ctx.counts.get("eigh", 0)
    levels = ctx.config["relu_targets"]
    device = t.device_seconds(under="wct.op.eigh")
    if not n or n % len(levels) or device <= 0:
        return None
    p, c = ctx.peaks, ctx.costs
    b = int(ctx.traffic["microbatch"])
    h, w = int(ctx.traffic["height"]), int(ctx.traffic["width"])
    per_batch = sum(c.bound_seconds(*c.eigh_work(b, c.level_shape(lv, h, w)[0]), p["fp32"], p["hbm"])
                    for lv in levels)
    return 100.0 * per_batch * (n // len(levels)) / device
