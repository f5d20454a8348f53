"""The centred Gram operation's share of its roofline: the least time the
card could take for the Grams the traced window ran over their device
time, in per cent.

An operation is one ``ops/gram.py`` call on a level's features
``[microbatch, C, N]``; the cascade makes one per level per microbatch
(the program's launch counter counts them). Its work
(``harness/costs.py::gram_work``): the distinct entries' products, the
features read once, the mean and the Gram written once in f32. The bound
is the larger of the FLOPs at the features' rate and the bytes at the
memory's: bf16 features in one bf16 pass (a bf16 product is exact in an
f32 sum), f32 ones in three TF32 passes. The kernels that make up the
operation (its mean pass and its Gram pass) are named below."""

KERNELS = r"\bmean_kernel<|\bgram_kernel<"


def read(ctx):
    t = ctx.trace
    n = ctx.counts.get("centered_gram", 0)
    levels = ctx.config["relu_targets"]
    device = t.device_seconds(KERNELS)
    if n == 0 or n % len(levels) or device <= 0:
        return None
    p, c = ctx.peaks, ctx.costs
    bf16 = ctx.config["precision"] == "bfloat16"
    elt, rate = (2, p["bf16"]) if bf16 else (4, p["tf32"] / 3.0)
    b = int(ctx.traffic["microbatch"])
    h, w = int(ctx.traffic["height"]), int(ctx.traffic["width"])
    per_batch = sum(c.bound_seconds(*c.gram_work(b, *c.level_shape(lv, h, w), elt), rate, p["hbm"])
                    for lv in levels)
    return 100.0 * per_batch * (n // len(levels)) / device
