"""The cascade's share of the card's peak over the traced window: the
model FLOPs of every image completed in it (``harness/costs.py``: the
3×3 convs of each level's encoder and decoder and each level's
covariance and apply; the matrix square root or eigh is not counted) over
the window and the configuration's arithmetic peak
(``harness/peaks.py``: bf16 at the tensor-core rate, f32 at a third of
TF32's), in per cent."""


def read(ctx):
    t = ctx.trace
    if ctx.images_traced <= 0 or t.window_s <= 0:
        return None
    flops = ctx.costs.frame_flops(ctx.traffic["height"], ctx.traffic["width"],
                                  ctx.config["relu_targets"])
    return 100.0 * flops * ctx.images_traced / t.window_s / ctx.peak
