"""The junction operation's share of its roofline: the least time the
card could take for the junctions the traced window ran over their
device time, in per cent.

An operation is one junction call of ``ops/junction.py`` on the decoder
state ``[microbatch, 64, H/2, W/2]`` (the cascade's three deep ones per
microbatch), counted by the program's launch counter per operand type.
Its work (``harness/costs.py::junction_work``): the four convs at full
size, the state read once and the pooled state written once; the bound
is the larger of the FLOPs at the type's rate (bf16 one pass at the
tensor-core rate, f32 three TF32 passes) and the bytes at the memory's.
The kernels that make up the operation are named below."""

KERNELS = r"\bjunction_kernel<"


def read(ctx):
    t = ctx.trace
    n = {"bf16": ctx.counts.get("junction_bf16", 0), "f32": ctx.counts.get("junction_f32", 0)}
    device = t.device_seconds(KERNELS)
    if sum(n.values()) == 0 or device <= 0:
        return None
    p, c = ctx.peaks, ctx.costs
    b = int(ctx.traffic["microbatch"])
    h, w = int(ctx.traffic["height"]) // 2, int(ctx.traffic["width"]) // 2
    bound = 0.0
    for dtype, count in n.items():
        elt, rate = (2, p["bf16"]) if dtype == "bf16" else (4, p["tf32"] / 3.0)
        bound += count * c.bound_seconds(*c.junction_work(b, h, w, elt), rate, p["hbm"])
    return 100.0 * bound / device
