"""The host's time in the cascade per image: the total host time of the
program's span ``wct.stylize`` (``utils.profiling.span_totals()``, which
sums only stretches run under the profiler, here the traced segment)
over the images that segment completed, in ms.

It is taken with the profiler on, so it holds the profiler's own cost
per op and per range. The same quantity without the profiler is the
untraced window's enqueue time, the ``enqueue_ms`` line that
``run.py`` prints (per job of ``job_images`` images, a little more than
the cascade). None where the program keeps no span summary."""


def read(ctx):
    from wct_tpu_torch.utils import profiling

    totals = getattr(profiling, "span_totals", None)
    if totals is None or ctx.images_traced <= 0:
        return None
    row = totals().get("wct.stylize")
    if not row or row["total_ns"] <= 0:
        return None
    return row["total_ns"] * 1e-6 / ctx.images_traced
