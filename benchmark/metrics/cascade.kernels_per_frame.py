"""Device ops per image that the cascade launches: the kernels of the
traced window launched under the program's span ``wct.stylize`` (every
``stylize_fn`` call, one per microbatch), copies and memsets
(``Memcpy…``, ``Memset…``) left out, over the images the window
completed. It counts what the card ran, which is the host's launches
as long as each launch is one kernel. None where the program sets no
such span."""

import re

COPIES = re.compile(r"^Mem(cpy|set)")


def read(ctx):
    if ctx.images_traced <= 0:
        return None
    n = sum(1 for o in ctx.trace.ops if "wct.stylize" in o.stack and not COPIES.match(o.name))
    if n == 0:
        return None
    return n / ctx.images_traced
