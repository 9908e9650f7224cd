"""Device ms a flush of host-to-device copies (the chunk's upload), from
the traced window."""
from portbench.metrics._fleet import traced_flushes


def read(ctx):
    n = traced_flushes(ctx)
    s = ctx.trace.seconds(ctx.trace.memcpy("HtoD"))
    return s * 1e3 / n if n and s > 0 else None
