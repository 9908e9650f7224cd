"""Host ms a flush in the ingest's staging copy: `put_trace`'s
``aten::pin_memory`` ops (the copy into pinned memory within them), from
the profiler's host ops over the traced flushes."""
from portbench.metrics._fleet import traced_flushes


def read(ctx):
    n = traced_flushes(ctx)
    s = ctx.trace.cpu_op_seconds("aten::pin_memory")
    return s * 1e3 / n if n and s > 0 else None
