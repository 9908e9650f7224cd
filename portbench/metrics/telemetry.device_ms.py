"""Device ms a flush of every kernel but `fleet_step`: the ring roll and
exact sums before and after it, the layout copies, and the flush record's
reductions (the sort, percentiles and sums), from the traced window."""
from portbench.metrics._fleet import traced_flushes


def read(ctx):
    n = traced_flushes(ctx)
    ks = [e for e in ctx.trace.kernels() if "fleet_step" not in e["name"]]
    s = ctx.trace.seconds(ks)
    return s * 1e3 / n if n and s > 0 else None
