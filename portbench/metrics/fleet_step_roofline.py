"""`fleet_step`'s share of its roofline: the least time of its windows
(`portbench.counts.fleet_step` at the flush's shape) over their profiled
device time."""
from portbench.counts import fleet_step
from portbench.counts.peaks import least_seconds
from portbench.metrics._fleet import window_cost


def read(ctx):
    ks = ctx.trace.kernels("fleet_step")
    if not ks:
        return None
    nbytes, ops = window_cost(ctx)
    return (100.0 * len(ks) * least_seconds(nbytes, ops, fleet_step.PRECISION)
            / ctx.trace.seconds(ks))
