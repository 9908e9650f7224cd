"""The whole loop's share of the card's f32 peak: `fleet_step`'s
operations (the scheduler's arithmetic, `portbench.counts.fleet_step`) of
every completed flush over the window's host-clock length."""
from portbench.counts.peaks import FLOPS
from portbench.metrics._fleet import window_cost


def read(ctx):
    c = ctx.counters
    if not c.get("flushes"):
        return None
    ops = window_cost(ctx)[1] * c["flushes"]
    return 100.0 * ops / (c["window_s"] * FLOPS["f32"])
