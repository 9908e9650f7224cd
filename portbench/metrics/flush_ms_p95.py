"""95th percentile over the window's untraced flushes of the host clock
between consecutive flush records."""
from portbench.harness import percentile


def read(ctx):
    gaps = ctx.counters.get("flush_ms_untraced") or []
    return percentile(gaps, 95.0) if len(gaps) >= 20 else None
