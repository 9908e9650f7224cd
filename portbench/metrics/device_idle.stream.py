"""Share of the traced window in which no kernel and no copy ran."""


def read(ctx):
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
