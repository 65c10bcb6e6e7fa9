"""Share of the traced pass in which no record ran on the card: 100 minus
the union of the trace's device records over the traced window."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
