"""Device (H100): the share of the traced window in which no kernel, copy or
memset runs on the card. Nothing where the trace holds no device activity
(no card)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0 or ctx.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
