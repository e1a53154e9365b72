"""device_idle_pct: the share of the traced stretch (first dispatch's
start to the last one's end) in which no kernel, copy or set ran on the
card (the union of the device's operations), in percent.  Nothing when the
trace shows no kernel of a graph replay."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.graph_ops() or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
