"""front_end_us_per_tti: device time of the operations that belong to the
benchmark's span "front_end" (a graph replay's kernels belong to the span of
the call that replayed it), in microseconds per TTI of the traced stretch.
Nothing when the trace shows no kernel of a graph replay."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.graph_ops():
        return None
    return ctx.trace.span_device_s("front_end") * 1e6 / ctx.ttis
