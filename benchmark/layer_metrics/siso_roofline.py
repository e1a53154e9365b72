"""siso_roofline: the least time of the SISO launches of the traced
stretch (their bytes at the HBM's rate, from the shapes the port counted)
over their kernel time in the trace, in percent.  Nothing unless the trace
holds exactly the launches counted."""

from benchmark.harness import roofline


def read(ctx):
    if ctx.trace is None or not ctx.siso_launches:
        return None
    count, seconds = ctx.trace.kernels("siso_kernel")
    if count != ctx.siso_launches or seconds <= 0:
        return None
    return 100.0 * roofline.siso_least_s(ctx.siso_shapes) / seconds
