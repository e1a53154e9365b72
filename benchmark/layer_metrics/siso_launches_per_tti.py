"""siso_launches_per_tti: launches of the windowed SISO kernel (float32 and
16-bit, replays and conditional bodies included, counted by the port's
`siso_windowed.launches` after `utils.jit.fold_launches`) per TTI of the
traced stretch: the depth of the DL-SCH cascade."""


def read(ctx):
    if not ctx.siso_launches:
        return None
    return ctx.siso_launches / ctx.ttis
