"""host_issue_ms: the host's time to issue a dispatch, from its start to
the return of its last entry call (before its outputs are read back),
median over the traced stretch; host clock."""

import statistics


def read(ctx):
    if not ctx.dispatches:
        return None
    return statistics.median(t_issue - t_start for t_start, t_issue, _ in ctx.dispatches) * 1e3
