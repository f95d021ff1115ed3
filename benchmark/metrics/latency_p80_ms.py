"""latency_p80_ms (ms, host clock): the 80th percentile of the client's
latency (send to last row) of every statement sent in the window, those
still in flight at the close included; a statement that failed counts
as slower than any. The 80th is the highest percentile with ten or more
statements beyond it at the join cell's some fifty a window."""

import math


def read(ctx):
    lat = sorted(float("inf") if s.failed else s.latency_s for s in ctx.statements)
    if len(lat) < 10:
        return None
    v = lat[math.ceil(0.8 * len(lat)) - 1]  # nearest rank
    return None if math.isinf(v) else v * 1000.0
