"""device_idle_pct (%, device_trace): the share of the traced window
(its first send to its last statement's rows) in which no kernel, copy
or set ran on the card."""


def read(ctx):
    t = ctx.trace
    if not t or t["window_s"] <= 0 or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
