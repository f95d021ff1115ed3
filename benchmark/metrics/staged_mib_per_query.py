"""staged_mib_per_query (MiB/query, program_counter): host-to-device
bytes the program staged (Delta of XFER_BYTES, dir h2d) per statement."""


def read(ctx):
    n = ctx.counters["query_n"]
    if not n:
        return None
    return ctx.counters["h2d_bytes"] / n / 2 ** 20
