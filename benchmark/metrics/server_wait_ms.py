"""server_wait_ms (ms, program_counter): per statement sent in the
window, the client's latency less the server's own statement time
(Delta of the program's QUERY_DURATION sum): the wire, the scheduler's
queue and the wait for the catalog lock that a statement takes whole."""


def read(ctx):
    ok = [s for s in ctx.statements if not s.failed]
    n = ctx.counters["query_n"]
    if not ok or not n:
        return None
    return (sum(s.latency_s for s in ok) / len(ok) - ctx.counters["query_s"] / n) * 1000.0
