"""plan_ms (ms, program_counter): the program's parse and plan seconds
(Delta of PARSE_SECONDS and PLAN_SECONDS sums) per statement."""


def read(ctx):
    n = ctx.counters["query_n"]
    if not n:
        return None
    return (ctx.counters["parse_s"] + ctx.counters["plan_s"]) / n * 1000.0
