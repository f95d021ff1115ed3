"""untraced_ms (ms, program_counter): the mean client latency (send to
last row) of the statements sent in the window, less the mean of their
records' spans that partition the server's time (harness/spans.py
STATEMENT_PARTS: the queue, the lock wait, the parse, the plan, the
execution, the statement's end and the response's write): the wire
plus whatever no span covers."""

from harness import spans


def read(ctx):
    covered = spans.mean_ms(ctx, lambda r: sum(spans.span_s(r, n)
                                               for n in spans.STATEMENT_PARTS))
    if covered is None:
        return None
    latency = sum(s.latency_s for s in ctx.statements) / len(ctx.statements)
    return latency * 1000.0 - covered
