"""lock_wait_ms (ms, program_counter): per statement sent in the window,
the program's sched.lock_wait span: from a scheduler worker's claim of
the statement until it holds the catalog lock, which one statement at a
time holds (harness/spans.py)."""

from harness import spans


def read(ctx):
    return spans.mean_ms(ctx, lambda r: spans.span_s(r, "sched.lock_wait"))
