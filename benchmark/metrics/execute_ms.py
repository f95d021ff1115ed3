"""execute_ms (ms, program_counter): per statement sent in the window,
the program's session.execute span: the executor tree run to its host
rows, the built programs and the device syncs inside it
(harness/spans.py)."""

from harness import spans


def read(ctx):
    return spans.mean_ms(ctx, lambda r: spans.span_s(r, "session.execute"))
