"""live_rows_ms (ms, program_counter): per statement sent in the window,
the seconds of the program's storage.live_rows counter: Table.live_rows,
a pass over every row's timestamps that the planner calls for a row
count (harness/spans.py)."""

from harness import spans


def read(ctx):
    return spans.mean_ms(ctx, lambda r: spans.counter_s(r, "storage.live_rows"))
