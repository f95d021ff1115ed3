"""sync_wait_ms (ms, program_counter): per statement sent in the window,
the seconds of the program's device.sync counter: the host blocked on
the card, in device->host copies, copies from pageable host memory and
operations whose output size the host must learn (harness/spans.py)."""

from harness import spans


def read(ctx):
    return spans.mean_ms(ctx, lambda r: spans.counter_s(r, "device.sync"))
