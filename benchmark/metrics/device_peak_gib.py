"""device_peak_gib (GiB, program_counter): torch.cuda.max_memory_reserved()
over the window, its peak statistics reset at the window's start; the
program's CUDA graph pools are in it."""


def read(ctx):
    if ctx.peak_window_bytes is None:
        return None
    return ctx.peak_window_bytes / 2 ** 30
