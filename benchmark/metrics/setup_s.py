"""setup_s (s, host clock): from the start of the run's process to the
window's first send: imports, generation, the bulk load, ANALYZE, the
first reads that fold, re-sort and place lineitem, and the warm-up of
the cell's own statements."""


def read(ctx):
    return ctx.setup_s
