"""The least bytes of the kernels' work, from the statements run and the
reference's own row counts (not a metric: the rooflines' yardstick).

Each value that reaches the aggregation or a join is read once, at the
reference's dtype (int64: keys, arguments, group ids), and each output
is written once: per grouped aggregation, its rows times its argument
values and group id, plus its outputs; per join, its build keys, its
probe keys and its matches. The counts depend on the query and the
data only, so a later change of the kernels leaves them alone."""

VALUE_BYTES = 8


def segagg(work: dict) -> int:
    a = work.get("agg")
    if not a:
        return 0
    return VALUE_BYTES * (a["rows"] * a["values"] + a["outputs"])


def probe(work: dict) -> int:
    return VALUE_BYTES * sum(j["build"] + j["probe"] + j["out"] for j in work.get("joins", []))


def roofline_pct(ctx, bytes_of, patterns):
    """100 x (bytes / HBM bandwidth) / device seconds of the kernels named
    by `patterns`, over the statements sent in the window (the trace runs
    until the last of them has its rows); None where nothing ran."""
    from harness import peaks
    from harness import trace as tr

    bw = peaks.hbm_bytes_per_s(ctx.kind)
    t = tr.kernel_seconds(ctx.trace, patterns)
    b = sum(bytes_of(ctx.work[s.tag]) for s in ctx.statements if s.tag in ctx.work)
    if not bw or not t or not b:
        return None
    return 100.0 * b / bw / t
