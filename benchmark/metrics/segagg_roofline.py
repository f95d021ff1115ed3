"""segagg_roofline (%, device_trace): the least time of the grouped
aggregations' work (work_bytes.segagg over 3.35 TB/s) against the
device time of the `tidb_segagg` kernels (segagg_*, segsum_*) in the
traced window."""

from harness.spec import metric_reader

work_bytes = metric_reader("work_bytes")

PATTERNS = ("segagg", "segsum")


def read(ctx):
    return work_bytes.roofline_pct(ctx, work_bytes.segagg, PATTERNS)
