"""probe_roofline (%, device_trace): the least time of the joins'
work (work_bytes.probe over 3.35 TB/s) against the device time of the
`tidb_probe_count` kernels (probe_count) in the traced window."""

from harness.spec import metric_reader

work_bytes = metric_reader("work_bytes")

PATTERNS = ("probe_count",)


def read(ctx):
    return work_bytes.roofline_pct(ctx, work_bytes.probe, PATTERNS)
