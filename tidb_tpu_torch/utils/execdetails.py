"""Per-operator runtime statistics for EXPLAIN ANALYZE
(ref: util/execdetails RuntimeStats + EXPLAIN ANALYZE's actRows/time/loops
columns on every operator).

Instrumentation wraps each executor's open/next in place; row counts force
a device sync per chunk, which is exactly the accuracy/overhead trade
EXPLAIN ANALYZE makes in the reference too. Only an instrumented tree pays
it: a plain statement's executors are never wrapped. `dispatches` counts
the port's kernel launches and `recompiles` its nvcc builds
(utils/dispatch.py).
"""

from __future__ import annotations

import time
from typing import List, Tuple

__all__ = ["instrument", "analyze_text"]


def instrument(root) -> List:
    """Wrap open/next of every executor in the tree; returns the node list."""
    nodes = []
    stack = [root]
    while stack:
        e = stack.pop()
        nodes.append(e)
        _wrap(e)
        stack.extend(e.children)
    return nodes


def _wrap(e) -> None:
    from tidb_tpu_torch.utils import dispatch

    orig_open, orig_next = e.open, e.next
    st = e.stats
    # instrumented row counts are exact (every emitted chunk is summed);
    # the builder's plan annotation pairs them with the node's estimate
    # for the est/drift columns
    st.measured = True
    p = getattr(e, "_feedback_plan", None)
    if p is not None:
        st.est_rows = float(getattr(p, "est_rows", -1.0))

    def open_(ctx):
        t0 = time.perf_counter()
        if st.first_ts is None:
            st.first_ts = t0
        d0 = dispatch.count()
        c0 = dispatch.compile_count()
        try:
            return orig_open(ctx)
        finally:
            st.open_wall += time.perf_counter() - t0
            st.dispatches += dispatch.count() - d0
            st.recompiles += dispatch.compile_count() - c0

    def next_():
        t0 = time.perf_counter()
        if st.first_ts is None:
            st.first_ts = t0
        d0 = dispatch.count()
        c0 = dispatch.compile_count()
        ch = orig_next()
        st.next_wall += time.perf_counter() - t0
        st.dispatches += dispatch.count() - d0
        st.recompiles += dispatch.compile_count() - c0
        if ch is not None:
            st.chunks += 1
            st.rows += int(ch.sel.sum())
        return ch

    e.open, e.next = open_, next_


_GANTT_W = 10  # character width of the proportional start-offset column


def analyze_text(root) -> str:
    """TiDB-style EXPLAIN ANALYZE table over an executed executor tree.

    The `start` column is each operator's first-activity offset from
    the earliest operator start (stats.first_ts), rendered with a
    proportional gutter — overlapping async fragment executors used to
    render as if they ran sequentially. The `staged` column counts the
    chunks whose device buffers were already in place when the compute
    loop asked (prefetch overlap + device-buffer-cache hits) out of the
    chunks the operator staged — the observability face of the
    pipelined staging path.

    `estRows` and `drift` put the planner's estimate next to what
    actually happened: drift = actRows/estRows, so 1.00 is a perfect
    estimate, 100.00 a hundredfold underestimate. Operators the builder
    couldn't annotate (peeled-away interior nodes) show "-"."""
    rows: List[Tuple[str, str, str, str, str, str, str, str]] = []
    anchor = min((e_ts for e_ts in _walk_first_ts(root)), default=None)
    span_total = 0.0
    if anchor is not None:
        for ts in _walk_first_ts(root):
            span_total = max(span_total, ts - anchor)

    def visit(e, depth: int, last: bool):
        indent = ""
        if depth:
            indent = "  " * (depth - 1) + ("└─" if last else "├─")
        kids = _actual_children(e)
        total = e.stats.open_wall + e.stats.next_wall
        child_total = sum(c.stats.open_wall + c.stats.next_wall for c in kids)
        own = max(total - child_total, 0.0)
        own_disp = max(
            e.stats.dispatches - sum(c.stats.dispatches for c in kids), 0)
        own_rc = max(
            e.stats.recompiles - sum(c.stats.recompiles for c in kids), 0)
        if anchor is not None and e.stats.first_ts is not None:
            off = e.stats.first_ts - anchor
            pos = (round(off / span_total * (_GANTT_W - 1))
                   if span_total > 0 else 0)
            start = "·" * pos + "|" + f" +{off * 1e6:.0f}us"
        else:
            start = "|"
        staged = str(e.stats.staged) if e.stats.staged else "-"
        est = e.stats.est_rows
        if est >= 0:
            est_s = f"{est:.2f}"
            drift_s = f"{e.stats.rows / est:.2f}" if est > 0 else "-"
        else:
            est_s = drift_s = "-"
        name = type(e).__name__.replace("Exec", "")
        # a fused exec that delegated to its classic fallback must not
        # render as if the fused path ran: mark it and show the classic
        # subtree that actually executed (kept via _fallback_taken —
        # run_plan closes the tree before EXPLAIN ANALYZE renders)
        if hasattr(e, "_ran_fused") and not e._ran_fused:
            name += "[classic]"
        rows.append((
            indent + name,
            est_s,
            str(e.stats.rows),
            drift_s,
            f"{total * 1e3:.1f}ms",
            start,
            staged,
            f"open:{e.stats.open_wall * 1e3:.1f}ms own:{own * 1e3:.1f}ms "
            f"loops:{e.stats.chunks} dispatches:{own_disp}"
            + (f" recompiles:{own_rc}" if own_rc else "")
            # columnar segment store: staged vs zone-map-pruned counts
            # per scan operator (absent on non-segmented scans)
            + (f" segs_scanned:{e.stats.segs_scanned}"
               f" segs_pruned:{e.stats.segs_pruned}"
               if e.stats.segs_scanned or e.stats.segs_pruned else ""),
        ))
        for i, c in enumerate(kids):
            visit(c, depth + 1, i == len(kids) - 1)

    visit(root, 0, True)
    heads = ("id", "estRows", "actRows", "drift", "time", "start",
             "staged")
    widths = [max(max(len(r[i]) for r in rows), len(heads[i])) + 2
              for i in range(len(heads))]
    lines = ["".join(f"{h:<{w}}" for h, w in zip(heads, widths))
             + "execution info"]
    for r in rows:
        lines.append("".join(f"{r[i]:<{w}}" for i, w in enumerate(widths))
                     + r[len(heads)])
    return "\n".join(lines)


def _actual_children(e):
    """Render children plus any classic fallback subtree a fused exec
    actually ran (live ``_delegate`` pre-close, ``_fallback_taken``
    after — the normal EXPLAIN ANALYZE path renders post-close)."""
    kids = list(getattr(e, "children", ()))
    d = getattr(e, "_delegate", None)
    if d is None:
        d = getattr(e, "_fallback_taken", None)
    if d is not None:
        kids.append(d)
    return kids


def _walk_first_ts(root):
    stack = [root]
    while stack:
        e = stack.pop()
        if e.stats.first_ts is not None:
            yield e.stats.first_ts
        stack.extend(_actual_children(e))
