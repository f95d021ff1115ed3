"""WindowExec (ref: executor/window.go — the window-function executor; a
copy of tidb_tpu/executor/window.py).

Runs as a root-task operator over materialized rows, like Sort (the
reference likewise evaluates windows on the SQL node, not in
coprocessors). One pass on the host: drain the child's live rows (off
the card when it ran there), lexsort by (partition keys, order keys),
compute the function over partition segments with numpy, scatter the
values back to the original row order, and emit the rows with the output
column attached.

Frame semantics (MySQL defaults):
  * no ORDER BY  -> the whole partition is the frame
  * with ORDER BY -> RANGE UNBOUNDED PRECEDING .. CURRENT ROW: peers
    (rows tying on the order keys) share the frame result
"""

from __future__ import annotations

import numpy as np

from tidb_tpu_torch.chunk.chunk import Chunk
from tidb_tpu_torch.chunk.column import Column
from tidb_tpu_torch.errors import UnsupportedError
from tidb_tpu_torch.executor.base import ExecContext, Executor
from tidb_tpu_torch.executor.sort import _Materializing, _sort_order
from tidb_tpu_torch.utils import dispatch

__all__ = ["WindowExec"]


class WindowExec(_Materializing):
    def __init__(self, schema, child, func: str, args, partition_by,
                 order_by, out_uid: str, out_type, params: tuple = (),
                 frame=None):
        super().__init__(schema, [child])
        self.func = func
        self.args = args
        self.partition_by = partition_by
        self.order_by = order_by
        self.out_uid = out_uid
        self.out_type = out_type
        self.params = params
        self.frame = frame  # ("rows", lo_bound, hi_bound) or None

    def open(self, ctx: ExecContext) -> None:
        from tidb_tpu_torch.types import TypeKind

        Executor.open(self, ctx)
        self.ctx = ctx
        # drain with (partition keys, order keys, arg) evaluated per chunk
        key_items = ([(e, False) for e in self.partition_by]
                     + list(self.order_by)
                     + [(a, False) for a in self.args])
        out_schema = self.schema
        self.schema = out_schema[:-1]  # the out column isn't in the child
        try:
            # the drained rows are runs the query budget may spill, as a
            # sort's are
            runs = self._drain_to_runs(key_items)
            host_keys = self._global_keys(runs, len(key_items))
            n = len(host_keys[0][0]) if key_items else sum(
                r for _, r in runs.all_runs())
            np_part = len(self.partition_by)
            np_ord = len(self.order_by)
            descale = 1.0
            if (self.func == "avg" and self.args
                    and self.args[0].type_.kind == TypeKind.DECIMAL):
                descale = float(10 ** self.args[0].type_.scale)
            vals, valid = _compute_window(
                self.func, host_keys[:np_part],
                host_keys[np_part : np_part + np_ord],
                list(self.order_by),
                host_keys[np_part + np_ord :],
                n, self.out_type, avg_descale=descale,
                params=self.params, frame=self.frame)
            self._emit(runs, None, n)  # original row order
        finally:
            self.schema = out_schema
            self._close_runs()
        # attach the output column, sliced chunk by chunk
        cap = self.ctx.chunk_capacity
        out_col = self.schema[-1]
        patched = []
        off = 0
        for ch in self._chunks:
            # host-sync: each chunk's live count slices the host result,
            # one scalar per chunk after the window's host evaluation
            m = int(dispatch.device_get(ch.sel.sum()))
            col = Column.from_numpy(vals[off : off + m], out_col.type_,
                                    valid=valid[off : off + m], capacity=cap)
            cols = dict(ch.columns)
            cols[self.out_uid] = col
            patched.append(Chunk(cols, ch.sel))
            off += m
        self._chunks = patched


def _frame_edges(frame, idx, part_start, part_end,
                 tie_start=None, tie_last=None):
    """Per-row inclusive [s, e] sorted-index window for an explicit
    frame; empty windows surface as s > e. ROWS counts physical rows
    from the current row; RANGE's CURRENT ROW means the current PEER
    GROUP (tie_start/tie_last), per the standard."""
    kind, lo, hi = frame

    def edge(bound, is_lo):
        if bound[0] == "unbounded_preceding":
            return part_start.copy()
        if bound[0] == "unbounded_following":
            return part_end.copy()
        if bound[0] == "current":
            if kind == "range":
                return (tie_start if is_lo else tie_last).copy()
            return idx.copy()
        off = bound[1]
        return idx + (-off if bound[0] == "preceding" else off)

    s = np.maximum(edge(lo, True), part_start)
    e = np.minimum(edge(hi, False), part_end)
    return s, e


def _compute_window(func, part_keys, order_keys, order_items, arg_keys,
                    n: int, out_type, avg_descale: float = 1.0,
                    params: tuple = (), frame=None):
    """Returns (values[n], valid[n]) in ORIGINAL row order."""
    if n == 0:
        return (np.zeros(0, dtype=out_type.np_dtype),
                np.zeros(0, dtype=np.bool_))
    # global order: partitions ascending, then the window's ORDER BY
    items = [(None, False)] * len(part_keys) + [(None, d) for _, d in order_items]
    perm = _sort_order(part_keys + order_keys, items) if items else np.arange(n)

    def g(keys):  # gather (data, valid) pairs into sorted order
        return [(d[perm], v[perm]) for d, v in keys]

    sp, so = g(part_keys), g(order_keys)

    def _neq(d, v):
        """sorted-adjacent inequality; NULLs equal each other."""
        both_valid = v[1:] & v[:-1]
        both_null = ~v[1:] & ~v[:-1]
        return ~((both_valid & (d[1:] == d[:-1])) | both_null)

    # partition starts in sorted order
    new_part = np.zeros(n, dtype=np.bool_)
    new_part[0] = True
    for d, v in sp:
        new_part[1:] |= _neq(d, v)
    pid = np.cumsum(new_part) - 1  # partition id per sorted row
    starts = np.nonzero(new_part)[0]
    part_start = starts[pid]  # first sorted index of each row's partition

    # tie groups (same partition + same ORDER BY keys)
    new_tie = new_part.copy()
    for d, v in so:
        new_tie[1:] |= _neq(d, v)
    tid = np.cumsum(new_tie) - 1
    tstarts = np.nonzero(new_tie)[0]
    tie_start = tstarts[tid]
    # last sorted index of each tie group
    tlast = np.empty(len(tstarts), dtype=np.int64)
    tlast[:-1] = tstarts[1:] - 1
    tlast[-1] = n - 1
    tie_last = tlast[tid]

    idx = np.arange(n)
    out_valid = np.ones(n, dtype=np.bool_)

    # partition last index (for LEAD bounds / unordered LAST_VALUE)
    pends = np.empty(len(starts), dtype=np.int64)
    pends[:-1] = starts[1:] - 1
    pends[-1] = n - 1
    part_end = pends[pid]

    if func in ("lead", "lag", "first_value", "last_value", "ntile"):
        if func == "ntile":
            nb = int(params[0])
            size = part_end - part_start + 1
            k = idx - part_start
            base = size // nb
            rem = size % nb
            thresh = rem * (base + 1)
            with np.errstate(divide="ignore", invalid="ignore"):
                svals = np.where(
                    k < thresh,
                    k // np.maximum(base + 1, 1) + 1,
                    rem + (k - thresh) // np.maximum(base, 1) + 1)
        else:
            ad, av = arg_keys[0][0][perm], arg_keys[0][1][perm]
            if func == "first_value":
                if frame is not None:
                    fs, fe = _frame_edges(frame, idx, part_start, part_end,
                                          tie_start, tie_last)
                    src_i = np.clip(fs, 0, n - 1)
                    inwin = fs <= fe
                else:
                    src_i = part_start
                    inwin = np.ones(n, dtype=np.bool_)
            elif func == "last_value":
                if frame is not None:
                    fs, fe = _frame_edges(frame, idx, part_start, part_end,
                                          tie_start, tie_last)
                    src_i = np.clip(fe, 0, n - 1)
                    inwin = fs <= fe
                else:
                    # default frame: up to the current tie group
                    # (ordered), whole partition otherwise
                    src_i = tie_last if order_items else part_end
                    inwin = np.ones(n, dtype=np.bool_)
            else:
                off = int(params[0])
                src_i = idx - off if func == "lag" else idx + off
                inwin = (src_i >= part_start) & (src_i <= part_end)
                src_i = np.clip(src_i, 0, n - 1)
            svals = ad[src_i]
            out_valid = av[src_i] & inwin
            if func in ("lead", "lag") and len(params) > 1:
                _off, dval, dnull = params
                if not dnull:
                    dv = out_type.np_dtype.type(dval)
                    svals = np.where(inwin, svals, dv)
                    out_valid = np.where(inwin, out_valid, True)
    elif func == "row_number":
        svals = idx - part_start + 1
    elif func == "rank":
        svals = tie_start - part_start + 1
    elif func == "dense_rank":
        # tie index within the partition
        svals = tid - tid[part_start] + 1
    else:
        has_arg = bool(arg_keys)
        if has_arg:
            ad, av = arg_keys[0][0][perm], arg_keys[0][1][perm]
        else:  # COUNT(*)
            ad = np.ones(n, dtype=np.int64)
            av = np.ones(n, dtype=np.bool_)
        framed = bool(order_items)  # running frame vs whole partition
        if func in ("count", "sum", "avg"):
            fd = ad.astype(np.float64) if func == "avg" else ad.astype(
                np.int64 if not np.issubdtype(ad.dtype, np.floating) else np.float64)
            ones = av.astype(np.int64)
            contrib = np.where(av, fd, 0)
            if frame is not None:
                # explicit ROWS frame: windowed prefix-sum differences;
                # no peer sharing (ROWS counts physical rows)
                fs, fe = _frame_edges(frame, idx, part_start, part_end,
                                          tie_start, tie_last)
                cs = np.concatenate(([0], np.cumsum(contrib)))
                cn = np.concatenate(([0], np.cumsum(ones)))
                lo = np.clip(fs, 0, n)
                hi = np.clip(fe + 1, 0, n)
                nonempty = fs <= fe
                run_s = np.where(nonempty, cs[hi] - cs[lo], 0)
                run_n = np.where(nonempty, cn[hi] - cn[lo], 0)
            elif framed:
                cs = np.cumsum(contrib)
                cn = np.cumsum(ones)
                base_s = cs[part_start] - contrib[part_start]
                base_n = cn[part_start] - ones[part_start]
                run_s = cs - base_s
                run_n = cn - base_n
                # RANGE frame: peers share the tie group's last value
                run_s = run_s[tie_last]
                run_n = run_n[tie_last]
            else:
                tot_s = np.add.reduceat(contrib, starts)
                tot_n = np.add.reduceat(ones, starts)
                run_s = tot_s[pid]
                run_n = tot_n[pid]
            if func == "count":
                svals = run_n
            elif func == "sum":
                svals = run_s
                out_valid = run_n > 0  # SUM of no rows is NULL
            else:
                with np.errstate(divide="ignore", invalid="ignore"):
                    svals = np.where(run_n > 0,
                                     run_s / np.maximum(run_n, 1) / avg_descale,
                                     0.0)
                out_valid = run_n > 0
        elif func in ("min", "max"):
            red = np.minimum if func == "min" else np.maximum
            big = (np.inf if np.issubdtype(ad.dtype, np.floating)
                   else np.iinfo(np.int64).max)
            ident = big if func == "min" else -big
            cd = np.where(av, ad, ident)
            ones = av.astype(np.int64)
            if frame is not None:
                fs, fe = _frame_edges(frame, idx, part_start, part_end,
                                          tie_start, tie_last)
                cn = np.concatenate(([0], np.cumsum(ones)))
                lo = np.clip(fs, 0, n)
                hi = np.clip(fe + 1, 0, n)
                nonempty = fs <= fe
                run_n = np.where(nonempty, cn[hi] - cn[lo], 0)
                # per-partition sliding extremes (O(P) loop like the
                # running path; sliding_window_view when both bounds are
                # finite, prefix/suffix accumulates otherwise)
                run = np.full(n, ident, dtype=cd.dtype)
                _k, flo, fhi = frame

                def _off(b):
                    if b[0] == "current":
                        return 0
                    return -b[1] if b[0] == "preceding" else b[1]

                for s0, e0 in zip(starts, list(starts[1:]) + [n]):
                    seg = cd[s0:e0]
                    m = e0 - s0
                    if flo[0] == "unbounded_preceding":
                        # prefix extreme at the (clipped) frame end
                        pref = red.accumulate(seg)
                        eseg = np.clip(fe[s0:e0] - s0, 0, m - 1)
                        run[s0:e0] = pref[eseg]
                    elif fhi[0] == "unbounded_following":
                        suf = red.accumulate(seg[::-1])[::-1]
                        sseg = np.clip(fs[s0:e0] - s0, 0, m - 1)
                        run[s0:e0] = suf[sseg]
                    elif _k == "range":
                        # CURRENT..CURRENT peer-group extreme (the only
                        # remaining RANGE combo: bounds are tie groups)
                        tl = np.clip(fe[s0:e0] - s0, 0, m - 1)
                        pref = red.accumulate(seg)
                        ts_ = np.clip(fs[s0:e0] - s0, 0, m - 1)
                        suf = red.accumulate(seg[::-1])[::-1]
                        # extreme over [ts, tl]: windows never overlap
                        # across tie groups, so prefix-from-tie-start
                        # works: min(prefix[tl], suffix[ts]) over the
                        # group equals reduceat — use reduceat directly
                        gstart = np.unique(ts_)
                        gmin = red.reduceat(seg, gstart)
                        gmap = np.searchsorted(gstart, ts_)
                        run[s0:e0] = gmin[gmap]
                    else:
                        lo_off, hi_off = _off(flo), _off(fhi)
                        w = hi_off - lo_off + 1
                        if w < 1:
                            continue  # every window empty
                        if w >= m:
                            # windows at least partition-sized: every
                            # clipped window is a prefix or a suffix —
                            # O(m) instead of O(m*w)
                            pref = red.accumulate(seg)
                            suf = red.accumulate(seg[::-1])[::-1]
                            a = np.arange(m) + lo_off   # unclipped start
                            b = np.clip(np.arange(m) + hi_off, 0, m - 1)
                            run[s0:e0] = np.where(
                                a <= 0, pref[b],
                                suf[np.clip(a, 0, m - 1)])
                            continue
                        # both bounds finite, narrow: identity padding
                        # makes edge-clipped windows fall out of one
                        # vectorized sliding extreme
                        pad = np.full(w - 1, ident, dtype=seg.dtype)
                        padded = np.concatenate([pad, seg, pad])
                        sw = np.lib.stride_tricks.sliding_window_view(
                            padded, w)
                        ext = (sw.min(axis=1) if func == "min"
                               else sw.max(axis=1))
                        # seg-coord window start r+lo_off lives at
                        # sliding index r+lo_off+(w-1)
                        widx = np.arange(m) + lo_off + (w - 1)
                        run[s0:e0] = ext[np.clip(widx, 0, len(ext) - 1)]
                run = np.where(nonempty, run, ident)
            elif framed:
                # partition-segmented running min/max (O(P) python loop
                # over partitions; acceptable for a root operator)
                run = np.empty_like(cd)
                for s, e in zip(starts, list(starts[1:]) + [n]):
                    run[s:e] = red.accumulate(cd[s:e])
                cn = np.cumsum(ones)
                run_n = cn - (cn[part_start] - ones[part_start])
                run = run[tie_last]
                run_n = run_n[tie_last]
            else:
                tot = red.reduceat(cd, starts)
                run = tot[pid]
                run_n = np.add.reduceat(ones, starts)[pid]
            svals = run
            out_valid = run_n > 0
        else:
            raise UnsupportedError(f"window function {func}")

    # scatter back to original row order
    inv = np.empty(n, dtype=np.int64)
    inv[perm] = np.arange(n)
    vals_sorted = np.asarray(svals)
    out = vals_sorted[inv].astype(out_type.np_dtype)
    return out, out_valid[inv]
