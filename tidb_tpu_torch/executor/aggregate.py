"""HashAggExec (ref: executor/aggregate.go — partial/final worker
pipeline).

Two strategies, chosen by the planner:

  segment  -- every group key has a small known domain (dictionary codes,
              bools). Keys pack into one dense code; aggregation is
              per-chunk segment sums into [G]-shaped accumulators on the
              device. A chunk's counts and exact int64/decimal sums go
              through one call of ops/segment_sum.py's segment_accumulate
              (one hand-written CUDA launch); float sums and min/max use
              index_add_ / scatter_reduce_.
              NULL gets its own slot per key (domain+1) so SQL NULL-group
              semantics hold.

  generic  -- arbitrary keys (wide ints, floats, many distinct). With the
              device engine on (ExecContext.device_agg) and a grouped,
              non-DISTINCT aggregation of core functions, each chunk sorts
              into a device group table (agg_device.py), the tables merge
              on the device, and one batched fetch at finalize feeds the
              host merge. Otherwise chunks compact to host and a vectorized
              numpy groupby finalizes (the host engine, kept as the
              oracle).

Not yet ported from tidb_tpu/executor/aggregate.py: the spill-to-disk
partial runs and external range merge of the host generic path.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from tidb_tpu_torch.chunk.chunk import Chunk
from tidb_tpu_torch.chunk.column import Column
from tidb_tpu_torch.errors import ExecutionError, UnsupportedError
from tidb_tpu_torch.executor.base import ExecContext, Executor
from tidb_tpu_torch.expression.compiler import eval_expr
from tidb_tpu_torch.planner.logical import AggSpec
from tidb_tpu_torch.types import TypeKind
from tidb_tpu_torch.utils.device import torch_dtype

__all__ = ["HashAggExec", "make_segment_kernel", "split_limbs",
           "normalize_limbs", "combine_limbs_exact", "DEVICE_GENERIC_TOTAL",
           "reset_counters"]

# generic aggregations that ran on the device by how they were fed:
# "classic" pulled chunks from a child executor, "fused" came from
# FusedScanAggExec's staged scan (executor/pipeline.py)
DEVICE_GENERIC_TOTAL = {"classic": 0, "fused": 0}


def reset_counters() -> None:
    for k in DEVICE_GENERIC_TOTAL:
        DEVICE_GENERIC_TOTAL[k] = 0


def _min_identity(dtype):
    if np.issubdtype(dtype, np.floating):
        return np.inf
    return np.iinfo(dtype).max


def _max_identity(dtype):
    if np.issubdtype(dtype, np.floating):
        return -np.inf
    return np.iinfo(dtype).min


# host ufunc + identity per bitwise aggregate (generic host path only;
# the fragment tier rejects these so routing falls back cleanly)
_BIT_AGGS = {"bit_and": (np.bitwise_and, -1),
             "bit_or": (np.bitwise_or, 0),
             "bit_xor": (np.bitwise_xor, 0)}

_VAR_AGGS = ("var_pop", "var_samp", "stddev_pop", "stddev_samp")


def _var_m2(vals: np.ndarray, inverse: np.ndarray, ngroups: int):
    """Two-pass per-group variance core: (cnt, sum, m2) with
    m2 = sum((x - group_mean)^2). Numerically stable — never forms
    E[x^2]-E[x]^2, whose cancellation destroys large-magnitude data
    (epoch timestamps, money-in-cents)."""
    v = vals.astype(np.float64)
    cnt = np.zeros(ngroups, dtype=np.int64)
    np.add.at(cnt, inverse, 1)
    s = np.zeros(ngroups, dtype=np.float64)
    np.add.at(s, inverse, v)
    with np.errstate(divide="ignore", invalid="ignore"):
        mean = np.where(cnt > 0, s / np.maximum(cnt, 1), 0.0)
    m2 = np.zeros(ngroups, dtype=np.float64)
    np.add.at(m2, inverse, (v - mean[inverse]) ** 2)
    return cnt, s, m2


def _var_finalize(func: str, cnt: np.ndarray, m2: np.ndarray):
    """(values, valid) per MySQL: VAR_POP needs n>=1, VAR_SAMP n>=2."""
    with np.errstate(divide="ignore", invalid="ignore"):
        if func in ("var_pop", "stddev_pop"):
            out = np.where(cnt > 0, m2 / np.maximum(cnt, 1), 0.0)
            valid = cnt > 0
        else:
            out = np.where(cnt > 1, m2 / np.maximum(cnt - 1, 1), 0.0)
            valid = cnt > 1
    if func.startswith("stddev"):
        out = np.sqrt(np.maximum(out, 0.0))
    return out, valid


# ---------------------------------------------------------------------------
# two-limb exact accumulation for scaled-int64 DECIMAL sums (SURVEY.md:309
# hard-part 3). A value v splits into lo = v & (2^32-1) in [0, 2^32) and
# hi = v >> 32 (arithmetic), with v == hi * 2^32 + lo exactly. Sums of each
# limb stay far from int64 range for any realistic row count (lo adds < 2^32
# per row, hi adds < 2^31), the pair merges by addition like any other state,
# and the true total spans ~94 bits — SUM can now be COMPUTED at magnitudes
# where the old f64-shadow guard could only detect-and-fail.
# ---------------------------------------------------------------------------

_LO_BITS = 32
_LO_MASK = (1 << _LO_BITS) - 1


def needs_sum_limbs(a: AggSpec) -> bool:
    """DECIMAL SUM/AVG accumulates in two int64 limbs."""
    return (a.func in ("sum", "avg") and a.arg is not None
            and a.arg.type_.kind == TypeKind.DECIMAL)


def split_limbs(v):
    """(lo, hi) limb decomposition — works on torch and np int64 alike
    (`>>` on int64 is arithmetic in both, as in jnp)."""
    return v & _LO_MASK, v >> _LO_BITS


def normalize_limbs(lo, hi):
    """Carry lo's overflow into hi, restoring lo in [0, 2^32)."""
    return lo & _LO_MASK, hi + (lo >> _LO_BITS)


def limbs_to_float(lo, hi) -> np.ndarray:
    """Approximate float64 value of (lo, hi) pairs (for AVG and guards)."""
    return (np.asarray(hi, dtype=np.float64) * float(1 << _LO_BITS)
            + np.asarray(lo, dtype=np.float64))


def combine_limbs_exact(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Exact int64 totals from limb pairs; totals outside int64 raise
    (the DECIMAL result column is scaled int64 — a value that cannot be
    REPRESENTED is a true out-of-range error, unlike the old accumulator
    wrap, which hit ~2^62 of summed magnitude even when every group's
    total was small)."""
    tf = limbs_to_float(lo, hi)
    # f64 ulp at 2^63 is 1024: stay 4096 clear of the boundary so a
    # wrapped value can never masquerade as in-range
    if np.any(np.abs(tf) > float(1 << 63) - 4096.0):
        raise ExecutionError(
            "DECIMAL SUM value is out of range of the result type")
    t = ((np.asarray(hi).astype(np.uint64) << np.uint64(_LO_BITS))
         + np.asarray(lo).astype(np.uint64))
    return t.view(np.int64)


def scatter_limbs(vals: np.ndarray, inverse: np.ndarray, n: int):
    """Host limb accumulation: scatter-add each value's limbs into n
    group slots (shared by the spill-partial and resident agg paths)."""
    vlo, vhi = split_limbs(vals.astype(np.int64))
    lo = np.zeros(n, dtype=np.int64)
    hi = np.zeros(n, dtype=np.int64)
    np.add.at(lo, inverse, vlo)
    np.add.at(hi, inverse, vhi)
    return normalize_limbs(lo, hi)


def _lexsort_groups(cols: List[np.ndarray]):
    """Group rows by exact multi-column keys via one lexsort — several
    times faster than np.unique(axis=0)'s void-dtype row comparisons.
    Returns (ngroups, first_idx, inverse): representative original row
    per group (first in sort order) and each row's dense group id."""
    n = len(cols[0])
    if n == 0:
        return 0, np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    order = np.lexsort(cols[::-1])  # last key primary per np convention
    newseg = np.zeros(n, dtype=np.bool_)
    newseg[0] = True
    for c in cols:
        sc = c[order]
        newseg[1:] |= sc[1:] != sc[:-1]
    inverse = np.empty(n, dtype=np.int64)
    inverse[order] = np.cumsum(newseg) - 1
    first_idx = order[newseg]
    return int(newseg.sum()), first_idx, inverse


def _partial_nbytes(p: dict) -> int:
    return int(
        p["mat"].nbytes
        + sum(a.nbytes for a in p["keys"])
        + sum(a.nbytes for a in p["kvalids"])
        + sum(a.nbytes for st in p["states"] for a in st.values())
    )


def make_segment_kernel(group_exprs, aggs: List[AggSpec], domains: List[int]):
    """Build (init_state, update, G) for segment-strategy aggregation.

    `update(state, chunk) -> state` works on [G]-shaped accumulators on
    the chunk's device. It updates the accumulators in place (each belongs
    to one aggregation run) and returns the same dict: the same entries,
    names and values as the reference's pure update."""
    G = 1
    for d in domains:
        G *= d
    G = max(G, 1)

    def init_state(device):
        def zeros(dt):
            return torch.zeros(G, dtype=dt, device=device)

        st = {"occ": zeros(torch.int64)}
        for a in aggs:
            if a.func in ("sum", "avg"):
                dt = torch.float64 if a.arg.type_.kind == TypeKind.FLOAT else torch.int64
                st[f"{a.uid}.sum"] = zeros(dt)
                if needs_sum_limbs(a):
                    # two-limb exact accumulation: .sum holds the low
                    # 32-bit limb, .sumhi the high — see split_limbs
                    st[f"{a.uid}.sumhi"] = zeros(torch.int64)
                st[f"{a.uid}.cnt"] = zeros(torch.int64)
            elif a.func == "count":
                st[f"{a.uid}.cnt"] = zeros(torch.int64)
            elif a.func == "min":
                dt = a.arg.type_.np_dtype
                st[f"{a.uid}.min"] = torch.full(
                    (G,), _min_identity(dt), dtype=torch_dtype(dt), device=device)
                st[f"{a.uid}.cnt"] = zeros(torch.int64)
            elif a.func == "max":
                dt = a.arg.type_.np_dtype
                st[f"{a.uid}.max"] = torch.full(
                    (G,), _max_identity(dt), dtype=torch_dtype(dt), device=device)
                st[f"{a.uid}.cnt"] = zeros(torch.int64)
        return st

    def update(state, chunk: Chunk):
        from tidb_tpu_torch.ops import SegAcc, segment_accumulate

        packed = torch.zeros(chunk.capacity, dtype=torch.int64, device=chunk.device)
        stride = 1
        for g, dom in zip(group_exprs, domains):
            data, valid = eval_expr(g, chunk)
            idx = torch.where(valid, data.to(torch.int64).clamp(0, dom - 2), dom - 1)
            packed = packed + idx * stride
            stride *= dom
        sel = chunk.sel
        # every count and exact int64 sum of the chunk is one accumulator of
        # one segment_accumulate call (one tidb_segagg launch on the card),
        # which applies sel and each argument's validity itself
        accs = [SegAcc("count", state["occ"])]
        for a in aggs:
            if a.arg is not None:
                d, v = eval_expr(a.arg, chunk)
            if a.func in ("sum", "avg"):
                acc = state[f"{a.uid}.sum"]
                if f"{a.uid}.sumhi" in state:
                    # two-limb exact decimal path: the kernel splits each
                    # value as split_limbs does, sums both limbs and
                    # carry-normalizes the pair (normalize_limbs), so the lo
                    # accumulator never approaches int64 range however many
                    # chunks stream through
                    accs.append(SegAcc("limbs", acc, vals=d, mask=v,
                                       out_hi=state[f"{a.uid}.sumhi"]))
                elif acc.dtype == torch.int64:
                    accs.append(SegAcc("sum", acc, vals=d, mask=v))
                else:
                    acc.index_add_(0, packed, torch.where(sel & v, d.to(acc.dtype), 0))
                accs.append(SegAcc("count", state[f"{a.uid}.cnt"], mask=v))
            elif a.func == "count":
                accs.append(SegAcc("count", state[f"{a.uid}.cnt"],
                                   mask=None if a.arg is None else v))
            elif a.func in ("min", "max"):
                acc = state[f"{a.uid}.{a.func}"]
                ident = (_min_identity if a.func == "min" else _max_identity)(
                    np.dtype(a.arg.type_.np_dtype))
                contrib = torch.where(sel & v, d.to(acc.dtype), ident)
                acc.scatter_reduce_(0, packed, contrib,
                                    reduce="amin" if a.func == "min" else "amax")
                accs.append(SegAcc("count", state[f"{a.uid}.cnt"], mask=v))
        segment_accumulate(packed, G, sel, accs)
        return state

    return init_state, update, G


class HashAggExec(Executor):
    def __init__(self, schema, child, group_exprs, group_uids, aggs: List[AggSpec],
                 strategy: str, segment_sizes: Optional[List[int]] = None):
        super().__init__(schema, [child])
        self.group_exprs = group_exprs
        self.group_uids = group_uids
        self.aggs = aggs
        self.strategy = strategy
        self.segment_sizes = segment_sizes
        self._out: List[Chunk] = []

    def open(self, ctx: ExecContext) -> None:
        super().open(ctx)
        self.ctx = ctx
        self._out = []
        if self.strategy == "segment":
            self._run_segment()
        else:
            self._run_generic()

    def next(self) -> Optional[Chunk]:
        if self._out:
            return self._out.pop(0)
        return None

    # ------------------------------------------------------------------
    # segment strategy (device)
    # ------------------------------------------------------------------

    def _run_segment(self):
        from tidb_tpu_torch.executor.join import _to_device

        sizes = self.segment_sizes or []
        domains = [s + 1 for s in sizes]  # +1 slot for NULL keys
        init_state, update, _ = make_segment_kernel(self.group_exprs, self.aggs, domains)
        state = init_state(self.ctx.device)
        for chunk in self.children[0].chunks():
            # a host-side child (another aggregate's groups: TPC-H Q15's max
            # over its revenue view) moves to the state's device first
            state = update(state, _to_device(chunk, self.ctx.device))
        self._finalize_segment_state(state, domains)

    def _finalize_segment_state(self, state, domains):
        """One fetch of the [G]-shaped accumulators, then a host finalize
        (shared with FusedScanAggExec)."""
        host = {k: v.cpu().numpy() for k, v in state.items()}
        if self.group_exprs:
            occupied = np.nonzero(host["occ"] > 0)[0]
        else:
            occupied = np.array([0], dtype=np.int64)  # global agg: 1 row always
        self._emit_groups_from_packed(occupied, domains, host)

    def _emit_groups_from_packed(self, occupied, domains, host):
        n = len(occupied)
        cap = max(self.ctx.chunk_capacity, 1)
        group_cols = {}
        rem = occupied.copy()
        for (uid, dom) in zip(self.group_uids, domains):
            idx = rem % dom
            rem = rem // dom
            valid = idx != (dom - 1)
            group_cols[uid] = (idx, valid)
        out_arrays: Dict[str, tuple] = {}
        for c, (uid) in zip(self.schema[: len(self.group_uids)], self.group_uids):
            idx, valid = group_cols[uid]
            out_arrays[uid] = (idx.astype(c.type_.np_dtype), valid)
        for a in self.aggs:
            out_arrays[a.uid] = self._finalize_agg_host(a, host, occupied)
        self._chunks_from_host(out_arrays, n, cap)

    def _finalize_agg_host(self, a: AggSpec, host, occupied):
        cnt = host.get(f"{a.uid}.cnt")
        cnt = cnt[occupied] if cnt is not None else None
        if a.func == "count":
            return cnt.astype(np.int64), np.ones(len(occupied), dtype=np.bool_)
        if a.func in ("sum",):
            s = host[f"{a.uid}.sum"][occupied]
            hi = host.get(f"{a.uid}.sumhi")
            if hi is not None:
                s = combine_limbs_exact(s, hi[occupied])
            return s.astype(a.type_.np_dtype), cnt > 0
        if a.func == "avg":
            hi = host.get(f"{a.uid}.sumhi")
            if hi is not None:
                s = limbs_to_float(host[f"{a.uid}.sum"][occupied],
                                   hi[occupied])
            else:
                s = host[f"{a.uid}.sum"][occupied].astype(np.float64)
            if a.arg.type_.kind == TypeKind.DECIMAL:
                s = s / (10 ** a.arg.type_.scale)
            with np.errstate(divide="ignore", invalid="ignore"):
                avg = np.where(cnt > 0, s / np.maximum(cnt, 1), 0.0)
            return avg, cnt > 0
        if a.func == "min":
            return host[f"{a.uid}.min"][occupied].astype(a.type_.np_dtype), cnt > 0
        if a.func == "max":
            return host[f"{a.uid}.max"][occupied].astype(a.type_.np_dtype), cnt > 0
        raise ExecutionError(f"unknown aggregate {a.func}")

    def _chunks_from_host(self, out_arrays: Dict[str, tuple], n: int, cap: int):
        """Host result arrays -> output chunks (on the host: the groups are
        few and the root operators above run host-side)."""
        for start in range(0, max(n, 1), cap):
            end = min(start + cap, n)
            if n == 0 and self.group_exprs:
                break
            cols = {}
            for c in self.schema:
                data, valid = out_arrays[c.uid]
                cols[c.uid] = Column.from_numpy(
                    data[start:end], c.type_, valid=valid[start:end], capacity=cap
                )
            m = end - start
            sel = torch.zeros(cap, dtype=torch.bool)
            sel[:m] = True
            self._out.append(Chunk(cols, sel))
            if n == 0:
                break

    # ------------------------------------------------------------------
    # generic strategy (host groupby)
    # ------------------------------------------------------------------

    def _run_generic(self):
        from tidb_tpu_torch.planner.logical import core_generic_agg

        group_exprs, aggs = self.group_exprs, self.aggs
        if self.ctx.device_agg and core_generic_agg(group_exprs, aggs):
            self._run_generic_device()
            return
        runs = []
        total = 0
        for chunk in self.children[0].chunks():
            # the host groupby needs raw values: each chunk's evaluated
            # keys and arguments cross to the host once
            live = torch.nonzero(chunk.sel).squeeze(1)
            total += len(live)
            named = {}
            for k, g in enumerate(group_exprs):
                d, v = eval_expr(g, chunk)
                named[f"k{k}.d"] = d[live].cpu().numpy()
                named[f"k{k}.v"] = v[live].cpu().numpy()
            for j, a in enumerate(aggs):
                if a.arg is not None:
                    d, v = eval_expr(a.arg, chunk)
                    named[f"a{j}.d"] = d[live].cpu().numpy()
                    named[f"a{j}.v"] = v[live].cpu().numpy()
                else:
                    named[f"a{j}.d"] = np.ones(len(live), dtype=np.bool_)
                    named[f"a{j}.v"] = np.ones(len(live), dtype=np.bool_)
            runs.append(named)

        cap = self.ctx.chunk_capacity
        if total == 0:
            if self.group_exprs:
                self._out = []  # grouped agg over empty input -> no rows
                return
            # global aggregate over empty input: one row
            out_arrays = {}
            for c, a in zip(self.schema, self.aggs):
                if a.func == "count":
                    out_arrays[a.uid] = (np.zeros(1, dtype=np.int64), np.ones(1, dtype=np.bool_))
                elif a.func in _BIT_AGGS:
                    # BIT_* never return NULL: empty input keeps the
                    # identity (MySQL: BIT_AND()=all ones, others 0)
                    ident = _BIT_AGGS[a.func][1]
                    out_arrays[a.uid] = (np.full(1, ident, dtype=np.int64),
                                         np.ones(1, dtype=np.bool_))
                else:
                    out_arrays[a.uid] = (np.zeros(1, dtype=a.type_.np_dtype), np.zeros(1, dtype=np.bool_))
            self._chunks_from_host(out_arrays, 1, cap)
            return

        def cat(name):
            arrays = [r[name] for r in runs]
            return arrays[0] if len(arrays) == 1 else np.concatenate(arrays)

        self._run_generic_resident(total, cat, cap)

    def _run_generic_device(self):
        """Sort-based grouping on the device (agg_device.py): a partial
        group table per chunk, pairwise device merges, one batched fetch,
        the host finalize through the shared partial-state path."""
        from tidb_tpu_torch.executor.agg_device import GroupTableStack, make_partial_kernel
        from tidb_tpu_torch.executor.join import _to_device

        DEVICE_GENERIC_TOTAL["classic"] += 1
        partial = make_partial_kernel(self.group_exprs, self.aggs)
        stack = GroupTableStack(len(self.group_exprs), self.aggs)
        for chunk in self.children[0].chunks():
            # a host-side child (another aggregate's groups) moves over first
            stack.push(partial(_to_device(chunk, self.ctx.device)))
        self._finalize_group_tables(stack.tables())

    def _finalize_group_tables(self, tables):
        """ONE batched fetch of the device group tables (agg_device's
        fetch_tables: the slot counts, then every live slot in one copy),
        host merge, emit. Shared by the pull-based device path above and the
        fused scan->partial-agg pipeline (executor/pipeline.py), which
        accumulates the same tables from its staged batches."""
        from tidb_tpu_torch.executor.agg_device import fetch_tables, table_to_host_partial

        cap = self.ctx.chunk_capacity
        if not tables:
            self._out = []  # grouped agg over empty input -> no rows
            return
        host_tables = fetch_tables(tables)
        del tables
        # account the durable (ngroups-sliced) partial tables with the
        # same incremental discipline as the reference's host merge
        tracker = self.ctx.mem_tracker.child("hashagg.device")
        tracked = 0
        try:
            merged = None
            for t in host_tables:
                p = table_to_host_partial(t, len(self.group_exprs), self.aggs)
                b_p = _partial_nbytes(p)
                tracker.consume(b_p)
                tracked += b_p
                if merged is None:
                    merged = p
                else:
                    merged = self._merge_partials([merged, p])
                    b_m = _partial_nbytes(merged)
                    tracker.consume(b_m)
                    tracker.release(tracked)  # old merged + p are dead
                    tracked = b_m
            if len(host_tables) == 1 and len(self.group_exprs) > 1:
                # multi-key device tables order by a mixed hash; a
                # collision can split a group: exact dedup on the host
                merged = self._merge_partials([merged])
                b_m = _partial_nbytes(merged)
                tracker.consume(b_m)
                tracker.release(tracked)
                tracked = b_m
            self._emit_merged(merged, cap)
        finally:
            tracker.release(tracked)

    def _merge_partials(self, partials):
        """Merge partial group tables into one (final-agg merge step). Only
        the core functions reach it (core_generic_agg): the reference's
        bitwise and variance states belong to its spill path, not ported."""
        mats = np.concatenate([p["mat"] for p in partials], axis=0)
        ngroups, first_idx, inverse = _lexsort_groups(
            [mats[:, j] for j in range(mats.shape[1])])
        uniq = mats[first_idx]

        keys, kvalids = [], []
        for ki in range(len(self.group_exprs)):
            kcat = np.concatenate([p["keys"][ki] for p in partials])
            vcat = np.concatenate([p["kvalids"][ki] for p in partials])
            keys.append(kcat[first_idx])
            kvalids.append(vcat[first_idx])

        states = []
        for j, a in enumerate(self.aggs):
            cnt = np.zeros(ngroups, dtype=np.int64)
            np.add.at(cnt, inverse, np.concatenate([p["states"][j]["cnt"] for p in partials]))
            st = {"cnt": cnt}
            if a.func in ("sum", "avg"):
                parts = np.concatenate([p["states"][j]["sum"] for p in partials])
                s = np.zeros(ngroups, dtype=parts.dtype)
                np.add.at(s, inverse, parts)
                st["sum"] = s
                if "sumhi" in partials[0]["states"][j]:
                    ph = np.concatenate([p["states"][j]["sumhi"] for p in partials])
                    h = np.zeros(ngroups, dtype=np.int64)
                    np.add.at(h, inverse, ph)
                    # carry-normalize per merge so lo never wraps across
                    # arbitrarily deep merge chains
                    st["sum"], st["sumhi"] = normalize_limbs(s, h)
            elif a.func in ("min", "max"):
                op, ident = ((np.minimum, _min_identity) if a.func == "min"
                             else (np.maximum, _max_identity))
                parts = np.concatenate([p["states"][j][a.func] for p in partials])
                m = np.full(ngroups, ident(parts.dtype), dtype=parts.dtype)
                op.at(m, inverse, parts)
                st[a.func] = m
            states.append(st)
        return {"mat": uniq, "keys": keys, "kvalids": kvalids, "states": states}

    def _emit_merged(self, merged, cap):
        """Finalize a merged partial table into output chunks."""
        ngroups = len(merged["mat"])
        out_arrays: Dict[str, tuple] = {}
        nk = len(self.group_exprs)
        for ki, (uid, c) in enumerate(zip(self.group_uids, self.schema[:nk])):
            out_arrays[uid] = (merged["keys"][ki].astype(c.type_.np_dtype),
                               merged["kvalids"][ki])
        for j, a in enumerate(self.aggs):
            st = merged["states"][j]
            cnt = st["cnt"]
            if a.func == "count":
                out_arrays[a.uid] = (cnt, np.ones(ngroups, dtype=np.bool_))
            elif a.func == "sum":
                s = st["sum"]
                if "sumhi" in st:
                    s = combine_limbs_exact(s, st["sumhi"])
                out_arrays[a.uid] = (s.astype(a.type_.np_dtype), cnt > 0)
            elif a.func == "avg":
                sf = (limbs_to_float(st["sum"], st["sumhi"])
                      if "sumhi" in st else st["sum"].astype(np.float64))
                if a.arg.type_.kind == TypeKind.DECIMAL:
                    sf = sf / (10 ** a.arg.type_.scale)
                with np.errstate(divide="ignore", invalid="ignore"):
                    avg = np.where(cnt > 0, sf / np.maximum(cnt, 1), 0.0)
                out_arrays[a.uid] = (avg, cnt > 0)
            else:
                out_arrays[a.uid] = (st[a.func].astype(a.type_.np_dtype), cnt > 0)
        self._chunks_from_host(out_arrays, ngroups, cap)

    def _run_generic_resident(self, total, cat, cap):
        group_exprs, aggs = self.group_exprs, self.aggs
        keys = [cat(f"k{k}.d") for k in range(len(group_exprs))]
        kvalids = [cat(f"k{k}.v") for k in range(len(group_exprs))]
        avals = [cat(f"a{j}.d") for j in range(len(aggs))]
        avalids = [cat(f"a{j}.v") for j in range(len(aggs))]

        if keys:
            cols = ([self._to_int64_bits(k, kv) for k, kv in zip(keys, kvalids)]
                    + [kv.astype(np.int64) for kv in kvalids])
            ngroups, first_idx, inverse = _lexsort_groups(cols)
        else:
            ngroups = 1
            inverse = np.zeros(total, dtype=np.int64)
            first_idx = np.zeros(1, dtype=np.int64)

        out_arrays: Dict[str, tuple] = {}
        for uid, k, kv, c in zip(self.group_uids, keys, kvalids, self.schema):
            out_arrays[uid] = (k[first_idx].astype(c.type_.np_dtype), kv[first_idx])

        for a, vals, valids in zip(self.aggs, avals, avalids):
            out_arrays[a.uid] = self._generic_agg(a, vals, valids, inverse, ngroups)

        self._chunks_from_host(out_arrays, ngroups, cap)

    @staticmethod
    def _to_int64_bits(arr: np.ndarray, valid: np.ndarray) -> np.ndarray:
        a = np.where(valid, arr, 0)
        if np.issubdtype(a.dtype, np.floating):
            return a.astype(np.float64).view(np.int64)
        return a.astype(np.int64)

    def _generic_agg(self, a: AggSpec, vals, valids, inverse, ngroups):
        ok = valids.astype(np.bool_)
        if a.func == "group_concat":
            return self._group_concat(a, vals, ok, inverse, ngroups)
        if a.distinct:
            if a.func not in ("count", "sum", "avg", "min", "max",
                              "bit_and", "bit_or", "bit_xor") + _VAR_AGGS:
                raise UnsupportedError(f"DISTINCT {a.func}")
            bits = self._to_int64_bits(vals, ok)
            trip = np.stack([inverse[ok], bits[ok]], axis=1)
            uniq = np.unique(trip, axis=0)
            inverse = uniq[:, 0]
            vals = uniq[:, 1].astype(vals.dtype) if not np.issubdtype(vals.dtype, np.floating) else uniq[:, 1].view(np.float64)
            ok = np.ones(len(vals), dtype=np.bool_)

        cnt = np.zeros(ngroups, dtype=np.int64)
        np.add.at(cnt, inverse[ok], 1)
        if a.func == "count":
            return cnt, np.ones(ngroups, dtype=np.bool_)
        if a.func in ("sum", "avg"):
            if a.arg.type_.kind == TypeKind.DECIMAL:
                # two-limb exact host accumulation (same scheme as the
                # device states — see split_limbs)
                lo, hi = scatter_limbs(vals[ok], inverse[ok], ngroups)
                if a.func == "sum":
                    return (combine_limbs_exact(lo, hi).astype(
                        a.type_.np_dtype), cnt > 0)
                s = limbs_to_float(lo, hi) / (10 ** a.arg.type_.scale)
                with np.errstate(divide="ignore", invalid="ignore"):
                    return np.where(cnt > 0, s / np.maximum(cnt, 1), 0.0), cnt > 0
            s = np.zeros(ngroups, dtype=np.int64 if a.arg.type_.kind != TypeKind.FLOAT else np.float64)
            np.add.at(s, inverse[ok], vals[ok])
            if a.func == "sum":
                return s.astype(a.type_.np_dtype), cnt > 0
            s = s.astype(np.float64)
            with np.errstate(divide="ignore", invalid="ignore"):
                return np.where(cnt > 0, s / np.maximum(cnt, 1), 0.0), cnt > 0
        if a.func == "min":
            m = np.full(ngroups, _min_identity(vals.dtype), dtype=vals.dtype)
            np.minimum.at(m, inverse[ok], vals[ok])
            return m.astype(a.type_.np_dtype), cnt > 0
        if a.func == "max":
            m = np.full(ngroups, _max_identity(vals.dtype), dtype=vals.dtype)
            np.maximum.at(m, inverse[ok], vals[ok])
            return m.astype(a.type_.np_dtype), cnt > 0
        if a.func in _BIT_AGGS:
            op, ident = _BIT_AGGS[a.func]
            m = np.full(ngroups, ident, dtype=np.int64)
            op.at(m, inverse[ok], vals[ok].astype(np.int64))
            # MySQL BIT_* ignore NULLs and never return NULL; an empty
            # group keeps the identity (BIT_AND of nothing = all ones —
            # we keep the int64 bit pattern of the unsigned value)
            return m, np.ones(ngroups, dtype=np.bool_)
        if a.func in _VAR_AGGS:
            v = vals[ok]
            if a.arg.type_.kind == TypeKind.DECIMAL:
                v = v.astype(np.float64) / (10 ** a.arg.type_.scale)
            gcnt, _, m2 = _var_m2(v, inverse[ok], ngroups)
            return _var_finalize(a.func, gcnt, m2)
        raise ExecutionError(f"unknown aggregate {a.func}")

    def _gc_strings(self, a: AggSpec, vv: np.ndarray):
        """Decode GROUP_CONCAT argument values to their MySQL string
        forms (strings via the argument's dictionary; numerics/temporals
        formatted host-side)."""
        k = a.arg.type_.kind
        if k in (TypeKind.STRING, TypeKind.JSON):
            d = getattr(a.arg, "_dict", None)
            if d is None:
                raise UnsupportedError("GROUP_CONCAT over dictionary-less string")
            vals = d.values
            return [vals[int(c)] for c in vv]
        if k == TypeKind.DECIMAL:
            # integer divmod keeps scaled values > 2^53 exact (float
            # formatting would round them)
            s = a.arg.type_.scale
            f = 10 ** s

            def fmt(v):
                v = int(v)
                sign = "-" if v < 0 else ""
                q, r = divmod(abs(v), f)
                return f"{sign}{q}.{r:0{s}d}" if s else f"{sign}{q}"

            return [fmt(v) for v in vv]
        if k == TypeKind.FLOAT:
            return [repr(float(v)) for v in vv]
        if k in (TypeKind.INT, TypeKind.BOOL):
            return [str(int(v)) for v in vv]
        raise UnsupportedError(f"GROUP_CONCAT over {a.arg.type_}")

    def _group_concat(self, a: AggSpec, vals, ok, inverse, ngroups):
        """GROUP_CONCAT(x [ORDER BY x [DESC]] [SEPARATOR s]): per-group
        string joins on the host generic path. The output dictionary is
        a RuntimeDictionary filled per execution (result strings cannot
        exist at plan time)."""
        sep, order_desc, rdict = a.extra
        gi = inverse[ok]
        vv = np.asarray(vals)[ok]
        if order_desc is None:
            perm = np.argsort(gi, kind="stable")  # keep input order
        else:
            vkey = np.argsort(vv, kind="stable")
            if order_desc:
                vkey = vkey[::-1]
            perm = vkey[np.argsort(gi[vkey], kind="stable")]
        gi, vv = gi[perm], vv[perm]
        if a.distinct and len(gi):
            keep = np.ones(len(gi), dtype=np.bool_)
            seen = {}
            for i, (g, v) in enumerate(zip(gi.tolist(), vv.tolist())):
                if (g, v) in seen:
                    keep[i] = False
                seen[(g, v)] = True
            gi, vv = gi[keep], vv[keep]
        strs = self._gc_strings(a, vv)
        out = [None] * ngroups
        starts = np.flatnonzero(np.diff(gi, prepend=-1)) if len(gi) else []
        max_len = self.ctx.group_concat_max_len
        for si, s0 in enumerate(starts):
            s1 = starts[si + 1] if si + 1 < len(starts) else len(gi)
            joined = sep.join(strs[s0:s1])
            out[int(gi[s0])] = joined[: max_len]
        valid = np.array([o is not None for o in out], dtype=np.bool_)
        rdict.fill([o for o in out if o is not None])
        codes = np.array([rdict.code_of(o) if o is not None else 0
                          for o in out], dtype=np.int32)
        return codes, valid
