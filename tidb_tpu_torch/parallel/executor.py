"""Distributed executors: mesh fragments in the Volcano tree (counterpart
of tidb_tpu/parallel/executor.py).

build_dist_executor mirrors executor/builder.py but intercepts the plan
shapes that run as one collective fragment across the mesh:

  * HashAgg(segment) over fused Selection/Projection stages on one scan
    -> DistAggExec (scan + filter + partial aggregation per shard, psum
    merge), streamed in fixed batches past ctx.device_cache_bytes
  * HashAgg(segment) over an inner join of two scans on the build
    table's one-column primary key -> DistJoinAggExec (all_to_all
    repartition + local join)
  * any other distributable aggregation subtree -> DistFragmentExec
    (fragment.py: join trees, broadcasts, segment or generic
    aggregation, the per-shard top-k under a TopN)

Anything else falls back to the single-device executors, where the
reference falls back: a plan of point gets, shapes compile_fragment
refuses, a broadcast side above the limit, capacity retries past their
ceilings, and (full=False) joins and generic aggregation on one CPU.

Each fragment is one program of utils/jitcache.py (``cached_jit``), the
counterpart of the reference's ``jax.jit(shard_map(...))``: on the card
each execution after its warm-up is the replay of one captured CUDA
graph, collectives included (namespaces ``distagg``, ``distjoinagg``,
``fragment``, and ``aggcombine`` for the streaming paths' state merge,
whose state is donated). A resident sharding is a resident argument of
its programs, read where it lies: its serial is in their keys and their
owners, and when the ShardCache lets the sharding go (evict, a new
table version, its LRU, clear_tables, the cache's own end) a finalizer
drops them (``jitcache.drop_owner``). Streamed batches and broadcast
inputs are packed and copied in. Overflow counts come back as device
tensors that the executor fetches after the program, one round trip a
dispatch. A mesh over several cards runs its fragments eagerly.
"""

from __future__ import annotations

import itertools
import time
import weakref
from collections import OrderedDict
from typing import Dict, Optional

import numpy as np
import torch

from tidb_tpu_torch.errors import ExecutionError
from tidb_tpu_torch.executor.aggregate import HashAggExec
from tidb_tpu_torch.executor.base import Executor, raise_if_cancelled
from tidb_tpu_torch.executor.builder import build_executor, peel_stages, scan_stages_for
from tidb_tpu_torch.executor.pipeline import _graph_quota
from tidb_tpu_torch.executor.scan import ProjectionExec, SelectionExec
from tidb_tpu_torch.executor.sort import LimitExec, SortExec, TopNExec
from tidb_tpu_torch.parallel.distsql import make_agg_fragment, make_join_agg_fragment
from tidb_tpu_torch.parallel.fragment import compile_fragment, upload_broadcast
from tidb_tpu_torch.parallel.partition import ShardedTable, shard_table
from tidb_tpu_torch.planner.physical import (
    PHashAgg,
    PHashJoin,
    PLimit,
    PProjection,
    PScan,
    PSelection,
    PSort,
    PTopN,
    PhysicalPlan,
)
from tidb_tpu_torch.utils import dispatch, jitcache
from tidb_tpu_torch.utils.lru import touch

__all__ = ["ShardCache", "build_dist_executor", "DistAggExec", "DistJoinAggExec",
           "DistFragmentExec", "DIST_EXECUTORS", "FALLBACKS", "reset_fallbacks",
           "on_schema_change"]

# single-device fallbacks taken inside the mesh tier, by reason: the
# builder's routing ("pointy", "unsupported", "host_engine") and the
# executors' own ("broadcast_too_large", "growth_ceiling",
# "over_budget_unsupported")
FALLBACKS: Dict[str, int] = {}


def reset_fallbacks() -> None:
    FALLBACKS.clear()


def _fell_back(reason: str) -> None:
    FALLBACKS[reason] = FALLBACKS.get(reason, 0) + 1


def _note_fragment(exec_, kind: str, n_parts: int, t0: float) -> None:
    """Record one fragment execution: FRAGMENT_DISPATCH, the
    FRAGMENT_SECONDS histogram (with a trace_id exemplar) and a span
    `fragment.<kind>[parts=P]` on the statement's trace. Wall time covers
    the host's launches (eager torch: the device may still be busy)."""
    from tidb_tpu_torch.utils import tracing
    from tidb_tpu_torch.utils.metrics import FRAGMENT_DISPATCH, FRAGMENT_SECONDS

    dt = time.perf_counter() - t0
    FRAGMENT_DISPATCH.inc(kind=kind)
    tr = tracing.current()
    if tr is not None:
        tr.add_complete(f"fragment.{kind}[parts={n_parts}]", t0, dt,
                        parent_id=tracing.current_span_id())
    FRAGMENT_SECONDS.observe(dt, kind=kind)


_POOL_IDS = itertools.count()
_CACHE_IDS = itertools.count()


def _statement_pool(ctx, cache: "ShardCache") -> str:
    """The memory pool (utils/jitcache.py) of the mesh programs a statement
    builds on `cache`'s mesh: a fragment's graph holds its whole working
    memory, a statement's fragments replay one after another and may
    share it, and the graph quota then takes a statement's graphs as one
    unit. The pool is the statement's digest's on this cache, so the
    programs a later execution builds (a plan that plan feedback moved, a
    grown capacity) capture into the memory of the earlier ones instead
    of a pool beside them; a statement without a digest has its own."""
    pool = getattr(ctx, "mesh_pool", None)
    if pool is None:
        digest = getattr(ctx, "stmt_digest", "")
        pool = ctx.mesh_pool = (f"mesh{cache.serial}:{digest}" if digest
                                else f"mesh{cache.serial}#{next(_POOL_IDS)}")
    return pool


def _segment_state_combine(state, part):
    """Elementwise merge of a batch's segment state `part` into the packed
    `state` (sum/min/max per key by merge_op_for), in place: the
    streaming paths' batch merge, the "aggcombine" program (its state
    donated). Returns the state."""
    from tidb_tpu_torch.executor.aggregate import merge_op_for

    out = {}
    for k, v in state.items():
        op = merge_op_for(k)
        w = part[k].to(v.device)
        if op == "sum":
            out[k] = v + w
        elif op == "min":
            out[k] = torch.minimum(v, w)
        else:
            out[k] = torch.maximum(v, w)
    return jitcache.update_packed(state, out)


def _timed_combine(state, part, ctx, cache):
    """The running streamed state with a batch's `part` merged in (the
    first part, packed, when `state` is None), timed into
    COLLECTIVE_MERGE_SECONDS."""
    from tidb_tpu_torch.utils.metrics import COLLECTIVE_MERGE_SECONDS

    t0 = time.perf_counter()
    if state is None:
        out = jitcache.packed(dict(part))
    else:
        combine = jitcache.cached_jit("aggcombine", repr(tuple(state)),
                                      lambda: _segment_state_combine,
                                      donate_argnums=(0,), max_bytes=_graph_quota(ctx),
                                      pool=_statement_pool(ctx, cache))
        out = combine(state, part)
    COLLECTIVE_MERGE_SECONDS.observe(time.perf_counter() - t0)
    return out


# every live ShardCache, for the catalog's schema-change hook
_CACHES: "weakref.WeakSet" = weakref.WeakSet()


def on_schema_change() -> None:
    """Drop every cache's table shardings (a catalog's schema_version
    moved), as the device buffer cache clears on DDL."""
    for cache in list(_CACHES):
        cache.clear_tables()


class ShardCache:
    """(table identity, version) -> ShardedTable: the region-cache
    analogue, invalidated by table mutation (version bump) and by any
    schema change. The entry pins the host table object so a recycled
    id() can never alias a different table; a small LRU bounds how many
    dead tables' device copies stay resident. Fragment programs live in
    utils/jitcache.py under keys that name this cache's mesh (get_fragment);
    the programs that read a sharding go when the sharding does. Also
    keeps the proven exchange growth per join signature, so a skewed join
    does not replay known-overflowing capacities."""

    MAX_TABLES = 16
    MAX_FRAGMENTS = 128

    def __init__(self, mesh):
        self.mesh = mesh
        self.serial = next(_CACHE_IDS)  # names its statements' memory pools
        self._cache: "OrderedDict[int, tuple]" = OrderedDict()
        self.growth: "OrderedDict[object, object]" = OrderedDict()
        _CACHES.add(self)

    def get(self, table, encode: bool = False) -> ShardedTable:
        hit = self._cache.get(id(table))
        if hit is not None:
            held, version, enc0, st = hit
            if held is table and version == table.version and enc0 == encode:
                self._cache.move_to_end(id(table))
                return st
        st = shard_table(table, self.mesh, encode=encode)
        # whichever way this cache lets the sharding go, the programs that
        # read it in place go with it (their graphs hold none of it)
        weakref.finalize(st, jitcache.drop_owner, st.serial)
        self._cache[id(table)] = (table, table.version, encode, st)
        self._cache.move_to_end(id(table))
        while len(self._cache) > self.MAX_TABLES:
            self._cache.popitem(last=False)
        return st

    def evict(self, table) -> None:
        """Drop a table's resident sharding (it grew past the device-cache
        budget and the streaming path takes over)."""
        self._cache.pop(id(table), None)

    def clear_tables(self) -> None:
        self._cache.clear()

    def __len__(self) -> int:
        return len(self._cache)

    def get_fragment(self, key, build, ctx, ns: str, resident=(), owners=()):
        """The fragment program for `key` (a tuple naming all the program
        bakes in, `owners` too): a jitcache.cached_jit program in namespace
        `ns` over this cache's mesh whose `resident` arguments are the
        shardings whose serials are `owners`, read in place; it goes with
        any of them. Built under the statement `ctx`, it joins that
        statement's memory pool. Each call counts one fragment dispatch."""
        fn = jitcache.cached_jit(ns, repr((key, repr(self.mesh))), build,
                                 resident_argnums=resident, owners=owners,
                                 max_bytes=_graph_quota(ctx), pool=_statement_pool(ctx, self))

        def dispatch_fn(*args):
            dispatch.record_fragment()
            return fn(*args)

        return dispatch_fn

    def get_growth(self, gkey) -> tuple:
        """(growth, probe mode override or None) last proven for `gkey`."""
        g = self.growth.get(gkey)
        if g is None:
            return 2.0, None
        self.growth.move_to_end(gkey)
        return g

    def put_growth(self, gkey, growth: float, mode=None) -> None:
        touch(self.growth, gkey, (growth, mode), self.MAX_FRAGMENTS)


def _types_sig(st: ShardedTable) -> str:
    """Schema signature of a sharding: a fragment program closes over its
    column types, so cache keys distinguish shardings by them."""
    return repr(sorted((n, t) for n, t in st.types.items()))


def _collapse_to_scan(plan: PhysicalPlan):
    """Fuse a Selection/Projection chain onto one scan: (scan, stages), or
    None if the subtree is not a pushable pipeline."""
    stages, base = peel_stages(plan)
    if not isinstance(base, PScan) or base.table is None:
        return None
    return base, scan_stages_for(base, stages)


def _uid_map(scan: PScan) -> Dict[str, str]:
    return {c.name: c.uid for c in scan.schema}


def _fetch_parts(out) -> list:
    """Host copies of per-part group tables: every part's slot count in
    one copy, then every part's live slots in one more (agg_device's
    finalize fetch, over the first part's device)."""
    from tidb_tpu_torch.executor.agg_device import fetch_tables

    dev0 = out[0]["n"].device
    return fetch_tables([{k: v.to(dev0) for k, v in t.items()} for t in out])


class DistAggExec(HashAggExec):
    """Segment aggregation whose input is a sharded scan fragment."""

    def __init__(self, plan: PHashAgg, scan: PScan, stages, cache: ShardCache):
        super().__init__(plan.schema, None, plan.group_exprs, plan.group_uids,
                         plan.aggs, "segment",
                         segment_sizes=getattr(plan, "segment_sizes", None))
        self.children = []
        self._scan = scan
        self._stages = stages
        self._cache = cache

    # per-part staging batch of the streaming path (rows; a batch holds
    # P * this many rows of the scanned columns)
    STREAM_ROWS_PER_PART = 1 << 20

    def _run_segment(self):
        from tidb_tpu_torch.parallel.partition import table_bytes

        sizes = self.segment_sizes or []
        domains = [s + 1 for s in sizes]
        table = self._scan.table
        scan_cols = [c.name for c in self._scan.schema]
        # gate on the FULL table size: the resident path shards every
        # column; streaming stages only the scanned columns
        if table_bytes(table) > self.ctx.device_cache_bytes:
            self._cache.evict(table)
            self._run_segment_streaming(domains, scan_cols)
            return
        # a resident sharding stages once and serves many executions, so it
        # stages raw: encoding pays on the streaming paths, whose bytes
        # move on every batch
        st = self._cache.get(table)
        uid_map = _uid_map(self._scan)
        key = ("agg", repr((self._stages, self.group_exprs, self.aggs, domains)),
               st.n_parts, st.rows_per_part, _types_sig(st), repr(uid_map),
               (st.serial,))
        fn = self._cache.get_fragment(
            key,
            lambda: make_agg_fragment(st, self._stages, self.group_exprs,
                                      self.aggs, domains, uid_map=uid_map),
            self.ctx, ns="distagg", resident=(0,), owners=(st.serial,))
        t0 = time.perf_counter()
        state = fn(st.args())
        _note_fragment(self, "scan_agg", st.n_parts, t0)
        self._finalize_segment_state(state, domains)

    def _run_segment_streaming(self, domains, scan_cols):
        """Tables above the budget: fixed [P, R] staging batches through one
        fragment program, the [G] states combined on the device, one
        fetch at the end."""
        from tidb_tpu_torch.parallel.partition import stream_batches

        table = self._scan.table
        mesh = self._cache.mesh
        sig = repr((self._stages, self.group_exprs, self.aggs, domains))
        uid_map = _uid_map(self._scan)
        state = None
        fn = None
        enc = self.ctx.stage_encoded
        for st in stream_batches(table, mesh, scan_cols,
                                 self.STREAM_ROWS_PER_PART, encode=enc):
            raise_if_cancelled(self.ctx)
            if fn is None:
                key = ("agg", sig, st.n_parts, st.rows_per_part, _types_sig(st),
                       repr(uid_map), "stream")
                fn = self._cache.get_fragment(
                    key,
                    lambda st=st: make_agg_fragment(
                        st, self._stages, self.group_exprs, self.aggs,
                        domains, uid_map=uid_map),
                    self.ctx, ns="distagg")
            t0 = time.perf_counter()
            part = fn(st.args())
            _note_fragment(self, "scan_agg_stream", st.n_parts, t0)
            state = _timed_combine(state, part, self.ctx, self._cache)
        self._finalize_segment_state(state, domains)


class DistJoinAggExec(HashAggExec):
    """Segment aggregation over a repartition join of two sharded scans."""

    def __init__(self, plan: PHashAgg, join: PHashJoin,
                 probe_scan, probe_stages, build_scan, build_stages,
                 post_stages, cache: ShardCache):
        super().__init__(plan.schema, None, plan.group_exprs, plan.group_uids,
                         plan.aggs, "segment",
                         segment_sizes=getattr(plan, "segment_sizes", None))
        self.children = []
        self._plan = plan
        self._delegate = None
        self._join = join
        self._probe_scan, self._probe_stages = probe_scan, probe_stages
        self._build_scan, self._build_stages = build_scan, build_stages
        self._post_stages = post_stages
        self._cache = cache

    def next(self):
        if self._delegate is not None:
            return self._delegate.next()
        return super().next()

    def close(self):
        if self._delegate is not None:
            self._delegate.close()
            self._delegate = None
        super().close()

    def _run_segment(self):
        from tidb_tpu_torch.parallel.partition import table_bytes

        sizes = self.segment_sizes or []
        domains = [s + 1 for s in sizes]
        join = self._join
        if max(table_bytes(self._probe_scan.table),
               table_bytes(self._build_scan.table)) > self.ctx.device_cache_bytes:
            # a side above the budget: the general fragment path streams it
            # in fixed batches; this resident path cannot
            mesh = self._cache.mesh
            prog = compile_fragment(self._plan, mesh, mesh.n_parts)
            if prog is not None:
                d = DistFragmentExec(self._plan, prog, self._cache)
            else:
                # never shard an over-budget table resident
                _fell_back("over_budget_unsupported")
                d = build_executor(self._plan)
            self._delegate = d
            d.open(self.ctx)
            return
        probe_idx = 1 - join.build_side
        probe_keys = join.eq_left if probe_idx == 0 else join.eq_right
        build_keys = join.eq_right if join.build_side == 1 else join.eq_left
        probe_st = self._cache.get(self._probe_scan.table)
        build_st = self._cache.get(self._build_scan.table)
        sig = repr((self._probe_stages, self._build_stages, probe_keys[0],
                    build_keys[0], self._post_stages, self.group_exprs,
                    self.aggs, domains))
        probe_uids, build_uids = _uid_map(self._probe_scan), _uid_map(self._build_scan)
        serials = (probe_st.serial, build_st.serial)
        # start from the growth (and the probe route) that last worked for
        # this signature on this data version; keyed on serials, so it
        # resets when the data changes
        gkey = (sig,) + serials
        growth, mode = self._cache.get_growth(gkey)
        probe_mode = mode or self.ctx.join_probe_mode
        while growth <= 16.0:
            key = ("joinagg", sig, growth, probe_st.n_parts,
                   probe_st.rows_per_part, build_st.rows_per_part,
                   _types_sig(probe_st), _types_sig(build_st), probe_mode,
                   repr((probe_uids, build_uids)), serials)
            fn = self._cache.get_fragment(
                key,
                lambda: make_join_agg_fragment(
                    probe_st, build_st,
                    self._probe_stages, self._build_stages,
                    probe_keys[0], build_keys[0], probe_uids, build_uids,
                    self._post_stages, self.group_exprs, self.aggs, domains,
                    growth=growth, probe_mode=probe_mode),
                self.ctx, ns="distjoinagg", resident=(0, 1), owners=serials)
            t0 = time.perf_counter()
            state, ovf, unplaced = fn(probe_st.args(), build_st.args())
            # host-sync: the exchange's overflow and the table's placement
            # gate the retry; one fetch per dispatch, after the program
            ovf, unplaced = dispatch.device_get((ovf, unplaced))
            if unplaced:
                probe_mode = "off"  # a run the table left unplaced: sorted route
                continue
            if ovf == 0:
                _note_fragment(self, "join_agg", probe_st.n_parts, t0)
                self._cache.put_growth(gkey, growth,
                                       probe_mode if probe_mode == "off" else None)
                break
            growth *= 2  # a skewed exchange: retry with bigger buckets
        else:
            raise ExecutionError("join exchange overflow persisted at growth=16x")
        self._finalize_segment_state(state, domains)


class _BroadcastTooLarge(Exception):
    def __init__(self, rows):
        super().__init__(f"broadcast side too large ({rows} rows)")


class DistFragmentExec(HashAggExec):
    """Aggregation root over a general compiled fragment (fragment.py):
    join trees, broadcast build sides, segment or generic aggregation; one
    mesh execution per statement, with per-knob capacity retry."""

    # "compact" knobs have no ceiling (their cap is min'd against the
    # static capacity, so growth converges in O(log) retries); "expand"
    # jumps to the reported factor; the ceilings guard against absurd
    # buffers for pathological skew
    MAX_GROWTH = {"exch": 64.0, "expand": 65536.0, "compact": float("inf"),
                  "route": 2.0}

    def __init__(self, plan: PHashAgg, prog, cache: ShardCache):
        super().__init__(plan.schema, None, plan.group_exprs, plan.group_uids,
                         plan.aggs, plan.strategy,
                         segment_sizes=getattr(plan, "segment_sizes", None))
        self.children = []
        self._plan = plan
        self._prog = prog
        self._cache = cache
        self._delegate = None

    def _run_segment(self):
        self._run_fragment()

    def _run_generic(self):
        self._run_fragment()

    def next(self):
        if self._delegate is not None:
            return self._delegate.next()
        return super().next()

    def close(self):
        if self._delegate is not None:
            self._delegate.close()
            self._delegate = None
        super().close()

    def _fall_back_single_chip(self, reason: str):
        """Run the plan on the single-device executors instead of failing
        the query (the reference's root-task fallback)."""
        _fell_back(reason)
        root = build_executor(self._plan)
        self._delegate = root
        root.open(self.ctx)

    # ------------------------------------------------------------------

    def _gather_broadcasts(self, prog):
        """Materialize every broadcast subtree and put it on the mesh's
        devices ahead of the program: (args, shapes). A subtree above the
        limit raises _BroadcastTooLarge, which the runners turn into a
        single-device fallback."""
        args, shapes = [], []
        limit = self.ctx.broadcast_rows_limit
        for bc in prog.broadcasts:
            data, valid, sel, n = self._materialize_broadcast(bc)
            if n > limit:
                raise _BroadcastTooLarge(n)
            args.append(upload_broadcast(data, valid, sel, self._cache.mesh))
            shapes.append(len(sel))
        return args, shapes

    def _materialize_broadcast(self, bc):
        """Run a non-scan subtree (through the distributed builder, so an
        aggregation-rooted build side runs as a mesh fragment too) and
        return its host (data, valid, sel, n), padded to a power of two."""
        root = build_dist_executor(bc.plan, self._cache)
        datas = {c.uid: [] for c in bc.schema}
        valids = {c.uid: [] for c in bc.schema}
        n = 0
        try:
            root.open(self.ctx)
            for ch in root.chunks():
                # host-sync: a broadcast build side is materialized on the
                # host; one batched fetch per chunk of the subtree
                sel, cols = dispatch.device_get(
                    (ch.sel, [(ch.columns[c.uid].data, ch.columns[c.uid].valid)
                              for c in bc.schema]))
                live = np.nonzero(sel)[0]
                n += len(live)
                for c, (d, v) in zip(bc.schema, cols):
                    datas[c.uid].append(d[live])
                    valids[c.uid].append(v[live])
        finally:
            root.close()
        cap = 1
        while cap < max(n, 1):
            cap *= 2
        data, valid = {}, {}
        for c in bc.schema:
            d = (np.concatenate(datas[c.uid]) if datas[c.uid]
                 else np.zeros(0, dtype=c.type_.np_dtype))
            v = (np.concatenate(valids[c.uid]) if valids[c.uid]
                 else np.zeros(0, dtype=np.bool_))
            db = np.zeros(cap, dtype=d.dtype)
            vb = np.zeros(cap, dtype=np.bool_)
            db[:n], vb[:n] = d, v
            data[c.uid], valid[c.uid] = db, vb
        sel = np.zeros(cap, dtype=np.bool_)
        sel[:n] = True
        return data, valid, sel, n

    def _pick_stream_source(self, prog):
        """Index of the source to stream, or None: a table above the
        device-cache budget that appears once among the sources (a
        self-join of a streamed table would pair only same-batch rows)
        and is not on a non-inner join's build side."""
        from tidb_tpu_torch.parallel.partition import table_bytes

        best, best_bytes = None, 0
        for i, src in enumerate(prog.sources):
            if i in prog.stream_unsafe:
                continue
            b = table_bytes(src.scan.table)
            if b > self.ctx.device_cache_bytes and b > best_bytes:
                best, best_bytes = i, b
        if best is None:
            return None
        t = prog.sources[best].scan.table
        if sum(1 for s in prog.sources if s.scan.table is t) != 1:
            return None
        return best

    def _run_fragment(self):
        prog = self._prog
        stream_idx = self._pick_stream_source(prog)
        if stream_idx is not None:
            self._run_fragment_streaming(prog, stream_idx)
            return
        args, sts = [], []
        for src in prog.sources:
            st = self._cache.get(src.scan.table)  # resident shardings stage raw
            args.append(st.args())
            sts.append(st)
        try:
            bcast_args, bcast_shapes = self._gather_broadcasts(prog)
        except _BroadcastTooLarge:
            self._fall_back_single_chip("broadcast_too_large")
            return
        args += bcast_args

        serials = tuple(st.serial for st in sts)
        gkey = (prog.sig,) + serials
        growths = self._cache.growth.get(gkey) or prog.growth_defaults
        shapes_sig = (tuple((st.n_parts, st.rows_per_part) for st in sts),
                      tuple(bcast_shapes))
        types_sig = tuple(_types_sig(st) for st in sts)
        t0 = time.perf_counter()
        out, growths = self._dispatch_retry(prog, args, shapes_sig, types_sig, growths,
                                            tuple(range(len(sts))), serials)
        if out is None:
            self._fall_back_single_chip("growth_ceiling")
            return
        _note_fragment(self, f"general_{prog.out_kind}",
                       sts[0].n_parts if sts else 0, t0)
        touch(self._cache.growth, gkey, growths, ShardCache.MAX_FRAGMENTS)

        if prog.out_kind == "segment":
            self._finalize_segment_state(out, prog.domains)
        else:
            self._finalize_generic_tables(out)

    def _dispatch_retry(self, prog, args, shapes_sig, types_sig, growths,
                        resident, serials):
        """Run the fragment, growing only blown capacity knobs: "exch" knobs
        double; "expand" and "compact" jump to the reported factor in one
        step; a "route" knob moves its join to the sorted route. The
        sources at `resident` are resident shardings (their `serials`),
        read in place. Returns (out, growths), or (None, growths) past a
        ceiling."""
        # the statement's probe mode is a static of the program: part of
        # the cache key, so a sysvar flip never serves the other route
        probe_mode = self.ctx.join_probe_mode
        while True:
            raise_if_cancelled(self.ctx)
            key = ("frag", prog.sig, growths, shapes_sig, types_sig, probe_mode,
                   resident, serials)
            fn = self._cache.get_fragment(
                key, lambda: prog.build_fn(growths, probe_mode=probe_mode),
                self.ctx, ns="fragment", resident=resident, owners=serials)
            out, ovf = fn(*args)
            if ovf is None:
                return out, growths
            # host-sync: the per-knob overflow vector gates the capacity
            # retry; one fetch per dispatch, after the program
            ovf = dispatch.device_get(ovf)
            if not (ovf > 0).any():
                return out, growths
            new = []
            for g, o, kind in zip(growths, ovf, prog.growth_kinds):
                if o <= 0:
                    new.append(g)
                elif kind in ("expand", "compact"):
                    factor = int(o) + 1
                    mult = 1
                    while mult < factor:
                        mult *= 2
                    new.append(g * max(mult, 2))
                else:
                    new.append(g * 2)
            growths = tuple(new)
            if any(g > self.MAX_GROWTH[k] for g, k in zip(growths, prog.growth_kinds)):
                return None, growths

    def _run_fragment_streaming(self, prog, stream_idx):
        """A source above the budget streams through the fragment in fixed
        [P, R] batches against resident build sides. Segment states merge
        on the device across batches; generic group tables merge per part
        on the host (parts stay disjoint: the routing is the same every
        batch)."""
        from tidb_tpu_torch.executor.agg_device import table_to_host_partial
        from tidb_tpu_torch.parallel.partition import stream_batches

        mesh = self._cache.mesh
        if prog.topn is not None:
            # a group's partials span batches: a per-batch top-k would drop
            # state a later batch needs, so recompile without it
            prog = compile_fragment(prog.agg, mesh, mesh.n_parts)
            if prog is None:
                self._fall_back_single_chip("unsupported")
                return
        src = prog.sources[stream_idx]
        table = src.scan.table
        self._cache.evict(table)  # its full sharding must not stay resident
        scan_cols = [c.name for c in src.scan.schema]
        n_parts = mesh.n_parts
        bytes_per_row = sum(table.data[n].dtype.itemsize + 1 for n in scan_cols) + 1
        rows_per_part = max(4096, int(
            self.ctx.device_cache_bytes // (4 * n_parts * bytes_per_row)))

        # the streamed source stages encoded (its bytes move every batch);
        # resident co-sources stay raw
        enc = self.ctx.stage_encoded
        sts = {}
        for i, s2 in enumerate(prog.sources):
            if i != stream_idx:
                sts[i] = self._cache.get(s2.scan.table)
        try:
            bcast_args, bcast_shapes = self._gather_broadcasts(prog)
        except _BroadcastTooLarge:
            self._fall_back_single_chip("broadcast_too_large")
            return

        resident = tuple(sorted(sts))
        serials = tuple(sts[i].serial for i in resident)
        gkey = (prog.sig, "stream", rows_per_part) + serials
        growths = self._cache.growth.get(gkey) or prog.growth_defaults
        types_fixed = tuple(_types_sig(sts[i]) for i in resident)

        seg_state = None
        gen_parts = None  # part index -> [host partials]
        nk = len(self.group_exprs)
        for batch in stream_batches(table, mesh, scan_cols, rows_per_part, encode=enc):
            # a KILL or deadline interrupts between batches
            raise_if_cancelled(self.ctx)
            args, shapes = [], []
            for i in range(len(prog.sources)):
                st = batch if i == stream_idx else sts[i]
                args.append(st.args())
                shapes.append((st.n_parts, st.rows_per_part))
            args += bcast_args
            shapes_sig = (tuple(shapes), tuple(bcast_shapes))
            types_sig = types_fixed + (_types_sig(batch), "stream")
            t0 = time.perf_counter()
            out, growths = self._dispatch_retry(prog, args, shapes_sig, types_sig, growths,
                                                resident, serials)
            if out is None:
                self._fall_back_single_chip("growth_ceiling")
                return
            _note_fragment(self, f"general_{prog.out_kind}_stream", batch.n_parts, t0)
            if prog.out_kind == "segment":
                seg_state = _timed_combine(seg_state, out, self.ctx, self._cache)
            else:
                # per-part group tables merge on the host across batches,
                # one batched fetch per batch
                hosts = _fetch_parts(out)
                if gen_parts is None:
                    gen_parts = [[] for _ in hosts]
                for pi, t in enumerate(hosts):
                    if int(t["n"]):
                        gen_parts[pi].append(table_to_host_partial(t, nk, self.aggs))
        touch(self._cache.growth, gkey, growths, ShardCache.MAX_FRAGMENTS)

        if prog.out_kind == "segment":
            self._finalize_segment_state(seg_state, prog.domains)
            return
        cap = self.ctx.chunk_capacity
        merged_parts = []
        for partials in (gen_parts or []):
            if not partials:
                continue
            # one key appears in several batches of a part: exact merge
            merged_parts.append(partials[0] if len(partials) == 1
                                else self._merge_partials(partials))
        if not merged_parts:
            self._out = []
            return
        # parts are disjoint across the exchange: concatenate, emit once
        if self.group_exprs:
            self._emit_merged(self._concat_partials(merged_parts), cap)
        else:
            self._emit_merged(self._merge_partials(merged_parts), cap)

    @staticmethod
    def _concat_partials(partials):
        """Concatenate DISJOINT host partials (exchange-routed parts of one
        group space) into one partial, so the root emits once."""
        if len(partials) == 1:
            return partials[0]
        out = {
            "mat": np.concatenate([p["mat"] for p in partials], axis=0),
            "keys": [np.concatenate(ks) for ks in zip(*(p["keys"] for p in partials))],
            "kvalids": [np.concatenate(ks)
                        for ks in zip(*(p["kvalids"] for p in partials))],
        }
        states = []
        for j in range(len(partials[0]["states"])):
            states.append({k: np.concatenate([p["states"][j][k] for p in partials])
                           for k in partials[0]["states"][j]})
        out["states"] = states
        return out

    def _finalize_generic_tables(self, out):
        """Fetch the per-part group tables, concatenate the disjoint parts
        and emit once. The exchange routes every key to one part and the
        per-part reduce is exact, so no cross-part merge exists."""
        from tidb_tpu_torch.executor.agg_device import table_to_host_partial

        nk = len(self.group_exprs)
        cap = self.ctx.chunk_capacity
        partials = [table_to_host_partial(t, nk, self.aggs)
                    for t in _fetch_parts(out) if int(t["n"])]
        if not partials:
            self._out = []  # no groups anywhere
            return
        if nk == 0:
            # keyless partials are not disjoint: exact merge instead
            self._emit_merged(self._merge_partials(partials), cap)
            return
        self._emit_merged(self._concat_partials(partials), cap)


# the executors that run on the mesh (anything else in a mesh session's
# tree is a single-device executor)
DIST_EXECUTORS = (DistAggExec, DistJoinAggExec, DistFragmentExec)


def _try_dist_agg(plan: PHashAgg, cache: ShardCache) -> Optional[Executor]:
    if plan.strategy != "segment":
        return None
    scan_frag = _collapse_to_scan(plan.child)
    if scan_frag is not None:
        scan, stages = scan_frag
        return DistAggExec(plan, scan, stages, cache)
    post_stages, node = peel_stages(plan.child)
    if not isinstance(node, PHashJoin) or node.kind != "inner":
        return None
    if len(node.eq_left) != 1 or node.other_cond is not None:
        return None
    probe_idx = 1 - node.build_side
    probe_frag = _collapse_to_scan(node.children[probe_idx])
    build_frag = _collapse_to_scan(node.children[node.build_side])
    if probe_frag is None or build_frag is None:
        return None
    # the unique-build-key requirement: only when the build key is the
    # build table's one-column primary key
    build_scan = build_frag[0]
    build_keys = node.eq_right if node.build_side == 1 else node.eq_left
    from tidb_tpu_torch.expression.expr import ColumnRef

    pk = getattr(build_scan.table.schema, "primary_key", None)
    key_ir = build_keys[0]
    key_col = key_ir.name if isinstance(key_ir, ColumnRef) else None
    pk_uids = []
    if pk:
        by_name = {c.name: c.uid for c in build_scan.schema}
        pk_uids = [by_name.get(n) for n in pk]
    if not (len(pk_uids) == 1 and key_col == pk_uids[0]):
        return None
    return DistJoinAggExec(plan, node, probe_frag[0], probe_frag[1],
                           build_frag[0], build_frag[1], post_stages, cache)


def _all_scans_pointy(plan: PhysicalPlan) -> bool:
    """True when every base-table access is a point get (or tiny): the
    whole plan touches a handful of rows and the host path wins. A point
    get leaf inside a big join does not drag the plan off the mesh."""
    from tidb_tpu_torch.planner.physical import PIndexRangeScan, PPointGet

    found = False
    stack = [plan]
    while stack:
        node = stack.pop()
        if isinstance(node, PPointGet):
            found = True
        elif isinstance(node, PIndexRangeScan):
            # a selective range behaves like a point get; a wide one stays
            # eligible for the mesh like any big scan
            if node.est_rows <= 4096:
                found = True
            else:
                return False
        elif isinstance(node, PScan) and node.table is not None:
            if node.table.n > 4096:
                return False
        stack.extend(getattr(node, "children", ()))
    return found


def _try_dist_topn(plan, cache) -> Optional[Executor]:
    """A TopN whose sort keys resolved onto a generic aggregation below
    (the planner's resolve_topn_pushdown): compile the fragment with a
    per-shard partial top-k, so only n_parts * k candidate groups reach
    the host; the root TopNExec orders that superset exactly."""
    if getattr(plan, "pushdown", None) is None:
        return None
    agg, items = plan.pushdown
    k = plan.count + plan.offset  # bounds pre-checked by the resolver
    prog = compile_fragment(agg, cache.mesh, cache.mesh.n_parts, topn=(tuple(items), k))
    if prog is None:
        return None
    ex: Executor = DistFragmentExec(agg, prog, cache)
    chain = []
    node = plan.child
    while isinstance(node, PProjection):
        chain.append(node)
        node = node.child
    if node is not agg:
        return None  # the resolver and the builder walked different chains
    for p in reversed(chain):
        ex = ProjectionExec(p.schema, ex, p.exprs)
    return TopNExec(plan.schema, ex, plan.items, plan.count, plan.offset)


def build_dist_executor(plan: PhysicalPlan, cache: ShardCache,
                        full: bool = True) -> Executor:
    """Build an executor tree, running distributable fragments on the mesh.

    full=False (one CPU shard) distributes only segment scan-aggregation
    fragments; joins and generic aggregation run on the single-device
    executors, as the reference routes its single-CPU backend."""
    if _all_scans_pointy(plan):
        _fell_back("pointy")
        return build_executor(plan)
    if isinstance(plan, PHashAgg):
        if not full:
            if plan.strategy == "segment":
                frag = _collapse_to_scan(plan.child)
                if frag is not None:
                    return DistAggExec(plan, frag[0], frag[1], cache)
            _fell_back("host_engine")
            return build_executor(plan)
        ex = _try_dist_agg(plan, cache)  # the fixed shapes first
        if ex is not None:
            return ex
        prog = compile_fragment(plan, cache.mesh, cache.mesh.n_parts)
        if prog is not None:
            return DistFragmentExec(plan, prog, cache)
        if _collapse_to_scan(plan.child) is None:
            # the aggregation itself is not distributable (aggregation over
            # aggregation, DISTINCT...) but its subtree may be: the root
            # runs on the host over a distributed child
            return HashAggExec(
                plan.schema, build_dist_executor(plan.child, cache, full),
                plan.group_exprs, plan.group_uids, plan.aggs, plan.strategy,
                segment_sizes=getattr(plan, "segment_sizes", None))
        _fell_back("unsupported")
        return build_executor(plan)
    if isinstance(plan, (PProjection, PSelection)):
        # a fusible chain over a plain scan has no collective fragment: the
        # single-device builder fuses it into one scan pipeline
        _, base = peel_stages(plan)
        if isinstance(base, PScan):
            return build_executor(plan)
        if isinstance(plan, PProjection):
            return ProjectionExec(plan.schema, build_dist_executor(plan.child, cache, full),
                                  plan.exprs)
        return SelectionExec(plan.schema, build_dist_executor(plan.child, cache, full),
                             plan.cond)
    if isinstance(plan, PSort):
        return SortExec(plan.schema, build_dist_executor(plan.child, cache, full), plan.items)
    if isinstance(plan, PTopN):
        if full:
            ex = _try_dist_topn(plan, cache)
            if ex is not None:
                return ex
        return TopNExec(plan.schema, build_dist_executor(plan.child, cache, full),
                        plan.items, plan.count, plan.offset)
    if isinstance(plan, PLimit):
        return LimitExec(plan.schema, build_dist_executor(plan.child, cache, full),
                         plan.count, plan.offset)
    return build_executor(plan)
