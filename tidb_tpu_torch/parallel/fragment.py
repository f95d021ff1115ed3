"""General distributed fragments: an aggregation-rooted plan subtree
compiled into ONE per-shard program over the mesh (counterpart of
tidb_tpu/parallel/fragment.py).

This generalizes distsql.py's two fixed shapes to:

  * join trees of any depth and width: each equi-join hash-repartitions
    both sides through all_to_all and joins locally by sorted-hash ranges
    with duplicate expansion (many-to-many joins), inside one program
  * every join kind: inner, left (NULL-padded unmatched probe rows),
    semi, anti (NOT IN's NULL rule through a psum'd build-NULL count),
    with other conditions and multi-key joins (routed by a combined key
    hash, verified by exact per-key equality)
  * build sides that are not scans (subquery results, small dimension
    pipelines) materialize on the host and enter every shard as
    replicated broadcast inputs (the broadcast join), which also skips
    repartitioning the probe side
  * both aggregation strategies at the root: segment (dense [G] states,
    psum/pmin/pmax merge) and generic (per-shard sort-based partial
    tables from executor/agg_device.py, hash-repartitioned by group key
    and reduced exactly per shard: the two-phase shuffle aggregation)

Every fixed-capacity buffer (exchange buckets, join expansion slots,
compaction targets) counts its overflow instead of dropping rows; the
driving executor grows the blown capacity and re-runs.

The per-shard program is a generator (mesh.run_spmd): every producer's
``emit(env, growths)`` is one, and ``yield from`` threads the collectives
of a join tree's exchanges through it. Its outputs are named (column
uids, state keys), so nothing depends on a container's key order.

The program reads nothing of the host, so that the executor can run it
as one CUDA graph (parallel/executor.py): the broadcast inputs arrive
already on the device (``upload_broadcast``), the per-knob overflow
vector leaves as a device tensor that the caller fetches after the
program, and a join whose probe takes the table route reports a run the
table left unplaced through a "route" knob (the reference decides this
per probe inside its program with lax.cond): the retry re-runs that join
on the sorted route.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from tidb_tpu_torch.chunk.chunk import Chunk
from tidb_tpu_torch.chunk.column import Column
from tidb_tpu_torch.executor.agg_device import (
    _bits64,
    _sort_reduce,
    _state_layout,
    make_partial_kernel,
)
from tidb_tpu_torch.executor.aggregate import make_segment_kernel
from tidb_tpu_torch.executor.builder import peel_stages, scan_stages_for
from tidb_tpu_torch.executor.scan import make_pipeline_fn
from tidb_tpu_torch.expression.compiler import compile_predicate, eval_expr
from tidb_tpu_torch.parallel.distsql import (
    merge_state,
    pmax_compat,
    repartition_by_key,
)
from tidb_tpu_torch.parallel.mesh import psum, run_spmd
from tidb_tpu_torch.parallel.partition import part_args
from tidb_tpu_torch.planner.physical import PHashAgg, PHashJoin, PScan
from tidb_tpu_torch.types import TypeKind
from tidb_tpu_torch.utils.device import torch_dtype

__all__ = ["compile_fragment", "FragmentProgram", "BROADCAST_LIMIT",
           "upload_broadcast"]

# rows above this don't broadcast: the subtree is too big to replicate
BROADCAST_LIMIT = 1 << 21

_MIX_MUL = -7046029254386353131
_MIX_ADD = 0x165667B19E3779F9

# group/join key identity bits: the same rule as the local sort-reduce
# (NULL -> 0 + validity flag; floats by bit pattern), so exchange routing
# and local grouping can never disagree
_key_bits = _bits64


def _no_collectives(fn):
    """Make a producer that yields no collective a generator, so every
    emit composes with ``yield from``."""
    def gen(*args, **kw):
        return fn(*args, **kw)
        yield  # noqa: unreachable — makes this a generator function

    return gen


def _compact(arrays: Dict[str, torch.Tensor], sel: torch.Tensor, cap: int):
    """Scatter live rows to the prefix of [cap] buffers (linear, no sort).
    Returns (arrays', sel', required_factor_minus_one)."""
    dev = sel.device
    pos = torch.cumsum(sel.to(torch.int64), 0) - 1
    total = sel.sum(dtype=torch.int64)
    tgt = torch.where(sel & (pos < cap), pos, cap)  # dead rows -> drop lane
    out = {}
    for name, a in arrays.items():
        buf = torch.zeros((cap + 1,) + tuple(a.shape[1:]), dtype=a.dtype, device=dev)
        buf[tgt] = a
        out[name] = buf[:cap]
    nsel = torch.arange(cap, device=dev) < torch.clamp(total, max=cap)
    factor = (total + cap - 1) // cap
    return out, nsel, torch.clamp(factor - 1, min=0)


def _compact_chunk(chunk: Chunk, cap: int):
    """Compact a Chunk's live rows into a capacity-`cap` Chunk."""
    arrays = {}
    for uid, col in chunk.columns.items():
        arrays[uid + ".d"] = col.data
        arrays[uid + ".v"] = col.valid
    out, nsel, ovf = _compact(arrays, chunk.sel, cap)
    cols = {uid: Column(out[uid + ".d"], out[uid + ".v"], col.type_)
            for uid, col in chunk.columns.items()}
    return Chunk(cols, nsel), ovf


def _mix_hash(bits: List[torch.Tensor]) -> torch.Tensor:
    """Combine per-key bit patterns into one routing/sort hash (int64,
    wrapping), bit-equal to the reference's."""
    if len(bits) == 1:
        return bits[0]  # the exact value: collision-free
    h = torch.zeros_like(bits[0])
    for b in bits:
        h = (h ^ b) * _MIX_MUL + _MIX_ADD
    return h


def _normalize_red_limbs(red, layout, aggs):
    """Carry-normalize the (lo, hi) decimal-sum limb pairs of a reduced
    payload list, keeping lo in [0, 2^32) for the top-k's limb keys and
    the host finalize."""
    from tidb_tpu_torch.executor.aggregate import normalize_limbs

    idx_of = {name: i for i, (name, _) in enumerate(layout)}
    red = list(red)
    for j, _a in enumerate(aggs):
        hi_i = idx_of.get(f"a{j}.sumhi")
        if hi_i is not None:
            lo_i = idx_of[f"a{j}.sum"]
            red[lo_i], red[hi_i] = normalize_limbs(red[lo_i], red[hi_i])
    return red


@dataclass
class _Source:
    """A sharded scan input (its per-part data, valid, sel and refs)."""
    scan: PScan
    stages: list


@dataclass
class _Broadcast:
    """A host-materialized subtree entering every shard replicated."""
    plan: object
    schema: list


@dataclass
class FragmentProgram:
    """Compiled description of a distributable aggregation subtree."""
    agg: PHashAgg
    sources: List[_Source]
    broadcasts: List[_Broadcast]
    n_growth: int                      # number of growth knobs
    sig: str
    build_fn: Callable                 # (growths, probe_mode) -> program
    out_kind: str                      # "segment" | "generic"
    domains: List[int] = field(default_factory=list)
    growth_defaults: Tuple[float, ...] = ()
    growth_kinds: Tuple[str, ...] = ()
    # source indexes that must NOT stream in batches: they sit on the
    # build side of a non-inner join, where partitioning the build set
    # changes per-probe-row match decisions (semi/anti/left)
    stream_unsafe: frozenset = frozenset()
    # (resolved items, k) when a per-shard partial top-k is compiled in;
    # streaming executions recompile without it
    topn: object = None


# An exchange's first capacity per destination, as a factor of a part's
# rows over the parts (the reference starts at 2x). Its receive buffers and
# everything downstream of them (the join's ranges, expansion and gathers)
# scale with it, and a captured fragment's memory pool holds all of that
# under the graph quota (PERF.md, the mesh tier). The estimate-sized
# compaction before an exchange keeps 2x the estimate's rows a part, so
# 1.5x still leaves skew headroom, and an overflow doubles the knob and
# is remembered per join signature.
EXCHANGE_GROWTH = 1.5


class _Unsupported(Exception):
    pass


class _Compiler:
    def __init__(self, n_parts: int):
        self.n_parts = n_parts
        self.sources: List[_Source] = []
        self.broadcasts: List[_Broadcast] = []
        self.n_growth = 0
        # default capacity factor per knob, in assignment order: exchanges
        # start at EXCHANGE_GROWTH (skew headroom), join expansion at 1x (<=
        # 1 match per probe row). "exch" knobs report an overflow row count (the
        # executor doubles); "expand" and "compact" knobs report the
        # required factor minus one (the executor jumps in one step); a
        # "route" knob (1: the statement's probe mode, 2: the sorted
        # route) reports a table run left unplaced
        self.growth_defaults: List[float] = []
        self.growth_kinds: List[str] = []
        self.sig: List[str] = []
        self.stream_unsafe: set = set()

    def _add_growth(self, default: float, kind: str) -> int:
        idx = self.n_growth
        self.n_growth += 1
        self.growth_defaults.append(default)
        self.growth_kinds.append(kind)
        return idx

    def _compact_knob(self, est_rows: float) -> Tuple[int, int]:
        """An estimate-sized compaction target: a "compact" knob and its
        base capacity (~2x the per-shard estimate, floor 64), part of the
        fragment signature."""
        base = max(64, int(np.ceil(2.0 * max(est_rows, 1.0) / self.n_parts)))
        idx = self._add_growth(1.0, "compact")
        self.sig.append(f"cap{idx}:{base}")
        return idx, base

    # -- producers ---------------------------------------------------------

    def producer(self, plan) -> Callable:
        """Compile a subtree into emit(env, growths), a generator returning
        (Chunk, [(knob, overflow)])."""
        stages, base = peel_stages(plan)
        if isinstance(base, PScan) and base.table is not None:
            return self._scan_producer(base, scan_stages_for(base, stages))
        if isinstance(base, PHashJoin):
            join_emit = self._join_producer(base)
            if stages:
                pipe = make_pipeline_fn(stages)

                def emit(env, growths, _j=join_emit, _p=pipe):
                    ch, ovf = yield from _j(env, growths)
                    return _p(ch), ovf

                self.sig.append(f"stages{stages!r}")
                return emit
            return join_emit
        if isinstance(base, PHashAgg) and not stages:
            p = self._try_partial_agg_producer(base)
            if p is not None:
                return p
        # anything else (an aggregation subtree, a union, a limit...) is a
        # broadcast
        return self._broadcast_producer(plan)

    def _partial_agg_ok(self, plan) -> bool:
        """Can `plan` run as a per-shard partial aggregate (a sharded join
        input, not a broadcast)?"""
        stages, agg = peel_stages(plan)
        if stages or not isinstance(agg, PHashAgg):
            return False
        from tidb_tpu_torch.planner.logical import CORE_AGGS

        if (agg.strategy != "generic" or not agg.group_exprs
                or any(a.distinct or a.func not in CORE_AGGS
                       or a.func == "avg" for a in agg.aggs)):
            return False
        # only eager-aggregation partials (the rule's 'eagg.' uids): the
        # rule's upper aggregate re-sums partial rows, so per-shard groups
        # are sound; a user's derived-table aggregate must broadcast
        if not all(a.uid.startswith("eagg.") for a in agg.aggs):
            return False
        _, base = peel_stages(agg.child)
        return isinstance(base, PScan) and base.table is not None

    def _try_partial_agg_producer(self, agg: PHashAgg):
        """A partial aggregate as a join input (the device side of eager
        aggregation): each shard reduces its rows into a group table and
        emits the groups as rows. DECIMAL sums recombine their limbs on
        the device (hi * 2^32 + lo)."""
        if not self._partial_agg_ok(agg):
            return None
        child_emit = self.producer(agg.child)
        partial = make_partial_kernel(agg.group_exprs, agg.aggs)
        types = {c.uid: c.type_ for c in agg.schema}
        self.sig.append(
            f"eagg:{agg.group_exprs!r}:{agg.aggs!r}:{agg.group_uids!r}")

        def emit(env, growths):
            chunk, ovfs = yield from child_emit(env, growths)
            t = partial(chunk)
            live = torch.arange(chunk.capacity, device=chunk.device) < t["n"]
            cols = {}
            for i, uid in enumerate(agg.group_uids):
                cols[uid] = Column(t[f"k{i}.d"], t[f"k{i}.v"] & live, types[uid])
            for j, a in enumerate(agg.aggs):
                cnt = t[f"a{j}.cnt"]
                if a.func == "count":
                    data, valid = cnt, live
                elif a.func == "sum":
                    data = t[f"a{j}.sum"]
                    if f"a{j}.sumhi" in t:
                        data = data + t[f"a{j}.sumhi"] * (1 << 32)  # wraps as <<
                    valid = live & (cnt > 0)
                else:  # min / max
                    data = t[f"a{j}.{a.func}"]
                    valid = live & (cnt > 0)
                cols[a.uid] = Column(data.to(torch_dtype(types[a.uid].np_dtype)),
                                     valid, types[a.uid])
            return Chunk(cols, live), ovfs

        return emit

    def _scan_producer(self, scan: PScan, stages) -> Callable:
        if any(c.name == "__rowid__" for c in scan.schema):
            # physical row ids are a host-engine concept (shardings
            # re-partition rows); DML selects take the host path
            raise _Unsupported("__rowid__ pseudo-column in a fragment")
        idx = len(self.sources)
        self.sources.append(_Source(scan, stages))
        uid_of = {c.name: c.uid for c in scan.schema}
        type_of = {c.name: c.type_ for c in scan.schema}
        pipe = make_pipeline_fn(stages) if stages else (lambda c: c)
        self.sig.append(f"scan{idx}:{scan.table_name}:{stages!r}:{sorted(uid_of.items())!r}")

        @_no_collectives
        def emit(env, growths):
            from tidb_tpu_torch.ops.segment_scan import decode_for

            data, valid, sel, refs = env["scan"][idx]
            # the sharding carries every table column; take the (pruned)
            # scan schema, decoding FoR-staged columns on the device
            cols = {}
            for name in uid_of:
                t = type_of[name]
                d = decode_for(data[name], refs.get(name), t.np_dtype)
                cols[uid_of[name]] = Column(d, valid[name], t)
            return pipe(Chunk(cols, sel)), []

        return emit

    def _broadcast_producer(self, plan) -> Callable:
        idx = len(self.broadcasts)
        self.broadcasts.append(_Broadcast(plan, list(plan.schema)))
        types = {c.uid: c.type_ for c in plan.schema}
        self.sig.append(f"bcast{idx}:{[(c.uid, c.type_) for c in plan.schema]!r}")

        @_no_collectives
        def emit(env, growths):
            data, valid, sel = env["bcast"][idx]
            cols = {uid: Column(data[uid], valid[uid], types[uid]) for uid in data}
            return Chunk(cols, sel), []

        return emit

    # -- joins -------------------------------------------------------------

    def _join_producer(self, join: PHashJoin) -> Callable:
        if not join.eq_left:
            raise _Unsupported("keyless (cross) join")
        if join.kind not in ("inner", "left", "semi", "anti"):
            raise _Unsupported(f"join kind {join.kind}")

        probe_idx = 1 - join.build_side
        probe_plan = join.children[probe_idx]
        build_plan = join.children[join.build_side]
        probe_keys = join.eq_left if probe_idx == 0 else join.eq_right
        build_keys = join.eq_right if join.build_side == 1 else join.eq_left

        # the build mode is decided BEFORE compiling children: a broadcast
        # build skips both exchanges
        def _is_bcast(plan) -> bool:
            _, base = peel_stages(plan)
            if isinstance(base, PScan) and base.table is not None:
                return False
            if isinstance(base, PHashJoin):
                return False
            if self._partial_agg_ok(plan):
                return False  # per-shard eager partial: sharded, not replicated
            return True

        build_is_bcast = _is_bcast(build_plan)
        if _is_bcast(probe_plan):
            # a replicated probe side would be joined (and aggregated)
            # once per shard, inflating every result by n_parts
            raise _Unsupported("broadcast probe side")

        probe_emit = self.producer(probe_plan)
        n_before_build = len(self.sources)
        build_emit = self.producer(build_plan)
        if join.kind != "inner":
            # a batched build side would re-decide semi/anti/left matches
            # per batch: every source under it stays resident
            self.stream_unsafe.update(range(n_before_build, len(self.sources)))

        exchange = not build_is_bcast
        g_exch = self._add_growth(EXCHANGE_GROWTH, "exch") if exchange else None
        g_expand = self._add_growth(1.0, "expand")
        # estimate-sized compaction targets: selective filters and joins
        # collapse live counts, and every sort and exchange downstream pays
        # for capacity
        g_pcomp, p_base = self._compact_knob(probe_plan.est_rows)
        g_bcomp, b_base = self._compact_knob(build_plan.est_rows)
        g_ocomp, o_base = self._compact_knob(join.est_rows)
        g_route = self._add_growth(1.0, "route")

        kind = join.kind
        exists_sem = join.exists_sem
        other_cond = join.other_cond
        other_pred = compile_predicate(other_cond) if other_cond is not None else None
        n_parts = self.n_parts
        nk = len(probe_keys)
        need_verify = nk > 1
        self.sig.append(
            f"join:{kind}:{exists_sem}:{probe_keys!r}:{build_keys!r}:{other_cond!r}"
            f":exch{exchange}")

        def flat(ch: Chunk, bits, kvalid):
            arrs = {}
            for uid, col in ch.columns.items():
                arrs[uid + ".d"] = col.data
                arrs[uid + ".v"] = col.valid
            for i, b in enumerate(bits):
                arrs[f"__kb{i}"] = b
            arrs["__kv"] = kvalid
            return arrs

        def unflat(arrs, ref: Chunk, sel):
            cols = {uid: Column(arrs[uid + ".d"], arrs[uid + ".v"], col.type_)
                    for uid, col in ref.columns.items()}
            return Chunk(cols, sel), [arrs[f"__kb{i}"] for i in range(nk)], arrs["__kv"]

        def emit(env, growths):
            from tidb_tpu_torch.ops.join_kernels import (
                probe_hash_ranges,
                sort_build_hashes,
                tile_positions,
            )

            pch, p_ovf = yield from probe_emit(env, growths)
            bch, b_ovf = yield from build_emit(env, growths)
            ovfs = list(p_ovf) + list(b_ovf)

            capP = int(np.ceil(growths[g_pcomp] * p_base))
            if capP < pch.capacity:
                pch, o = _compact_chunk(pch, capP)
                ovfs.append((g_pcomp, (yield from pmax_compat(o))))
            capB = int(np.ceil(growths[g_bcomp] * b_base))
            if capB < bch.capacity:
                bch, o = _compact_chunk(bch, capB)
                ovfs.append((g_bcomp, (yield from pmax_compat(o))))

            p_outs = [eval_expr(k, pch) for k in probe_keys]
            b_outs = [eval_expr(k, bch) for k in build_keys]
            p_bits = [_key_bits(d, v) for d, v in p_outs]
            b_bits = [_key_bits(d, v) for d, v in b_outs]
            p_kvalid = p_outs[0][1]
            b_kvalid = b_outs[0][1]
            for _, v in p_outs[1:]:
                p_kvalid = p_kvalid & v
            for _, v in b_outs[1:]:
                b_kvalid = b_kvalid & v
            p_hash = _mix_hash(p_bits)
            b_hash = _mix_hash(b_bits)

            # NOT IN's NULL rule: any live build row with a NULL key empties
            # the anti result, counted across the whole mesh
            b_null = None
            if kind == "anti" and not exists_sem:
                b_null = yield psum((bch.sel & ~b_kvalid).sum(dtype=torch.int64))

            if exchange:
                growth = growths[g_exch]
                pr, pr_sel, pr_hash, povf = yield from repartition_by_key(
                    flat(pch, p_bits, p_kvalid), pch.sel, p_hash,
                    torch.ones_like(p_kvalid), n_parts, growth)
                br, br_sel, br_hash, bovf = yield from repartition_by_key(
                    flat(bch, b_bits, b_kvalid), bch.sel, b_hash,
                    torch.ones_like(b_kvalid), n_parts, growth)
                ovfs.append((g_exch, (yield psum(povf + bovf))))
                pch2, p_bits2, p_kvalid2 = unflat(pr, pch, pr_sel)
                bch2, b_bits2, b_kvalid2 = unflat(br, bch, br_sel)
                p_hash2, b_hash2 = pr_hash, br_hash
            else:
                pch2, p_bits2, p_kvalid2, p_hash2 = pch, p_bits, p_kvalid, p_hash
                bch2, b_bits2, b_kvalid2, b_hash2 = bch, b_bits, b_kvalid, b_hash
            # what a frame still names at a collective stays allocated while
            # every other shard runs up to it (and a captured program's pool
            # holds it): drop the names of what is dead, here the sides as
            # they were before the exchange
            del pch, bch, p_outs, b_outs, p_bits, b_bits, p_kvalid, b_kvalid, p_hash, b_hash

            Rp = pch2.capacity
            Rb = bch2.capacity

            # the local sorted-range join on the hash: build runs sorted with
            # dead rows after live ones, each probe row's range through the
            # probe kernel (tidb_probe_count on the card), then the
            # prefix-sum expansion
            b_live = bch2.sel & b_kvalid2
            sh, cvi, order = sort_build_hashes(b_hash2, b_live)
            p_ok = pch2.sel & p_kvalid2
            mode = env["probe_mode"] if growths[g_route] <= 1 else "off"
            lo, cnt, unplaced = probe_hash_ranges(sh, cvi, p_hash2, p_ok, mode=mode)
            if unplaced is not None:
                ovfs.append((g_route, (yield from pmax_compat(unplaced))))

            cum = torch.cumsum(cnt, 0)
            total = cum[-1]
            capJ = int(np.ceil(growths[g_expand] * Rp))
            # required factor minus one, maxed over shards (0 = fits)
            factor = (total + capJ - 1) // capJ
            ovfs.append((g_expand, (yield from pmax_compat(torch.clamp(factor - 1, min=0)))))

            valid_out, p_row, b_sorted_pos, _k = tile_positions(
                lo, cnt, cum, 0, capJ, Rp, Rb)
            b_row = order[b_sorted_pos]

            sel_out = valid_out
            if need_verify:  # hash routing can collide: verify the exact keys
                for pb, bb in zip(p_bits2, b_bits2):
                    sel_out = sel_out & (pb[p_row] == bb[b_row])
                sel_out = sel_out & p_kvalid2[p_row] & b_kvalid2[b_row]

            cols = {}
            for uid, col in pch2.columns.items():
                cols[uid] = col.gather(p_row, valid_out)
            for uid, col in bch2.columns.items():
                bc = col.gather(b_row, valid_out)
                cols[uid] = Column(bc.data, bc.valid & sel_out, col.type_)
            joined = Chunk(cols, sel_out & pch2.sel[p_row])

            if other_pred is not None:
                joined = joined.filter(other_pred(joined))

            if kind == "inner":
                result = joined
            else:
                # per-probe-row match flags after the condition
                hits = torch.zeros(Rp, dtype=torch.int32, device=joined.device)
                m = hits.index_add_(0, p_row, joined.sel.to(torch.int32)) > 0
                if kind == "semi":
                    result = pch2.with_sel(p_ok & m)
                elif kind == "anti":
                    if exists_sem:
                        keep = pch2.sel & ~(p_kvalid2 & m)
                    else:
                        keep = pch2.sel & p_kvalid2 & ~m & (b_null == 0)
                    result = pch2.with_sel(keep)
                else:
                    # left join: the expanded matches, then one NULL-build
                    # row for each unmatched live probe row
                    pad_sel = pch2.sel & ~m
                    out_cols = {}
                    for uid, col in pch2.columns.items():
                        jc = joined.columns[uid]
                        out_cols[uid] = Column(torch.cat([jc.data, col.data]),
                                               torch.cat([jc.valid, col.valid]),
                                               col.type_)
                    for uid, col in bch2.columns.items():
                        jc = joined.columns[uid]
                        out_cols[uid] = Column(
                            torch.cat([jc.data, torch.zeros(Rp, dtype=col.data.dtype,
                                                            device=jc.data.device)]),
                            torch.cat([jc.valid, torch.zeros(Rp, dtype=torch.bool,
                                                             device=jc.data.device)]),
                            col.type_)
                    result = Chunk(out_cols, torch.cat([joined.sel, pad_sel]))
            # only the result lives on (see above)
            del (joined, cols, pch2, bch2, p_bits2, b_bits2, p_kvalid2, b_kvalid2, p_hash2,
                 b_hash2, sh, cvi, order, lo, cnt, cum, valid_out, p_row, b_sorted_pos, b_row,
                 sel_out, p_ok, b_live)

            capO = int(np.ceil(growths[g_ocomp] * o_base))
            if capO < result.capacity:
                result, o = _compact_chunk(result, capO)
                ovfs.append((g_ocomp, (yield from pmax_compat(o))))
            return result, ovfs

        return emit

    # -- per-shard partial top-k -------------------------------------------

    def _topn_select(self, items, nk, layout, kmax, aggs):
        """fn(n, fk, fkv, red) -> (n', fk', fkv', red') keeping each
        shard's top `kmax` groups under the resolved sort items. The
        exchange routes every group to exactly one shard, so the union of
        the per-shard top-k sets holds the global top-k; the root TopNExec
        orders that superset exactly. NULLs first ascending and last
        descending, dead lanes always last; descending ints invert by ~x,
        floats negate."""
        self.sig.append(f"topn:{items!r}:{kmax}")

        def select(n, fk, fkv, red):
            from tidb_tpu_torch.ops.topk import lex_perm

            state = {name: arr for (name, _), arr in zip(layout, red)}
            S = (fk[0] if nk else red[0]).shape[0]
            dev = (fk[0] if nk else red[0]).device
            kcap = min(kmax, S)
            live = torch.arange(S, dtype=torch.int64, device=dev) < n
            keys = []
            for kind, idx, desc in items:
                limbs = None
                if kind == "key":
                    data, valid = fk[idx], fkv[idx]
                elif kind == "cnt":
                    data = state[f"a{idx}.cnt"]
                    valid = torch.ones(S, dtype=torch.bool, device=dev)
                elif kind == "avg":
                    c = state[f"a{idx}.cnt"]
                    s = state[f"a{idx}.sum"]
                    hi = state.get(f"a{idx}.sumhi")
                    # divide in the host finalize's order (scale, then
                    # count) so rounding can never rank two groups
                    # differently than the final TopN
                    sf = (hi.to(torch.float64) * float(1 << 32) + s.to(torch.float64)
                          if hi is not None else s.to(torch.float64))
                    a = aggs[idx]
                    if a.arg is not None and a.arg.type_.kind == TypeKind.DECIMAL:
                        sf = sf / (10 ** a.arg.type_.scale)
                    data = sf / torch.clamp(c, min=1).to(torch.float64)
                    valid = c > 0
                else:  # sum | min | max: NULL when no non-null input
                    data = state[f"a{idx}.{kind}"]
                    valid = state[f"a{idx}.cnt"] > 0
                    if kind == "sum" and f"a{idx}.sumhi" in state:
                        # two-limb decimal sum: carry-normalized, (hi, lo)
                        # lexicographic is the numeric order
                        from tidb_tpu_torch.executor.aggregate import normalize_limbs

                        lo, hi = normalize_limbs(data, state[f"a{idx}.sumhi"])
                        limbs = (hi, lo)
                two = torch.full((S,), 2, dtype=torch.int32, device=dev)
                first = torch.full((S,), 0 if desc else 1, dtype=torch.int32, device=dev)
                second = torch.full((S,), 1 if desc else 0, dtype=torch.int32, device=dev)
                rank = torch.where(~live, two, torch.where(valid, first, second))
                if limbs is not None:
                    dead = ~(valid & live)
                    khi = torch.where(dead, 0, limbs[0])
                    klo = torch.where(dead, 0, limbs[1])
                    if desc:
                        khi, klo = ~khi, ~klo
                    keys += [rank, khi, klo]
                    continue
                if data.dtype == torch.bool:
                    data = data.to(torch.int64)
                if data.is_floating_point():
                    key = torch.where(valid & live, data.to(torch.float64), 0.0)
                    if desc:
                        key = -key
                else:
                    key = torch.where(valid & live, data.to(torch.int64), 0)
                    if desc:
                        key = ~key
                keys += [rank, key]
            perm = lex_perm(keys)[:kcap]
            return (torch.clamp(n, max=kcap), [a[perm] for a in fk],
                    [a[perm] for a in fkv], [a[perm] for a in red])

        return select

    # -- aggregation root --------------------------------------------------

    def compile_agg(self, agg: PHashAgg, topn=None) -> Tuple[Callable, str, List[int]]:
        # the aggregation's child must peel to a real sharded scan or a
        # join tree; anything else would be one replicated broadcast
        _, base = peel_stages(agg.child)
        if not (isinstance(base, PHashJoin)
                or (isinstance(base, PScan) and base.table is not None)):
            raise _Unsupported("agg over non-scan/join subtree")
        child_emit = self.producer(agg.child)

        if any(a.distinct for a in agg.aggs):
            raise _Unsupported("DISTINCT aggregates")
        from tidb_tpu_torch.planner.logical import CORE_AGGS

        for a in agg.aggs:
            if a.func not in CORE_AGGS:
                raise _Unsupported(f"aggregate {a.func} on the fragment tier")

        if agg.strategy == "segment":
            sizes = agg.segment_sizes or []
            domains = [s + 1 for s in sizes]
            init_state, update, _ = make_segment_kernel(agg.group_exprs, agg.aggs, domains)
            self.sig.append(f"segagg:{agg.group_exprs!r}:{agg.aggs!r}:{domains!r}")

            def emit(env, growths):
                chunk, ovfs = yield from child_emit(env, growths)
                state = update(init_state(chunk.device), chunk)
                return (yield from merge_state(state)), ovfs

            return emit, "segment", domains

        if not agg.group_exprs:
            raise _Unsupported("generic global agg")  # the planner uses segment
        partial = make_partial_kernel(agg.group_exprs, agg.aggs)
        layout = _state_layout(agg.aggs)
        nk = len(agg.group_exprs)
        topn_fn = (self._topn_select(topn[0], nk, layout, topn[1], agg.aggs)
                   if topn is not None else None)
        g_agg = self._add_growth(EXCHANGE_GROWTH, "exch")
        n_parts = self.n_parts
        # estimate-sized shrink targets: the partial sort pays for input
        # capacity and the exchange for table slots
        g_in, in_base = self._compact_knob(agg.child.est_rows)
        g_tab, tab_base = self._compact_knob(agg.est_rows)
        self.sig.append(f"genagg:{agg.group_exprs!r}:{agg.aggs!r}")

        def emit(env, growths):
            chunk, ovfs = yield from child_emit(env, growths)
            capI = int(np.ceil(growths[g_in] * in_base))
            if capI < chunk.capacity:
                chunk, o = _compact_chunk(chunk, capI)
                ovfs.append((g_in, (yield from pmax_compat(o))))
            table = partial(chunk)  # local dedup before the exchange
            dev = chunk.device
            del chunk  # dead from here (the join's note on frames at a collective)
            S = table["k0.d"].shape[0]
            capT = int(np.ceil(growths[g_tab] * tab_base))
            if capT < S:
                # groups are dense in [0, n): slicing the slot arrays
                # shrinks everything the exchange carries
                factor = (table["n"] + capT - 1) // capT
                ovfs.append((g_tab, (yield from pmax_compat(torch.clamp(factor - 1, min=0)))))
                table = {k: (v if k == "n" else v[:capT]) for k, v in table.items()}
                S = capT
            live = torch.arange(S, device=dev) < table["n"]
            kd = [table[f"k{i}.d"] for i in range(nk)]
            kv = [table[f"k{i}.v"] for i in range(nk)]
            khash = _mix_hash([_key_bits(d, v) for d, v in zip(kd, kv)])

            arrays = {}
            for i in range(nk):
                arrays[f"k{i}.d"] = kd[i]
                arrays[f"k{i}.v"] = kv[i]
            for name, _ in layout:
                arrays[name] = table[name]
            recv, recv_sel, _, ovf = yield from repartition_by_key(
                arrays, live, khash, torch.ones_like(live), n_parts, growths[g_agg])
            del arrays, table, kd, kv, khash, live
            ovfs.append((g_agg, (yield psum(ovf))))

            rkd = [recv[f"k{i}.d"] for i in range(nk)]
            rkv = [recv[f"k{i}.v"] for i in range(nk)]
            rbits = [_key_bits(d, v) for d, v in zip(rkd, rkv)]
            payload = [recv[name] for name, _ in layout]
            ops = [op for _, op in layout]
            # exact mode: the emitted tables are duplicate-free, so the host
            # finalize converts each part as it is, with no merge
            n, fk, fkv, red = _sort_reduce(rbits, rkv, rkd, recv_sel, payload, ops,
                                           exact=True)
            red = _normalize_red_limbs(red, layout, agg.aggs)
            if topn_fn is not None:
                n, fk, fkv, red = topn_fn(n, fk, fkv, red)
            out = {"n": n}
            for i in range(nk):
                out[f"k{i}.d"] = fk[i]
                out[f"k{i}.v"] = fkv[i]
            for (name, _), arr in zip(layout, red):
                out[name] = arr
            return out, ovfs

        return emit, "generic", []


def upload_broadcast(data: Dict[str, np.ndarray], valid: Dict[str, np.ndarray],
                     sel: np.ndarray, mesh) -> tuple:
    """A broadcast input's host arrays on every device of the mesh, ahead
    of the fragment's program (a pageable copy cannot sit inside a CUDA
    graph): per distinct device in part order, its (data, valid, sel) as
    a jitcache.PackedTuple staged by one copy."""
    from tidb_tpu_torch.parallel.partition import upload_packed
    from tidb_tpu_torch.utils.jitcache import packed_view

    names = list(data)
    out = []
    for dev in mesh.distinct_devices:
        buf, views = upload_packed([data[k] for k in names] + [valid[k] for k in names]
                                   + [sel], dev)
        k = len(names)
        out.append(packed_view(buf, (dict(zip(names, views[:k])),
                                     dict(zip(names, views[k:2 * k])), views[2 * k])))
    return tuple(out)


def compile_fragment(agg: PHashAgg, mesh, n_parts: int,
                     topn=None) -> Optional[FragmentProgram]:
    """Try to compile an aggregation-rooted subtree; None if it is not
    distributable. `topn` = (resolved items, k) applies a per-shard
    partial top-k to the generic group tables before they leave the
    device; segment aggregations ignore it."""
    from tidb_tpu_torch.utils.failpoint import inject

    # chaos hook: fail the fragment compilation itself
    inject("fragment.compile")
    c = _Compiler(n_parts)
    try:
        emit, out_kind, domains = c.compile_agg(agg, topn=topn)
    except _Unsupported:
        return None
    if not c.sources:
        return None  # nothing sharded: run on one device
    from tidb_tpu_torch.utils import tracing
    from tidb_tpu_torch.utils.metrics import FRAGMENT_COMPILE

    FRAGMENT_COMPILE.inc(kind=out_kind)
    tracing.annotate(f"compile:fragment:{out_kind}")

    n_src = len(c.sources)
    n_knobs = c.n_growth

    def build_fn(growths: Tuple[float, ...], probe_mode: str):
        """The program at these capacities: fn(*sources, *broadcasts) ->
        (out, ovf) over each source's (data, valid, sel, refs) per-part
        lists (ShardedTable.args()) and each broadcast's upload_broadcast
        tuple. `out` is the merged segment state (on the first part's
        device) or the per-part group tables; `ovf` the per-knob overflow
        vector (an int64 device tensor, None without knobs), which the
        caller fetches after the program."""
        dev_index = [mesh.distinct_devices.index(d) for d in mesh.devices]

        def per_shard(p, scans, bcasts):
            env = {"scan": scans, "bcast": bcasts, "probe_mode": probe_mode}
            out, reports = yield from emit(env, growths)
            # the per-knob overflow vector, slot-indexed by knob id (the
            # emission order differs from the knob-assignment order)
            slots = [0] * n_knobs
            for idx, v in reports:
                slots[idx] = slots[idx] + v.to(torch.int64)
            return out, slots

        def frag(*args):
            srcs, bcs = args[:n_src], args[n_src:]
            per_part = []
            for p in range(mesh.n_parts):
                scans = [part_args(*src, p) for src in srcs]
                per_part.append((scans, [bc[dev_index[p]] for bc in bcs]))
            results = run_spmd(mesh, per_shard, per_part)
            dev0 = mesh.device_of(0)
            slots = [s.to(dev0) if isinstance(s, torch.Tensor)
                     else torch.zeros((), dtype=torch.int64, device=dev0)
                     for s in results[0][1]]
            # the per-knob overflow vector (a few int64s) gates the
            # capacity-retry loop: the caller's one fetch per dispatch
            ovf = torch.stack(slots) if slots else None
            if out_kind == "segment":
                return results[0][0], ovf
            return [r[0] for r in results], ovf

        return frag

    return FragmentProgram(
        agg=agg, sources=c.sources, broadcasts=c.broadcasts,
        n_growth=c.n_growth, sig="|".join(c.sig), build_fn=build_fn,
        out_kind=out_kind, domains=domains,
        growth_defaults=tuple(c.growth_defaults),
        growth_kinds=tuple(c.growth_kinds),
        stream_unsafe=frozenset(c.stream_unsafe),
        topn=topn if out_kind == "generic" else None,
    )
