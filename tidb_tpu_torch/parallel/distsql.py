"""Distributed plan fragments: scan, aggregation and join over the mesh
(counterpart of tidb_tpu/parallel/distsql.py).

The coprocessor push-down tier, as per-shard programs under
mesh.run_spmd:

  * scan + filter + partial aggregation run per shard; the partial
    [G]-shaped states merge with psum/pmin/pmax over the mesh (the merge
    op of each state key is aggregate.merge_op_for)
  * a join repartitions rows by key hash through a fixed-capacity bucket
    exchange: a row takes a slot in its destination's [P, cap] send
    buffer (cap = growth * R / P), all_to_all moves the buckets, and
    overflow is counted and returned, never dropped silently
  * the local join per shard sorts the build keys and probes them
    through hash_probe.probe_for_join (the tidb_probe_count kernel on the
    card). The build side must be unique-key (PK-FK joins); other joins
    take the general fragment tier (fragment.py).

A per-shard program is a generator: ``v = yield psum(v)`` is the
reference's ``v = jax.lax.psum(v, axes)``. A fragment function takes each
sharding as one argument (``ShardedTable.args()``) and reads nothing of
the host: it returns its overflow counts as device tensors, which the
caller fetches after the program (one round trip a dispatch), so the
executor can run it as one CUDA graph (parallel/executor.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from tidb_tpu_torch.chunk.chunk import Chunk
from tidb_tpu_torch.chunk.column import Column
from tidb_tpu_torch.executor.aggregate import make_segment_kernel, merge_op_for
from tidb_tpu_torch.executor.scan import make_pipeline_fn
from tidb_tpu_torch.expression.compiler import eval_expr
from tidb_tpu_torch.parallel.mesh import (
    all_to_all,
    pmax,
    psum,
    reduce_each,
    run_spmd,
)
from tidb_tpu_torch.parallel.partition import ShardedTable, part_args
from tidb_tpu_torch.utils import dispatch

__all__ = [
    "merge_state",
    "make_agg_fragment",
    "make_join_agg_fragment",
    "dist_agg_fragment",
    "dist_join_agg_fragment",
    "repartition_by_key",
    "pmax_compat",
]

_HASH_MULT = -7046029254386353131  # 0x9E3779B97F4A7C15 as int64


def pmax_compat(v: torch.Tensor):
    """The mesh-wide max (the reference gathers and reduces to dodge a
    TPU compiler; the port reduces directly and keeps the name)."""
    return (yield pmax(v))


def merge_state(state: Dict[str, torch.Tensor]):
    """Merge per-shard partial segment states across the mesh (the final
    aggregation step): one collective, each key by its merge op."""
    return (yield reduce_each({k: merge_op_for(k) for k in state}, state))


def _shard_chunk(types: Dict, data, valid, sel, uid_map,
                 refs: Optional[Dict] = None) -> Chunk:
    from tidb_tpu_torch.ops.segment_scan import decode_for

    cols = {}
    for name in data:
        uid = uid_map.get(name, name) if uid_map else name
        t = types[name]
        # the narrow FoR payload widens to the column's device repr here
        d = decode_for(data[name], (refs or {}).get(name), t.np_dtype)
        cols[uid] = Column(data=d, valid=valid[name], type_=t)
    return Chunk(cols, sel)


def make_agg_fragment(st: ShardedTable, stages: List, group_exprs, aggs,
                      domains: List[int], uid_map: Optional[Dict[str, str]] = None):
    """scan -> filter -> partial aggregation -> merge over the mesh.

    Returns fn(src) -> the merged [G]-state dict (on the first part's
    device), over a sharding's (data, valid, sel, refs) per-part lists
    (ShardedTable.args()). The closure captures only the sharding's
    metadata, never its tensors, so a cached fragment cannot pin a
    retired sharding."""
    pipeline = make_pipeline_fn(stages) if stages else (lambda c: c)
    init_state, update, _ = make_segment_kernel(group_exprs, aggs, domains)
    types, mesh = dict(st.types), st.mesh

    def per_shard(p, data, valid, sel, refs):
        chunk = pipeline(_shard_chunk(types, data, valid, sel, uid_map, refs))
        return (yield from merge_state(update(init_state(sel.device), chunk)))

    def run(src):
        args = [part_args(*src, p) for p in range(mesh.n_parts)]
        return run_spmd(mesh, per_shard, args)[0]

    return run


def dist_agg_fragment(st: ShardedTable, stages: List, group_exprs, aggs,
                      domains: List[int], uid_map: Optional[Dict[str, str]] = None):
    """Build and run (see make_agg_fragment for the cached path)."""
    fn = make_agg_fragment(st, stages, group_exprs, aggs, domains, uid_map)
    return fn(st.args())


# ---------------------------------------------------------------------------
# repartition exchange
# ---------------------------------------------------------------------------


def _hash_dest(key: torch.Tensor, n_parts: int) -> torch.Tensor:
    """Destination part of each int64 key: key * 0x9E3779B97F4A7C15 (wrapping)
    mod n_parts, non-negative, bit-equal to the reference's."""
    h = key.to(torch.int64) * _HASH_MULT
    return ((h % n_parts) + n_parts) % n_parts


def repartition_by_key(arrays: Dict[str, torch.Tensor], sel: torch.Tensor,
                       key: torch.Tensor, key_valid: torch.Tensor, n_parts: int,
                       growth: float = 2.0):
    """Exchange rows so equal keys land on the same part (a per-shard
    program step: ``recv, sel2, key2, ovf = yield from repartition_by_key(...)``).

    arrays: name -> [R]; returns (arrays', sel', key', overflow_count) with
    [n_parts * cap] shapes where cap = ceil(growth * R / n_parts). NULL
    keys never join, so such rows are dropped here (sel' False).

    On a one-part mesh every row stays where it is: the exchange is the
    identity, so it moves nothing and returns the [R] inputs (a captured
    fragment's pool then holds no [2, 2R] send and [1, 2R] receive
    buffers per column, nor a join downstream sized 2R)."""
    R = sel.shape[0]
    dev = sel.device
    live = sel & key_valid
    if n_parts == 1:
        return dict(arrays), live, key, torch.zeros((), dtype=torch.int64, device=dev)
    cap = int(np.ceil(growth * R / n_parts))
    dest = torch.where(live, _hash_dest(key, n_parts),
                       torch.full_like(key, n_parts, dtype=torch.int64))  # P = drop lane

    order = torch.sort(dest, stable=True).indices
    sorted_dest = dest[order]
    seg_start = torch.searchsorted(
        sorted_dest, torch.arange(n_parts + 1, dtype=torch.int64, device=dev))
    pos = torch.arange(R, device=dev) - seg_start[sorted_dest.clamp(0, n_parts)]
    real = sorted_dest < n_parts
    in_cap = (pos < cap) & real
    overflow = ((pos >= cap) & real).sum(dtype=torch.int64)

    # row order[i] goes to send slot [sorted_dest[i], pos[i]]; dead and
    # overflowing rows land in a trash lane (row n_parts) cut off before
    # the exchange, so no live slot sees a collision
    slot_d = torch.where(in_cap, sorted_dest, n_parts)
    slot_p = torch.where(in_cap, pos, 0)

    def scatter(a):
        buf = torch.zeros((n_parts + 1, cap), dtype=a.dtype, device=dev)
        buf[slot_d, slot_p] = a[order]
        return buf[:n_parts]

    sent = {name: scatter(a) for name, a in arrays.items()}
    sent["__sel"] = scatter(torch.ones(R, dtype=torch.bool, device=dev))
    sent["__key"] = scatter(key)
    recv = yield all_to_all(sent)
    recv = {name: a.reshape(-1) for name, a in recv.items()}
    recv_sel, recv_key = recv.pop("__sel"), recv.pop("__key")
    return recv, recv_sel, recv_key, overflow


def _local_join(build_key, build_sel, probe_key, probe_sel, mode: str):
    """Sort the build keys and probe them. Returns (build_idx, hit,
    unplaced).

    Validity is a secondary sort key (valid rows first among equal keys),
    not an in-band sentinel, so a legitimate INT64_MAX key still joins.
    The probe is hash_probe.probe_for_join over the sorted keys (the
    reference's searchsorted, here one tidb_probe_count launch on the
    card): lo is the first row of a probe key's run, valid if any is.
    `unplaced` (None off the table route) is 1 where the table left a run
    unplaced: the ranges are then void and the caller re-runs on the
    sorted route."""
    from tidb_tpu_torch.ops import hash_probe as hp
    from tidb_tpu_torch.ops.topk import lex_perm

    n = build_key.shape[0]
    invalid = (~build_sel).to(torch.int32)
    order = lex_perm([build_key, invalid])
    skeys, sinv = build_key[order], invalid[order]
    lo, hi, unplaced = hp.probe_for_join(skeys, probe_key, mode=mode, ok=probe_sel)
    pos = lo.clamp(0, n - 1)
    hit = (hi > lo) & (sinv[pos] == 0) & probe_sel
    return order[pos], hit, unplaced


def make_join_agg_fragment(
    probe: ShardedTable, build: ShardedTable,
    probe_stages: List, build_stages: List,
    probe_key_ir, build_key_ir,
    probe_uids: Dict[str, str], build_uids: Dict[str, str],
    post_stages: List, group_exprs, aggs, domains: List[int],
    growth: float = 2.0, probe_mode: str = "auto",
):
    """Hash-repartition join + partial aggregation over the mesh.

    Per shard: scan both sides -> FoR decode -> pushed filters -> join
    keys -> exchange both sides -> local unique-build-key join ->
    post-join filter/project -> partial segment aggregation -> merge.

    Returns fn(probe_src, build_src) -> (state, overflow, unplaced) over
    the two shardings' ShardedTable.args(): the merged [G] dict, the
    total row count the exchange capacity dropped (an int64 device
    scalar; the caller re-runs with a larger growth unless it is 0), and
    whether the probe's table left a run unplaced on some shard (an
    int64 device scalar, or None off the table route; the caller then
    re-runs on the sorted route, probe_mode "off")."""
    p_pipe = make_pipeline_fn(probe_stages) if probe_stages else (lambda c: c)
    b_pipe = make_pipeline_fn(build_stages) if build_stages else (lambda c: c)
    post_pipe = make_pipeline_fn(post_stages) if post_stages else (lambda c: c)
    init_state, update, _ = make_segment_kernel(group_exprs, aggs, domains)
    mesh = probe.mesh
    n_parts = probe.n_parts
    probe_types, build_types = dict(probe.types), dict(build.types)

    def flat(ch: Chunk):
        arrs = {}
        for uid, col in ch.columns.items():
            arrs[uid + ".d"] = col.data
            arrs[uid + ".v"] = col.valid
        return arrs

    def per_shard(p, p_data, p_valid, p_sel, p_refs, b_data, b_valid, b_sel, b_refs):
        pch = p_pipe(_shard_chunk(probe_types, p_data, p_valid, p_sel,
                                  probe_uids, p_refs))
        bch = b_pipe(_shard_chunk(build_types, b_data, b_valid, b_sel,
                                  build_uids, b_refs))
        pk, pkv = eval_expr(probe_key_ir, pch)
        bk, bkv = eval_expr(build_key_ir, bch)
        pk, bk = pk.to(torch.int64), bk.to(torch.int64)

        pr, pr_sel, pr_key, p_ovf = yield from repartition_by_key(
            flat(pch), pch.sel, pk, pkv, n_parts, growth)
        br, br_sel, br_key, b_ovf = yield from repartition_by_key(
            flat(bch), bch.sel, bk, bkv, n_parts, growth)

        bidx, hit, unplaced = _local_join(br_key, br_sel, pr_key, pr_sel, probe_mode)
        cols = {}
        for uid, col in pch.columns.items():
            cols[uid] = Column(pr[uid + ".d"], pr[uid + ".v"], col.type_)
        for uid, col in bch.columns.items():
            cols[uid] = Column(br[uid + ".d"][bidx], br[uid + ".v"][bidx] & hit,
                               col.type_)
        joined = post_pipe(Chunk(cols, hit))
        state = yield from merge_state(update(init_state(p_sel.device), joined))
        ovf = yield psum(p_ovf + b_ovf)
        if unplaced is not None:
            unplaced = yield pmax(unplaced)
        return state, ovf, unplaced

    def run(probe_src, build_src):
        args = [part_args(*probe_src, p) + part_args(*build_src, p)
                for p in range(n_parts)]
        return run_spmd(mesh, per_shard, args)[0]

    return run


def dist_join_agg_fragment(probe: ShardedTable, build: ShardedTable, *args, **kwargs):
    """Build and run (see make_join_agg_fragment): (state, overflow), the
    overflow a host int; a table route that left a run unplaced runs
    again on the sorted route."""
    fn = make_join_agg_fragment(probe, build, *args, **kwargs)
    state, ovf, unplaced = fn(probe.args(), build.args())
    # the gates, in one fetch after the program
    ovf, unplaced = dispatch.device_get((ovf, unplaced))
    if unplaced:
        return dist_join_agg_fragment(probe, build, *args,
                                      **{**kwargs, "probe_mode": "off"})
    return state, int(ovf)
