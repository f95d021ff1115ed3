"""Device generic aggregation: sort-based grouping (counterpart of
tidb_tpu/executor/agg_device.py).

The segment strategy (aggregate.py) needs a small dense key domain; this
module groups arbitrary and high-cardinality keys on the device:

  per chunk:  sort rows by (dead, key identity) -> segment boundaries
              (adjacent inequality) -> segment ids -> per-segment sums,
              mins and maxes of the mergeable states -> a dense "group
              table": slot i < n holds group i's key values and states,
              every array [capacity]-shaped.

  across chunks: group tables merge pairwise on the device (concatenate,
              then the same sort-reduce over the state arrays) in a
              binary-counter schedule (GroupTableStack), so at most
              log2(chunks) + 1 tables are live and nothing visits the host
              until finalize.

  finalize:   the live level tables cross to the host in one batched fetch
              (fetch_tables) and the host merges them in aggregate.py's
              partial-state format (table_to_host_partial).

A group table is a dict of tensors on the chunk's device; its "n" is a 0-d
int64 tensor, so the per-chunk path never reads a device value on the host.

The reference sorts with ``lax.sort(..., num_keys=k)``, which orders by its
first k operands lexicographically and carries an iota. torch has no
variadic sort, so the permutation comes from stable ``torch.sort`` passes,
from the last key to the first (``lex_perm``). Where the reference's keys
leave ties (rows with one key), the stable passes keep row order; the group
slots come out in the reference's order either way.

NULL-key semantics: a key is (bits, valid); valid takes part in the sort and
in boundary detection, so NULL forms its own group. Float keys group by bit
pattern, so -0.0 and 0.0, and NaNs with different payloads, are distinct
groups, as in the reference.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from tidb_tpu_torch.chunk.chunk import Chunk
from tidb_tpu_torch.expression.compiler import eval_expr
from tidb_tpu_torch.ops.topk import lex_perm
from tidb_tpu_torch.planner.logical import AggSpec
from tidb_tpu_torch.types import TypeKind
from tidb_tpu_torch.utils import dispatch
from tidb_tpu_torch.utils.device import torch_dtype

__all__ = ["make_partial_kernel", "make_merge_kernel", "GroupTableStack",
           "table_to_host_partial", "fetch_tables"]

_MIX_MUL = -7046029254386353131
_MIX_ADD = 0x165667B19E3779F9


def _bits64(data: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Group-identity bits: NULLs unify to 0, floats group by bit pattern."""
    if data.is_floating_point():
        b = data.to(torch.float64).view(torch.int64)
    else:
        b = data.to(torch.int64)
    return torch.where(valid, b, 0)


def _group_hash(kbits: List[torch.Tensor], kvalids: List[torch.Tensor]) -> torch.Tensor:
    """One int64 ordering hash over all key components (validity folded in
    so a NULL key and a live 0 key land in different runs). torch's int64
    multiply and add wrap as jnp's do."""
    h = torch.zeros_like(kbits[0])
    for b, v in zip(kbits, kvalids):
        hb = b * 2 + v.to(torch.int64)
        h = (h ^ hb) * _MIX_MUL + _MIX_ADD
    return h


def _ident(op: str, dtype: torch.dtype):
    """The identity of a min ("min") or max reduction over `dtype`."""
    if dtype.is_floating_point:
        return torch.inf if op == "min" else -torch.inf
    info = torch.iinfo(dtype)
    return info.max if op == "min" else info.min


def _segment_extreme(arr: torch.Tensor, seg: torch.Tensor, R: int, op: str) -> torch.Tensor:
    """jax.ops.segment_min/max over R segments: identity-filled outputs and
    scatter_reduce_; a float segment holding a NaN gives NaN, as XLA's
    min/max do, on every backend."""
    out = torch.full((R,), _ident(op, arr.dtype), dtype=arr.dtype, device=arr.device)
    out.scatter_reduce_(0, seg, arr, reduce="amin" if op == "min" else "amax",
                        include_self=True)
    if arr.is_floating_point():
        nans = torch.zeros(R, dtype=torch.int32, device=arr.device)
        nans.index_add_(0, seg, torch.isnan(arr).to(torch.int32))
        out = torch.where(nans > 0, torch.nan, out)
    return out


def _sort_reduce(kbits: List[torch.Tensor], kvalids: List[torch.Tensor],
                 kdatas: List[torch.Tensor], live: torch.Tensor,
                 payload: List[torch.Tensor], reduce_ops: List[str],
                 exact: bool = False):
    """Shared core: sort rows by (dead, key identity), find segment
    boundaries, reduce payload arrays into dense per-group slots.

    Only the order keys go through the sort; key values and payloads are
    gathered by the permutation. Single-key inputs order by the exact key
    bits and validity; multi-key inputs order by a mixed 64-bit hash with
    exact-key boundary detection, so a hash collision can only SPLIT a
    group into two slots (never merge two groups): the host finalize
    dedups by exact key (HashAggExec._finalize_group_tables). With
    `exact`, multi-key inputs order by the hash and then every key's bits
    and validity, so equal keys are contiguous and the table holds no
    collision-split duplicate (the mesh tier's exchange-side reduce emits
    its tables as they are).

    Returns (ngroups 0-d int64, rep_kdatas, rep_kvalids, reduced_payloads),
    every slot array with the groups dense in [0, ngroups)."""
    R = live.shape[0]
    dev = live.device
    dead = (~live).to(torch.int32)
    if len(kbits) == 1:
        # exact: equal bits tie-break on validity (NULL run != live-0 run)
        perm = lex_perm([dead, kbits[0], kvalids[0].to(torch.int32)])
    elif exact:
        # validity joins the tie-break: NULL bits are 0, so a NULL key and
        # a live 0 differ only there
        perm = lex_perm([dead, _group_hash(kbits, kvalids)] + list(kbits)
                        + [v.to(torch.int32) for v in kvalids])
    else:
        perm = lex_perm([dead, _group_hash(kbits, kvalids)])

    s_kbits = [b[perm] for b in kbits]
    s_kdatas = [d[perm] for d in kdatas]
    s_kvalids = [v[perm] for v in kvalids]
    s_payload = [p[perm] for p in payload]
    s_live = live[perm]

    # live rows are a prefix (dead sorts last); a new segment starts at row
    # 0 or where any exact key component differs from the previous row
    idx = torch.arange(R, device=dev)
    diff = torch.zeros(R, dtype=torch.bool, device=dev)
    for b, v in zip(s_kbits, s_kvalids):
        diff = diff | (b != torch.roll(b, 1)) | (v != torch.roll(v, 1))
    newseg = s_live & ((idx == 0) | diff)
    seg = (torch.cumsum(newseg.to(torch.int64), 0) - 1).clamp(0, R - 1)
    ngroups = newseg.sum(dtype=torch.int64)

    # representative key values per group, scattered from boundary rows
    # only: dead rows share the last group's clipped seg id and would
    # clobber its key. Non-boundary rows land in a spare slot R.
    tgt = torch.where(newseg, seg, R)

    def scatter_reps(vals: torch.Tensor) -> torch.Tensor:
        out = torch.zeros(R + 1, dtype=vals.dtype, device=dev)
        out[tgt] = vals
        return out[:R]

    rep_kdatas = [scatter_reps(d) for d in s_kdatas]
    rep_kvalids = [scatter_reps(v) for v in s_kvalids]

    reduced = []
    for arr, op in zip(s_payload, reduce_ops):
        if op == "sum":
            out = torch.zeros(R, dtype=arr.dtype, device=dev)
            reduced.append(out.index_add_(0, seg, torch.where(s_live, arr, 0)))
        elif op in ("min", "max"):
            contrib = torch.where(s_live, arr, _ident(op, arr.dtype))
            reduced.append(_segment_extreme(contrib, seg, R, op))
        else:  # pragma: no cover
            raise ValueError(op)
    return ngroups, rep_kdatas, rep_kvalids, reduced


def _state_layout(aggs: List[AggSpec]) -> List[Tuple[str, str]]:
    """Per-agg mergeable state arrays: [(name, merge op)], the keys of
    aggregate.py's partial states (cnt/sum/sumhi/min/max)."""
    from tidb_tpu_torch.executor.aggregate import needs_sum_limbs

    layout = []
    for j, a in enumerate(aggs):
        layout.append((f"a{j}.cnt", "sum"))
        if a.func in ("sum", "avg"):
            layout.append((f"a{j}.sum", "sum"))
            if needs_sum_limbs(a):
                # two-limb exact decimal states: .sum = low 32-bit limb
                layout.append((f"a{j}.sumhi", "sum"))
        elif a.func == "min":
            layout.append((f"a{j}.min", "min"))
        elif a.func == "max":
            layout.append((f"a{j}.max", "max"))
    return layout


def make_partial_kernel(group_exprs, aggs: List[AggSpec]):
    """fn(chunk) -> group table dict {"n", "k{i}.d", "k{i}.v", state...}."""
    from tidb_tpu_torch.executor.aggregate import needs_sum_limbs, split_limbs

    layout = _state_layout(aggs)

    def partial(chunk: Chunk):
        sel = chunk.sel
        kdatas, kvalids, kbits = [], [], []
        for g in group_exprs:
            d, v = eval_expr(g, chunk)
            kdatas.append(d)
            kvalids.append(v)
            kbits.append(_bits64(d, v))

        payload, ops = [], []
        for a in aggs:
            if a.arg is not None:
                d, v = eval_expr(a.arg, chunk)
                ok = sel & v
            else:  # count(*)
                d, ok = None, sel
            payload.append(ok.to(torch.int64))
            ops.append("sum")  # the .cnt slot
            if a.func in ("sum", "avg"):
                dt = torch.float64 if a.arg.type_.kind == TypeKind.FLOAT else torch.int64
                contrib = torch.where(ok, d, 0).to(dt)
                if needs_sum_limbs(a):
                    clo, chi = split_limbs(contrib)
                    payload += [clo, chi]
                    ops += ["sum", "sum"]
                else:
                    payload.append(contrib)
                    ops.append("sum")
            elif a.func in ("min", "max"):
                dt = torch_dtype(a.arg.type_.np_dtype)
                payload.append(torch.where(ok, d, _ident(a.func, dt)).to(dt))
                ops.append(a.func)

        n, rk, rkv, red = _sort_reduce(kbits, kvalids, kdatas, sel, payload, ops)
        table = {"n": n}
        for i in range(len(group_exprs)):
            table[f"k{i}.d"] = rk[i]
            table[f"k{i}.v"] = rkv[i]
        for (name, _), arr in zip(layout, red):
            table[name] = arr
        return table

    return partial


def make_merge_kernel(nkeys: int, aggs: List[AggSpec]):
    """fn(tableA, tableB) -> merged table with len(A) + len(B) slots."""
    layout = _state_layout(aggs)

    def merge(ta, tb):
        def cat(name):
            return torch.cat([ta[name], tb[name]])

        dev = ta["k0.d"].device
        la = torch.arange(ta["k0.d"].shape[0], device=dev) < ta["n"]
        lb = torch.arange(tb["k0.d"].shape[0], device=dev) < tb["n"]
        live = torch.cat([la, lb])
        kdatas = [cat(f"k{i}.d") for i in range(nkeys)]
        kvalids = [cat(f"k{i}.v") for i in range(nkeys)]
        kbits = [_bits64(d, v) for d, v in zip(kdatas, kvalids)]
        payload = [cat(name) for name, _ in layout]
        ops = [op for _, op in layout]
        n, rk, rkv, red = _sort_reduce(kbits, kvalids, kdatas, live, payload, ops)
        table = {"n": n}
        for i in range(nkeys):
            table[f"k{i}.d"] = rk[i]
            table[f"k{i}.v"] = rkv[i]
        for (name, _), arr in zip(layout, red):
            table[name] = arr
        _normalize_table_limbs(table, aggs)
        return table

    return merge


def _normalize_table_limbs(table, aggs: List[AggSpec]) -> None:
    """Carry-normalize every (lo, hi) limb pair in a group table, so lo
    stays in [0, 2^32) however many merges stack (a group fed by 2^31+ rows
    would otherwise wrap the lo accumulator)."""
    from tidb_tpu_torch.executor.aggregate import normalize_limbs

    for j in range(len(aggs)):
        if f"a{j}.sumhi" in table:
            table[f"a{j}.sum"], table[f"a{j}.sumhi"] = normalize_limbs(
                table[f"a{j}.sum"], table[f"a{j}.sumhi"])


class GroupTableStack:
    """Binary-counter accumulation of device group tables.

    push() merges equal-sized tables at once (level L holds one table of
    chunk_capacity * 2^L slots), so at most log2(chunks) + 1 tables are
    live. The reference donates the merged inputs to the merge program;
    here the stack drops its references to them as each merge returns, so
    the caching allocator can reuse their blocks for the next merge."""

    def __init__(self, nkeys: int, aggs: List[AggSpec]):
        self._levels: List[object] = []
        self._merge = make_merge_kernel(nkeys, aggs)

    def push(self, table) -> None:
        level = 0
        while level < len(self._levels) and self._levels[level] is not None:
            lower, self._levels[level] = self._levels[level], None
            table = self._merge(lower, table)
            del lower
            level += 1
        if level == len(self._levels):
            self._levels.append(None)
        self._levels[level] = table

    def tables(self) -> List[object]:
        return [t for t in self._levels if t is not None]


def fetch_tables(tables: List[dict]) -> List[Dict[str, np.ndarray]]:
    """The finalize fetch of device group tables: every table's slot count
    in one copy, then every table's live slots [:n] in one more."""
    if not tables:
        return []
    ns = [int(n) for n in dispatch.device_get(torch.stack([t["n"] for t in tables]))]
    names = [[k for k in t if k != "n"] for t in tables]
    arrays = dispatch.device_get([t[k][:n] for t, n, ks in zip(tables, ns, names) for k in ks])
    out, i = [], 0
    for n, ks in zip(ns, names):
        host = {"n": np.int64(n)}
        for k in ks:
            host[k] = arrays[i]
            i += 1
        out.append(host)
    return out


def table_to_host_partial(host_table: Dict[str, np.ndarray], nkeys: int,
                          aggs: List[AggSpec]) -> dict:
    """Convert a fetched group table into aggregate.py's partial-state
    format ({"mat", "keys", "kvalids", "states"}) so the host merge/emit
    path finalizes it."""
    n = int(host_table["n"])
    keys = [np.asarray(host_table[f"k{i}.d"][:n]) for i in range(nkeys)]
    kvalids = [np.asarray(host_table[f"k{i}.v"][:n]).astype(np.bool_)
               for i in range(nkeys)]

    def bits(k, kv):
        a = np.where(kv, k, 0)
        if np.issubdtype(a.dtype, np.floating):
            return a.astype(np.float64).view(np.int64)
        return a.astype(np.int64)

    mat = (np.stack([bits(k, kv) for k, kv in zip(keys, kvalids)]
                    + [kv.astype(np.int64) for kv in kvalids], axis=1)
           if nkeys else np.zeros((1, 0), dtype=np.int64))
    states = []
    for j, a in enumerate(aggs):
        st = {"cnt": np.asarray(host_table[f"a{j}.cnt"][:n])}
        if a.func in ("sum", "avg"):
            st["sum"] = np.asarray(host_table[f"a{j}.sum"][:n])
            if f"a{j}.sumhi" in host_table:
                st["sumhi"] = np.asarray(host_table[f"a{j}.sumhi"][:n])
        elif a.func in ("min", "max"):
            st[a.func] = np.asarray(host_table[f"a{j}.{a.func}"][:n])
        states.append(st)
    return {"mat": mat, "keys": keys, "kvalids": kvalids, "states": states}
