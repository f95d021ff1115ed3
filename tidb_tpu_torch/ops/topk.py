"""Bounded device top-k state (counterpart of tidb_tpu/ops/topk.py).

``executor/sort.py``'s TopNExec brings every child row to the host before
one ``np.lexsort`` keeps the ``LIMIT k`` survivors. This module is the
device side of ``FusedScanTopNExec``: a top-k state of capacity C rides
across staged scan chunks like the fused aggregation's state, each chunk
is merged in by one lexicographic sort over the concatenated [C + N] key
operands, and the host fetches the C winners once at finalize.

The order replicates ``executor/sort.py::_sort_order`` exactly: MySQL NULL
ordering (NULLs first ASC, last DESC) by a null-rank operand that dominates
the value within each key, DESC by negation, bools widened to int64, floats
compared as float64, then a global drain-position operand, so ties resolve
in drain order as ``np.lexsort``'s stability does and fused == classic row
for row.

The reference sorts with ``lax.sort(..., num_keys=k)``; here the same
permutation comes from stable ``torch.sort`` passes (``lex_perm``). Float
operands sort through ``float_order_key``, XLA's comparator order:
-inf < ... < -0.0 == 0.0 < ... < inf < NaN, every NaN equal.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["rank_operands", "topk_init", "topk_merge", "merge_topk", "key_spec",
           "float_order_key", "lex_perm"]

_LOW63 = (1 << 63) - 1


def lex_perm(keys) -> torch.Tensor:
    """The permutation that orders rows by `keys` lexicographically (keys[0]
    primary), ties in row order: one stable sort per key, last key first.
    The port's counterpart of ``lax.sort(..., num_keys=len(keys))``'s
    carried iota (shared with executor/agg_device.py)."""
    perm = torch.arange(keys[0].shape[0], dtype=torch.int64, device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def key_spec(type_) -> bool:
    """Static per-key value-dtype flag: True when the key compares as
    float64 (else int64), from the SQL type, so ``topk_init``'s state and
    ``rank_operands``' operands never disagree on dtype."""
    return bool(np.issubdtype(type_.np_dtype, np.floating))


def float_order_key(x: torch.Tensor) -> torch.Tensor:
    """An int64 whose signed order is XLA's total sort order of float64 `x`:
    -0.0 joins 0.0, every NaN becomes the one positive NaN (above inf), and
    negative floats flip their low 63 bits."""
    x = torch.where(x == 0, 0.0, x)
    x = torch.where(torch.isnan(x), torch.nan, x)
    bits = x.view(torch.int64)
    return torch.where(bits < 0, bits ^ _LOW63, bits)


def _order_key(t: torch.Tensor) -> torch.Tensor:
    return float_order_key(t) if t.is_floating_point() else t


def rank_operands(data, valid, desc: bool):
    """One sort key -> its (null-rank, value) operand pair, as
    ``_sort_order`` does: ASC ranks NULLs (0) before values (1), DESC ranks
    NULLs (1) after values (0) and negates the value; NULL slots carry 0 so
    the rank operand alone decides them."""
    d = data
    if d.dtype == torch.bool:
        d = d.to(torch.int64)
    d = d.to(torch.float64) if d.is_floating_point() else d.to(torch.int64)
    if desc:
        d = -d
        nullrank = (~valid).to(torch.int32)
    else:
        nullrank = valid.to(torch.int32)
    d = torch.where(valid, d, torch.zeros_like(d))
    return nullrank, d


def topk_init(cap: int, key_floats: Sequence[bool], payload_dtypes: Sequence[torch.dtype],
              device):
    """The empty top-k state: every slot dead (dead=1 sorts after any live
    row), zeroed key operands and payload, the drain-position counter at 0:

        (dead [C] i32,
         ((nullrank [C] i32, value [C] i64|f64), ...) per sort key,
         pos [C] i64, next_pos 0-d i64,
         ((data [C], valid [C] bool), ...) per output column)
    """
    def zeros(dt):
        return torch.zeros(cap, dtype=dt, device=device)

    dead = torch.ones(cap, dtype=torch.int32, device=device)
    ranks = tuple((zeros(torch.int32), zeros(torch.float64 if f else torch.int64))
                  for f in key_floats)
    next_pos = torch.zeros((), dtype=torch.int64, device=device)
    payload = tuple((zeros(dt), zeros(torch.bool)) for dt in payload_dtypes)
    return (dead, ranks, zeros(torch.int64), next_pos, payload)


def _kth_smallest(masked: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Exact k-th smallest (1-based, k a 0-d tensor pre-clamped to [1, n])
    of a sentinel-masked value array, as a 0-d tensor. The reference picks
    between a sampled candidate buffer and a full sort with ``lax.cond``
    on a device value; both are exact, and this takes the full sort, so no
    device value is read on the host."""
    n = masked.shape[0]
    at = (k - 1).clamp(0, n - 1).reshape(1)
    return torch.sort(masked).values.index_select(0, at).reshape(())


def _cut_single_key(nullrank, value, sel, cap: int, desc: bool):
    """Exact top-``cap`` candidate cut of one chunk for a SINGLE sort key,
    from one single-array sort and prefix sums, so the merge sorts 2·cap
    rows instead of cap + N.

    The key's classes select in rank order: ASC NULLs, values, NaN; DESC
    values, NaN, NULLs (NaN ranks after every value in both directions, as
    in ``np.lexsort`` and the merge's order). The NULL and NaN classes tie
    completely, so their winners are the first k in drain (array) order.
    The value class takes every row strictly better than the k-th best
    value, plus boundary ties in drain order. NaN must be its own class:
    ``< thresh`` and ``== thresh`` are both false for it.

    Returns ``(idx [cap] int64, live [cap] bool)``: source-row gathers for
    the candidate buffer (winner order is irrelevant: the merge re-sorts)."""
    n = sel.shape[0]
    is_null = (nullrank == (1 if desc else 0)) & sel
    is_val = sel & ~is_null
    is_nan = None
    n_nan = torch.zeros((), dtype=torch.int64, device=sel.device)
    if value.is_floating_point():
        is_nan = is_val & torch.isnan(value)
        is_val = is_val & ~is_nan
        n_nan = is_nan.sum(dtype=torch.int64)
    n_null = is_null.sum(dtype=torch.int64)
    n_val = is_val.sum(dtype=torch.int64)
    c = torch.full((), cap, dtype=torch.int64, device=sel.device)
    if desc:  # values, NaN, NULLs
        k_val = torch.minimum(c, n_val)
        k_nan = torch.minimum(c - k_val, n_nan)
        k_null = torch.minimum(c - k_val - k_nan, n_null)
    else:  # NULLs, values, NaN
        k_null = torch.minimum(c, n_null)
        k_val = torch.minimum(c - k_null, n_val)
        k_nan = torch.minimum(c - k_null - k_val, n_nan)
    win_null = is_null & (torch.cumsum(is_null.to(torch.int64), 0) <= k_null)
    if value.is_floating_point():
        sentinel = torch.inf
    else:
        sentinel = torch.iinfo(value.dtype).max
    masked = torch.where(is_val, value, sentinel)
    thresh = _kth_smallest(masked, torch.clamp(k_val, min=1))
    strict = is_val & (masked < thresh)
    boundary = is_val & (masked == thresh)
    bcum = torch.cumsum(boundary.to(torch.int64), 0)
    n_strict = strict.sum(dtype=torch.int64)
    win = win_null | ((strict | (boundary & (bcum <= k_val - n_strict))) & (k_val > 0))
    if is_nan is not None:
        win = win | (is_nan & (torch.cumsum(is_nan.to(torch.int64), 0) <= k_nan))
    # compact the <= cap winners by search: the j-th winner sits at the
    # first index whose running win count reaches j + 1
    wcum = torch.cumsum(win.to(torch.int64), 0)
    want = torch.arange(1, cap + 1, dtype=torch.int64, device=sel.device)
    idx = torch.searchsorted(wcum, want, side="left")
    live = torch.arange(cap, device=sel.device) < wcum[n - 1]
    return idx.clamp(0, n - 1), live


def topk_merge(state, key_pairs: Tuple, payload_cols: Tuple, sel, descs: Tuple = None):
    """One chunk folded into the state. Concatenates the state's C entries
    with the chunk's N rows per operand, sorts once by (dead, per-key
    null-rank/value pairs, drain position), keeps the first C of every
    operand, and gathers the payload from the state (slot < C) or the
    chunk. Filtered-out chunk rows (sel False) enter dead and never
    displace a live entry.

    With ``descs`` given and a SINGLE sort key, a chunk larger than C is
    first cut to C exact candidates by ``_cut_single_key``. Multi-key
    chunks keep the full merge (a key-boundary tie class is unbounded, so
    no fixed candidate buffer can cut them exactly)."""
    dead, ranks, pos, next_pos, payload = state
    C = dead.shape[0]
    N = sel.shape[0]
    cpos = next_pos + torch.arange(N, dtype=torch.int64, device=sel.device)
    new_next = next_pos + N
    if descs is not None and len(key_pairs) == 1 and N > C:
        (cnr, cv), = key_pairs
        idx, live = _cut_single_key(cnr, cv, sel, C, bool(descs[0]))
        key_pairs = ((cnr[idx], cv[idx]),)
        payload_cols = tuple((d[idx], v[idx]) for d, v in payload_cols)
        cpos = cpos[idx]
        sel = live
        N = C
    ops = [torch.cat([dead, (~sel).to(torch.int32)])]
    for (snr, sv), (cnr, cv) in zip(ranks, key_pairs):
        ops.append(torch.cat([snr, cnr]))
        ops.append(torch.cat([sv, cv]))
    ops.append(torch.cat([pos, cpos]))
    perm = lex_perm([_order_key(o) for o in ops])[:C]
    top = [o[perm] for o in ops]
    from_state = perm < C
    si = perm.clamp(0, C - 1)
    ci = (perm - C).clamp(0, max(N - 1, 0))
    new_ranks = tuple((top[1 + 2 * i], top[2 + 2 * i]) for i in range(len(ranks)))
    new_payload = tuple(
        (torch.where(from_state, sd[si], cd[ci]), torch.where(from_state, sv[si], cv[ci]))
        for (sd, sv), (cd, cv) in zip(payload, payload_cols))
    return (top[0], new_ranks, top[-1], new_next, new_payload)


def merge_topk(state, key_pairs, payload_cols, sel, descs=None):
    """Standalone merge (kernel tests and non-fused callers); the fused
    scan->top-k program calls ``topk_merge`` per staged chunk."""
    return topk_merge(state, tuple(key_pairs), tuple(payload_cols), sel,
                      None if descs is None else tuple(descs))
