"""The device programs of the hash join, in plain torch.

Counterpart of tidb_tpu/ops/join_kernels.py, where XLA compiles each of
these; here they run eagerly on the tensors' device. What each does:

  * `build_sort`: pack the build keys (range packing, or a 64-bit mixing
    hash when the ranges overflow), send NULL/dead keys to INT64_MAX with
    a tail flag, sort, and gather the payload into sorted order. The
    reference's sort is not stable; this one is (two stable passes), so
    rows of one key may come out in another order than the reference's.
  * `build_direct_index`: the [rng + 1] run-start prefix array over a
    dense packed-key domain; a probe resolves in two gathers.
  * `build_hash_table`: the open-addressing table of ops/hash_probe.py,
    or None when the build is too big or some run was left unplaced (one
    host read per build).
  * `probe_count`: pack -> range lookup (direct index, table, or
    searchsorted) -> per-row match count -> prefix sum, one call per
    probe chunk. The pack stays here; the rest is ops/hash_probe.py's
    `probe_chunk`, one kernel launch on the card. `PROBE_ROUTES` counts
    the route per call (the reference's JOIN_PROBE_MODE_TOTAL).
  * `tile_positions` / `expand_tiles`: map output slots to (probe row,
    build position) and gather both sides into [T, C] output tiles.
  * `sort_build_hashes` / `probe_hash_ranges`: the mesh tier's join
    primitives (parallel/fragment.py): a shard's build hashes sorted
    with dead rows after the live rows of each hash, and each probe
    row's range over them with its exact live-match count.

Ranges clamp to n_build, so the sentinel tail (NULL, dead and padding
build keys at INT64_MAX) never produces a match, on every route.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from tidb_tpu_torch.ops import hash_probe as hp
from tidb_tpu_torch.ops.hash_probe import srl
from tidb_tpu_torch.utils import dispatch

__all__ = [
    "shape_bucket", "as_int64_key", "hash_combine_device", "pack_keys",
    "build_sort", "build_direct_index", "build_hash_table",
    "probe_count", "tile_positions", "expand_tiles",
    "PROBE_ROUTES", "reset_routes", "sort_build_hashes", "probe_hash_ranges",
]

I64_MAX = (1 << 63) - 1

# splitmix64 constants (utils/hashutil.py) as int64 bit patterns
_SM_ADD = hp.i64_bits(0x9E3779B97F4A7C15)
_SM_MUL1 = hp.i64_bits(0xBF58476D1CE4E5B9)
_SM_MUL2 = hp.i64_bits(0x94D049BB133111EB)

# range lookups per probe_count call, by route
PROBE_ROUTES = {"direct": 0, "table": 0, "sorted": 0}


def reset_routes() -> None:
    for k in PROBE_ROUTES:
        PROBE_ROUTES[k] = 0


def _count_route(route: str) -> None:
    PROBE_ROUTES[route] += 1


def shape_bucket(n: int, floor: int = 64) -> int:
    """Next power of two >= max(n, floor): the padding target of build
    sides and probe chunks."""
    b = max(int(floor), 1)
    while b < n:
        b *= 2
    return b


def _wrap64(x: int) -> int:
    """A Python int reduced to int64 two's complement (jnp's overflow)."""
    return ((x + (1 << 63)) % (1 << 64)) - (1 << 63)


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """jnp.take(a, idx, mode='clip')."""
    return a[idx.clamp(0, a.shape[0] - 1)]


# -- key packing -------------------------------------------------------------

def as_int64_key(d: torch.Tensor, mode: str) -> torch.Tensor:
    """Comparable int64 key; floats by bit pattern ('bits' mode)."""
    if mode == "bits":
        return d.to(torch.float64).view(torch.int64)
    return d.to(torch.int64)


def hash_combine_device(keys_i64: Sequence[torch.Tensor]) -> torch.Tensor:
    """uint64 mixing hash of composite int64 keys (splitmix64 finalizer),
    as int64 bits."""
    h = torch.zeros_like(keys_i64[0], dtype=torch.int64)
    for k in keys_i64:
        z = k.to(torch.int64) + _SM_ADD
        z = (z ^ srl(z, 30)) * _SM_MUL1
        z = (z ^ srl(z, 27)) * _SM_MUL2
        z = z ^ srl(z, 31)
        h = (h * _SM_ADD) ^ z
    return h


def _pack(key_datas, key_valids, los, strides, rngs, sel,
          modes: Tuple[str, ...], hash_mode: bool):
    """pack_keys with in-range None where every key is in range (single
    keys, hash mode): the probe then reads no all-true mask, and a single
    int64 key costs no launch."""
    if not key_datas:  # keyless (cross) join: a constant key matches all
        return (torch.zeros(sel.shape[0], dtype=torch.int64, device=sel.device),
                torch.ones_like(sel, dtype=torch.bool), None)
    if hash_mode:
        keys = [as_int64_key(d, m) for d, m in zip(key_datas, modes)]
        valid = key_valids[0]
        for v in key_valids[1:]:
            valid = valid & v
        # every hash is "in range"; exact per-key verification removes
        # false candidates after expansion
        return hash_combine_device(keys), valid, None
    if len(key_datas) == 1:
        return as_int64_key(key_datas[0], modes[0]), key_valids[0], None
    packed = torch.zeros(sel.shape[0], dtype=torch.int64, device=sel.device)
    valid = in_range = None
    for i, (d, v) in enumerate(zip(key_datas, key_valids)):
        d = as_int64_key(d, modes[i])
        lo, stride, rng = los[i], strides[i], rngs[i]
        valid = v if valid is None else valid & v
        r = (d >= lo) & (d < _wrap64(lo + rng))
        in_range = r if in_range is None else in_range & r
        packed = packed + (d - lo).clamp(0, max(rng - 1, 0)) * stride
    return packed, valid, in_range


def pack_keys(key_datas, key_valids, los, strides, rngs, sel,
              modes: Tuple[str, ...], hash_mode: bool):
    """(packed int64, key-valid, in-range) from per-key tensors and the
    host-known pack ranges (lists of Python ints). Out of range is a
    definite non-match, not a NULL: anti joins keep the row."""
    packed, valid, in_range = _pack(key_datas, key_valids, los, strides, rngs, sel,
                                    modes, hash_mode)
    if in_range is None:
        in_range = torch.ones_like(sel, dtype=torch.bool)
    return packed, valid, in_range


# -- build ---------------------------------------------------------------------

def build_sort(key_datas, key_valids, ok, payload_datas, payload_valids,
               los, strides, rngs, modes, hash_mode):
    """Device-resident build over inputs padded to a shape bucket with
    ok=False padding: (sorted_keys [B], n_build 0-d tensor, sorted payload
    datas, valids, and the raw key values in sorted order, which only
    hash-mode verification reads)."""
    packed, kvalid, in_range = pack_keys(
        key_datas, key_valids, los, strides, rngs, ok, modes, hash_mode)
    live = ok & kvalid & in_range
    # dead keys -> INT64_MAX, sorted after any legitimate INT64_MAX key by
    # the flag, so [0, n_build) is exactly the live sorted prefix
    skey = torch.where(live, packed, torch.full_like(packed, I64_MAX))
    flag = (~live).to(torch.int32)
    by_flag = torch.sort(flag, stable=True).indices
    order = by_flag[torch.sort(skey[by_flag], stable=True).indices]
    sorted_keys = skey[order]
    n_build = live.sum(dtype=torch.int64)
    out_d = tuple(d[order] for d in payload_datas)
    out_v = tuple(v[order] for v in payload_valids)
    out_k = (tuple(as_int64_key(d, m)[order] for d, m in zip(key_datas, modes))
             if hash_mode else ())
    return sorted_keys, n_build, out_d, out_v, out_k


def build_direct_index(sorted_keys, n_build, lo: int, rng_bucket: int):
    """[rng_bucket + 1] run-start positions over the dense packed-key
    domain [lo, lo + rng_bucket): firsts[i] is the first sorted position
    with key >= lo + i."""
    B = sorted_keys.shape[0]
    dev = sorted_keys.device
    live = torch.arange(B, dtype=torch.int64, device=dev) < n_build
    idx = (sorted_keys - lo).clamp(0, rng_bucket - 1)
    counts = torch.zeros(rng_bucket + 1, dtype=torch.int64, device=dev)
    counts.index_add_(0, torch.where(live, idx, torch.full_like(idx, rng_bucket)),
                      torch.ones_like(idx))
    return torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      torch.cumsum(counts[:rng_bucket], 0)])


# the open-addressing table over the sorted build keys, built once per
# join build and passed to every probe_count (None: stay on searchsorted).
# The sentinel tail forms ordinary runs that the n_build clamp cuts.
build_hash_table = hp.placed_table


# -- probe -----------------------------------------------------------------

def probe_count(sorted_keys, n_build, key_datas, key_valids, sel,
                los, strides, rngs, firsts, lo_packed, rng_packed,
                modes, hash_mode, left_pad, direct, table=None, flags_only=False):
    """Probe one chunk: (start, count, real_count, cum, total, ok,
    matched). `total` (a 0-d tensor) is the only value a caller reads on
    the host, to size the expansion. With `flags_only` (the unfiltered
    semi and anti joins) only ok and matched are made; the rest are None.
    The keys are packed here; the lookup, count, pad and prefix sum are
    hash_probe.probe_chunk, one kernel launch on the card."""
    route = "direct" if direct else ("table" if table is not None else "sorted")
    # at each replay when this runs inside a CUDA graph's capture
    dispatch.on_execute(_count_route, route)
    packed, kvalid, in_range = _pack(
        key_datas, key_valids, los, strides, rngs, sel, modes, hash_mode)
    return hp.probe_chunk(packed, kvalid, in_range, sel, n_build, sorted_keys,
                          route=route, firsts=firsts, lo_packed=lo_packed,
                          rng_packed=rng_packed, table=table, left_pad=left_pad,
                          flags_only=flags_only)


# -- expansion ---------------------------------------------------------------

def tile_positions(start, count, cum, w0: int, n_slots: int,
                   n_probe_cap: int, n_build_cap: int):
    """Map output slots [w0, w0 + n_slots) to (valid_out, probe_row,
    build_pos, k). probe_row is a scalar searchsorted at the window base
    plus a running count of the row boundaries inside the window."""
    dev = cum.device
    total = cum[-1]
    j = w0 + torch.arange(n_slots, dtype=torch.int64, device=dev)
    valid_out = j < total
    w0_t = torch.full((1,), w0, dtype=torch.int64, device=dev)
    row0 = torch.searchsorted(cum, w0_t, right=True)  # the window's base row
    bound = cum - w0  # row r's matches end at window-relative slot bound[r]
    in_win = (bound >= 1) & (bound <= n_slots - 1)
    marks = torch.zeros(n_slots + 1, dtype=torch.int64, device=dev)
    marks.index_add_(0, torch.where(in_win, bound, torch.full_like(bound, n_slots)),
                     torch.ones_like(bound))
    probe_row = (row0 + torch.cumsum(marks[:n_slots], 0)).clamp(0, n_probe_cap - 1)
    k = j - (cum[probe_row] - count[probe_row])
    build_pos = (start[probe_row] + k).clamp(0, max(n_build_cap - 1, 0))
    return valid_out, probe_row, build_pos, k


def expand_tiles(start, count, real_count, cum, w0: int,
                 probe_datas, probe_valids, build_datas, build_valids,
                 n_tiles: int, tile_cap: int, build_cap: int, left=False,
                 with_probe_row=False, with_build_pos=False):
    """`n_tiles` output tiles of capacity `tile_cap` ([T, C] tensors)
    starting at flat output offset `w0`: (probe (data, valid) pairs,
    build pairs, sel, probe_row or None, build_pos or None)."""
    R = start.shape[0]
    valid_out, probe_row, build_pos, k = tile_positions(
        start, count, cum, w0, n_tiles * tile_cap, R, build_cap)

    def shape(a):
        return a.reshape(n_tiles, tile_cap)

    out_p = tuple((shape(_take(d, probe_row)), shape(_take(v, probe_row) & valid_out))
                  for d, v in zip(probe_datas, probe_valids))
    real = (k < real_count[probe_row]) if left else None
    out_b: List = []
    for d, v in zip(build_datas, build_valids):
        bv = _take(v, build_pos) & valid_out
        if left:
            # the left-join pad slot (k beyond the real match count)
            # carries NULL build payload
            bv = bv & real
        out_b.append((shape(_take(d, build_pos)), shape(bv)))
    prow = shape(probe_row) if with_probe_row else None
    bpos = shape(build_pos) if with_build_pos else None
    return out_p, tuple(out_b), shape(valid_out), prow, bpos


# -- the fragment tier's primitives (parallel/fragment.py) -------------------

def sort_build_hashes(b_hash: torch.Tensor, b_live: torch.Tensor):
    """(sorted hashes, cvi, order) of a shard's build side: rows ordered by
    (hash, dead), so dead rows sort after the live rows of their hash, and
    cvi[i] counts the live rows of the sorted prefix [0, i), making
    cvi[hi] - cvi[lo] a range's exact live-match count. The reference's
    lax.sort is not stable; this one is (two stable passes)."""
    from tidb_tpu_torch.ops.topk import lex_perm

    inval = (~b_live).to(torch.int32)
    order = lex_perm([b_hash, inval])
    sinv = inval[order]
    cvi = torch.cat([torch.zeros(1, dtype=torch.int64, device=b_hash.device),
                     torch.cumsum((sinv == 0).to(torch.int64), 0)])
    return b_hash[order], cvi, order


def probe_hash_ranges(sh: torch.Tensor, cvi: torch.Tensor, p_hash: torch.Tensor,
                      p_ok: torch.Tensor, mode: str):
    """(lo, cnt, unplaced) per probe row over the sorted build hashes: the
    range's start and its live-row count (0 where p_ok is False), through
    hash_probe.probe_for_join (one tidb_probe_count launch on the card),
    and its `unplaced` flag. `mode` is the statement's
    tidb_tpu_join_probe_mode."""
    lo, hi, unplaced = hp.probe_for_join(sh, p_hash, mode=mode, ok=p_ok)
    cnt = torch.where(p_ok, cvi[hi] - cvi[lo], torch.zeros_like(lo))
    return lo, cnt, unplaced
