"""Open-addressing hash probe and the join's per-chunk probe program.

Counterpart of tidb_tpu/ops/hash_probe.py. The join sorts its build side;
a probe needs, per key, the (lo, hi) range of equal sorted build keys.
Searchsorted takes O(log B) dependent gathers per key; the table built
here resolves a key in O(1) expected slot reads:

  * BUILD (`build_table`, plain torch, once per join build): runs of equal
    sorted keys become (lo, hi) ranges; each run's first row inserts
    (fingerprint, lo, hi) into a power-of-two table of ~2x the row count
    by MAX_PROBES rounds of linear probing with scatter-min arbitration
    (the lowest claiming row wins a free slot). The three arrays are bit
    for bit the reference's `_build_table`. `all_placed` is False when
    some run needed more than MAX_PROBES slots; the caller then stays on
    searchsorted.
  * PROBE CHUNK (`probe_chunk`): the program the reference compiles once
    per probe chunk (join_kernels `_probe_count`): the range lookup by
    the direct index, the table or searchsorted, the per-row match count,
    the LEFT pad and the prefix sum. On a CUDA tensor it is one launch of
    the hand-written kernel of csrc/hash_probe.cu (`tidb_probe_count`,
    which replaces B3, the reference's `_probe_pallas`, and the eager
    chain around it); on a CPU tensor its plain version,
    `plain_probe_chunk`, whose table lookup is the reference's 32-round
    window scan (`_probe_xla`).
  * PROBE (`probe_table`, the table lookup alone): the same kernel in its
    lookup-only mode on a CUDA tensor, the window scan on a CPU tensor.
    The join's main path does not call it.
There is no fallback from the card to a plain version: a kernel that
cannot build or launch raises ExecutionError.

`resolve_mode` maps tidb_tpu_join_probe_mode to a route. The port has no
XLA and an eager window scan is 32 rounds of launches, so on the card
'auto', 'xla' and 'pallas' all take the kernel; on the CPU 'auto' keeps
searchsorted, as the reference's CPU run does. Every caller passes its
statement's mode: there is no process-wide default to race on.
`probe_for_join` is the mesh tier's entry (parallel/fragment.py): the
same kernel, one launch per shard, on the table route or the sorted one.
It reads nothing of the host, since it runs inside a mesh fragment's
program: the table route is taken whenever the mode and the build's
size allow it, and whether every run was placed comes back as a device
flag for the fragment's one overflow fetch (a run left unplaced voids
the ranges, and the caller re-runs on the sorted route).

The splitmix64 tail runs in int64: logical right shifts are masked
arithmetic shifts, constants above 2^63 are written as their negative
int64, and products wrap mod 2^64 as torch's int64 multiply does.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from tidb_tpu_torch.errors import ExecutionError
from tidb_tpu_torch.ops.nvcc_build import load_library
from tidb_tpu_torch.utils import dispatch

__all__ = ["MAX_PROBES", "MAX_CAPACITY", "LAUNCHES", "reset_launches",
           "resolve_mode", "table_capacity", "build_table", "probe_table",
           "plain_probe_table", "placed_table", "probe_ranges",
           "sorted_probe_ranges", "probe_chunk", "plain_probe_chunk",
           "ROUTES", "srl", "i64_bits", "load_kernels", "SOURCE",
           "probe_for_join"]

SOURCE = "hash_probe.cu"

MAX_PROBES = 32
# three int32 arrays of this capacity = 6 MiB: dimension-sized build sides
# qualify; bigger builds keep searchsorted (the reference's VMEM envelope,
# kept so both engines route the same joins to the table)
MAX_CAPACITY = 1 << 19

_EMPTY = 0x7FFFFFFF
_FP_SALT = 0x9E3779B97F4A7C15


def i64_bits(x: int) -> int:
    """An unsigned 64-bit constant as the int64 with the same bits."""
    return x - (1 << 64) if x >= (1 << 63) else x


_M1 = i64_bits(0xBF58476D1CE4E5B9)
_M2 = i64_bits(0x94D049BB133111EB)

# launches on CUDA tensors, process-wide (the plain CPU path counts
# nothing): the probe program of a chunk, and the table lookup alone; the
# launching thread's own count is utils/dispatch's
LAUNCHES = {"probe_count": 0, "hash_probe": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's >> is arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix32(h: torch.Tensor, salt: int = 0) -> torch.Tensor:
    """int64 key -> well-spread int32 (splitmix64 tail), as int64 values in
    [-2^31, 2^31); `salt` derives the fingerprint stream. The EMPTY
    sentinel maps to 0 on both the build and the probe side."""
    h = h.to(torch.int64)
    if salt:
        h = h ^ i64_bits(salt)
    h = (h ^ srl(h, 30)) * _M1
    h = (h ^ srl(h, 27)) * _M2
    h = h ^ srl(h, 31)
    low = h & 0xFFFFFFFF
    out = low - ((low >> 31) << 32)  # keep 32 bits, read them as signed
    return torch.where(out == _EMPTY, torch.zeros_like(out), out)


def resolve_mode(mode: str, device: torch.device) -> str:
    """'sorted' or 'table' for tidb_tpu_join_probe_mode on `device`."""
    if mode == "off":
        return "sorted"
    if mode == "auto":
        return "table" if torch.device(device).type == "cuda" else "sorted"
    if mode in ("xla", "pallas"):
        return "table"
    raise ExecutionError(f"unknown join probe mode {mode!r}")


def _next_pow2(n: int) -> int:
    c = 1
    while c < n:
        c *= 2
    return c


def table_capacity(n_build: int) -> Optional[int]:
    """Table capacity for an `n_build`-row build side, or None when the
    table is ineligible (load factor above 1/2 within MAX_CAPACITY, or an
    empty build)."""
    if n_build == 0:
        return None
    cap = min(_next_pow2(max(2 * n_build, 16)), MAX_CAPACITY)
    if cap < 2 * n_build:
        return None
    return cap


def build_table(sh: torch.Tensor, cap: int):
    """(keys32[cap], lo32[cap], hi32[cap], all_placed) over the sorted
    int64 keys `sh`: int32 arrays and a bool scalar tensor, bit-equal to
    the reference's `_build_table`. keys32 holds each run's fingerprint;
    a probe verifies a fingerprint match against sh[lo]."""
    dev = sh.device
    Rb = sh.shape[0]
    i32max = torch.iinfo(torch.int32).max
    idx = torch.arange(Rb, dtype=torch.int64, device=dev)
    is_start = torch.ones(Rb, dtype=torch.bool, device=dev)
    is_start[1:] = sh[1:] != sh[:-1]
    # hi of the run starting at i = index of the next start (suffix min)
    start_pos = torch.where(is_start, idx, Rb)
    tail = torch.cat([start_pos[1:], torch.full((1,), Rb, dtype=torch.int64, device=dev)])
    next_start = torch.cummin(tail.flip(0), 0).values.flip(0)
    mask = cap - 1
    home = _mix32(sh) & mask
    fp = _mix32(sh, _FP_SALT)
    # one parking slot at index cap: losers write there, never into a
    # live slot; it is cut off at the end
    keys = torch.full((cap + 1,), _EMPTY, dtype=torch.int64, device=dev)
    los = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    his = torch.zeros(cap + 1, dtype=torch.int64, device=dev)
    placed = ~is_start  # non-starts have nothing to insert
    park_all = torch.full_like(idx, cap)
    no_claim = torch.full_like(idx, i32max)
    for r in range(MAX_PROBES):
        pos = (home + r) & mask
        want = ~placed
        # scatter-min arbitration: the lowest claiming row wins the slot
        claim = torch.full((cap + 1,), i32max, dtype=torch.int64, device=dev)
        claim.scatter_reduce_(0, torch.where(want, pos, park_all),
                              torch.where(want, idx, no_claim), "amin")
        free = keys[pos] == _EMPTY
        won = want & free & (claim[pos] == idx)
        park = torch.where(won, pos, park_all)
        keys[park] = torch.where(won, fp, _EMPTY)
        los[park] = torch.where(won, idx, 0)
        his[park] = torch.where(won, next_start, 0)
        placed = placed | won
    return (keys[:cap].to(torch.int32), los[:cap].to(torch.int32),
            his[:cap].to(torch.int32), placed.all())


# ---------------------------------------------------------------------------
# plain versions: the window scan, searchsorted and the chunk's program
# ---------------------------------------------------------------------------


def plain_probe_table(tkeys, tlos, this, sorted_keys, probes):
    """The reference's window scan (`_probe_xla`): MAX_PROBES rounds over
    every probe; the CPU path and the plain version the kernel is held to."""
    cap = tkeys.shape[0]
    mask = cap - 1
    probes = probes.to(torch.int64)
    home = _mix32(probes) & mask
    fp = _mix32(probes, _FP_SALT)
    tkeys, tlos, this = tkeys.long(), tlos.long(), this.long()
    nb = sorted_keys.shape[0]
    lo = torch.zeros_like(probes)
    hi = torch.zeros_like(probes)
    found = torch.zeros(probes.shape, dtype=torch.bool, device=probes.device)
    for r in range(MAX_PROBES):
        pos = (home + r) & mask
        cand = tlos[pos]
        # a fingerprint match is only a candidate: verify the full key
        hit = (~found & (tkeys[pos] == fp)
               & (sorted_keys[cand.clamp(0, nb - 1)] == probes))
        lo = torch.where(hit, cand, lo)
        hi = torch.where(hit, this[pos], hi)
        found = found | hit
    zero = torch.zeros_like(lo)
    return torch.where(found, lo, zero), torch.where(found, hi, zero)


def sorted_probe_ranges(sorted_keys: torch.Tensor, probes: torch.Tensor):
    """(lo, hi) = searchsorted left/right: the route without a table."""
    probes = probes.to(torch.int64)
    return (torch.searchsorted(sorted_keys, probes),
            torch.searchsorted(sorted_keys, probes, right=True))


def plain_probe_chunk(packed, kvalid, in_range, sel, n_build, sorted_keys, *,
                      route: str, firsts=None, lo_packed: int = 0, rng_packed: int = 0,
                      table=None, left_pad: bool = False, flags_only: bool = False,
                      lookup=plain_probe_table):
    """The plain version of tidb_probe_count, the eager composition the
    reference's `_probe_count` spells out: the CPU path, and the version
    the kernel is held to. See probe_chunk; `lookup` is the table route's
    (lo, hi) lookup."""
    ok = kvalid & sel
    if route == "direct":
        idx = packed - lo_packed
        rin = (idx >= 0) & (idx < rng_packed)
        idxc = idx.clamp(0, firsts.shape[0] - 2)
        start, end = firsts[idxc], firsts[idxc + 1]
        in_range = rin if in_range is None else in_range & rin
    else:
        if route == "table":
            start, end = lookup(*table, sorted_keys, packed)
        else:
            start, end = sorted_probe_ranges(sorted_keys, packed)
        # the sentinel tail past n_build never matches
        start, end = torch.minimum(start, n_build), torch.minimum(end, n_build)
    live = ok if in_range is None else ok & in_range
    count = torch.where(live, end - start, torch.zeros_like(start))
    matched = count > 0
    if flags_only:
        return None, None, None, None, None, ok, matched
    real_count = count
    if left_pad:
        # unfiltered LEFT JOIN: every live probe row emits >= 1 slot; the
        # slot beyond real_count carries NULL build payload
        count = torch.where(sel, count.clamp(min=1), torch.zeros_like(count))
    cum = torch.cumsum(count, 0)
    return start, count, real_count, cum, cum[-1], ok, matched


# ---------------------------------------------------------------------------
# the kernel: tidb_probe_count (a chunk), tidb_hash_probe (a lookup)
# ---------------------------------------------------------------------------

ROUTES = ("direct", "table", "sorted")
_MODE_FULL, _MODE_FLAGS = 0, 1
_TILE = 512  # rows per block of tidb_probe_count


class _ProbeParams(ctypes.Structure):
    """tidb_probe_count's ProbeParams (csrc/hash_probe.cu), field for field."""
    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "packed", "kvalid", "in_range", "sel", "n_build", "sorted_keys", "firsts",
        "tkeys", "tlos", "this")]
        + [(n, ctypes.c_longlong) for n in (
            "R", "n_sorted", "n_firsts", "lo_packed", "rng_packed")]
        + [(n, ctypes.c_int) for n in ("cap", "route", "mode", "left_pad")]
        + [(n, ctypes.c_void_p) for n in (
            "start", "end", "count", "real_count", "cum", "total", "ok", "matched",
            "ticket", "status")])


# per card, the chained scan's int64 scratch: the tile ticket (with the
# launch epoch above its 24 low bits), a word of padding, then per tile a
# 16-byte status word (tag, value). Zeros read as "not ready" at every
# epoch, so it is zeroed once, when it is made or grown.
_SCANS = {}


def _scan_scratch(device: torch.device, tiles: int):
    """(ticket, status) device addresses for `tiles` tiles. A CUDA graph
    being captured keeps the scratch it reads alive; the scratch cannot
    grow inside a capture (the call before it, eager, grew it)."""
    buf = _SCANS.get(device)
    if buf is None or buf.shape[0] < 2 + 2 * tiles:
        if dispatch.capturing():
            raise ExecutionError("tidb_probe_count: the scan scratch must grow before a "
                                 "CUDA graph capture, in an eager call of the same shape")
        buf = _SCANS[device] = torch.zeros(2 + 2 * max(tiles, 1024), dtype=torch.int64,
                                           device=device)
    dispatch.retain(buf)
    base = buf.data_ptr()  # the allocator aligns it to 16 bytes and more
    return base, base + 16


def load_kernels() -> ctypes.CDLL:
    """Build (once per source version, ops/nvcc_build.py) and load the probe
    kernel's library."""
    return load_library(SOURCE, {
        "tidb_probe_count": [ctypes.c_void_p, ctypes.c_void_p],
        "tidb_hash_probe": [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]})


def _operand(fn: str, t: torch.Tensor, dev: torch.device, dtype, n=None) -> torch.Tensor:
    """A contiguous vector of `dtype` (and `n` rows) on the card `dev`."""
    if not t.is_cuda or t.device != dev:
        raise ExecutionError(f"{fn}: every operand must be on the probe's card ({dev}), "
                             f"got {t.device}")
    t = t.to(dtype).contiguous()
    if t.dim() != 1 or t.shape[0] == 0 or (n is not None and t.shape[0] != n):
        raise ExecutionError(f"{fn}: expected a non-empty vector"
                             f"{'' if n is None else f' of {n} rows'}, got {tuple(t.shape)}")
    return t


def _table_operands(fn: str, table, dev: torch.device):
    """The table's three int32 arrays, checked, and its capacity."""
    tkeys, tlos, this = table
    cap = tkeys.shape[0]
    if cap <= 0 or cap & (cap - 1) or cap > MAX_CAPACITY:
        raise ExecutionError(f"{fn}: capacity {cap} is not a power of two <= 2^19")
    if not (tlos.shape == tkeys.shape and this.shape == tkeys.shape):
        raise ExecutionError(f"{fn}: table arrays differ in shape")
    if any(t.dtype != torch.int32 for t in table):
        raise ExecutionError(f"{fn}: table arrays must be int32")
    return tuple(_operand(fn, t, dev, torch.int32, cap) for t in table) + (cap,)


def probe_table(tkeys: torch.Tensor, tlos: torch.Tensor, this: torch.Tensor,
                sorted_keys: torch.Tensor,
                probes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) int64 per probe key through the table: tidb_probe_count's
    lookup alone on a CUDA tensor (or an error), the plain window scan on
    a CPU tensor."""
    if not probes.is_cuda:
        return plain_probe_table(tkeys, tlos, this, sorted_keys, probes)
    fn = "hash_probe"
    dev = probes.device
    tkeys, tlos, this, cap = _table_operands(fn, (tkeys, tlos, this), dev)
    sorted_keys = _operand(fn, sorted_keys, dev, torch.int64)
    if probes.dim() != 1:
        raise ExecutionError(f"{fn}: probes must be a vector")
    probes = probes.to(torch.int64).contiguous()
    n = probes.shape[0]
    lo = torch.empty(n, dtype=torch.int64, device=dev)
    hi = torch.empty(n, dtype=torch.int64, device=dev)
    lib = load_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.tidb_hash_probe(probes.data_ptr(), n, tkeys.data_ptr(),
                                  tlos.data_ptr(), this.data_ptr(), cap,
                                  sorted_keys.data_ptr(), sorted_keys.shape[0],
                                  lo.data_ptr(), hi.data_ptr(), stream)
    if err != 0:
        raise ExecutionError(f"hash_probe: CUDA launch failed with error {err}")
    dispatch.count_launch(LAUNCHES, "hash_probe")
    return lo, hi


def probe_chunk(packed: torch.Tensor, kvalid: torch.Tensor, in_range: Optional[torch.Tensor],
                sel: torch.Tensor, n_build: torch.Tensor, sorted_keys: torch.Tensor, *,
                route: str, firsts: Optional[torch.Tensor] = None, lo_packed: int = 0,
                rng_packed: int = 0, table=None, left_pad: bool = False,
                flags_only: bool = False):
    """Probe one chunk of packed int64 keys [R]: (start, count, real_count,
    cum, total, ok, matched), the outputs of the reference's `_probe_count`.
    `kvalid`, `sel` and `in_range` (None: every key in range) are bool
    [R]; `route` is 'direct' (over `firsts`, `lo_packed`, `rng_packed`),
    'table' (over `table` and `sorted_keys`) or 'sorted' (searchsorted
    over `sorted_keys`); the table and sorted routes clamp ranges to the
    0-d `n_build`. With `flags_only` only ok and matched are computed and
    the other five are None. One tidb_probe_count launch on a CUDA tensor
    (or an error), plain_probe_chunk on a CPU tensor."""
    if not packed.is_cuda:
        return plain_probe_chunk(packed, kvalid, in_range, sel, n_build, sorted_keys,
                                 route=route, firsts=firsts, lo_packed=lo_packed,
                                 rng_packed=rng_packed, table=table, left_pad=left_pad,
                                 flags_only=flags_only)
    fn = "probe_chunk"
    if route not in ROUTES:
        raise ExecutionError(f"{fn}: unknown route {route!r}")
    dev = packed.device
    packed = _operand(fn, packed, dev, torch.int64)
    R = packed.shape[0]
    keep = [packed, _operand(fn, kvalid, dev, torch.bool, R), _operand(fn, sel, dev, torch.bool, R)]
    p = _ProbeParams(packed=packed.data_ptr(), kvalid=keep[1].data_ptr(),
                     sel=keep[2].data_ptr(), R=R, route=ROUTES.index(route),
                     mode=_MODE_FLAGS if flags_only else _MODE_FULL, left_pad=int(left_pad))
    if in_range is not None:
        keep.append(_operand(fn, in_range, dev, torch.bool, R))
        p.in_range = keep[-1].data_ptr()
    if route == "direct":
        keep.append(_operand(fn, firsts, dev, torch.int64))
        if keep[-1].shape[0] < 2:
            raise ExecutionError(f"{fn}: the direct index needs at least 2 entries")
        p.firsts, p.n_firsts = keep[-1].data_ptr(), keep[-1].shape[0]
        p.lo_packed, p.rng_packed = lo_packed, rng_packed
    else:
        keep.append(_operand(fn, n_build.reshape(1), dev, torch.int64, 1))
        keep.append(_operand(fn, sorted_keys, dev, torch.int64))
        p.n_build = keep[-2].data_ptr()
        p.sorted_keys, p.n_sorted = keep[-1].data_ptr(), keep[-1].shape[0]
        if route == "table":
            tkeys, tlos, this, p.cap = _table_operands(fn, table, dev)
            keep += [tkeys, tlos, this]
            p.tkeys, p.tlos, p.this = tkeys.data_ptr(), tlos.data_ptr(), this.data_ptr()
    flags = torch.empty(2 * R, dtype=torch.bool, device=dev)
    ok, matched = flags[:R], flags[R:]
    p.ok, p.matched = ok.data_ptr(), matched.data_ptr()
    outs = (None,) * 5
    if not flags_only:
        i64 = torch.empty(4 * R + 1, dtype=torch.int64, device=dev)
        outs = tuple(i64[i * R:(i + 1) * R] for i in range(4)) + (i64[4 * R],)
        p.start, p.count, p.real_count, p.cum, p.total = (t.data_ptr() for t in outs)
        p.ticket, p.status = _scan_scratch(dev, -(-R // _TILE))
    lib = load_kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = lib.tidb_probe_count(ctypes.addressof(p), stream)
    if err != 0:
        raise ExecutionError(f"tidb_probe_count: CUDA launch failed with error {err}")
    dispatch.count_launch(LAUNCHES, "probe_count")
    return outs + (ok, matched)


def placed_table(sorted_keys: torch.Tensor):
    """(keys32, lo32, hi32) over the sorted keys, or None when the build is
    above the capacity envelope or some run was not placed within
    MAX_PROBES slots; the caller then takes searchsorted. The reference
    makes this choice per probe inside its program (lax.cond); here it is
    one host read per build."""
    cap = table_capacity(sorted_keys.shape[0])
    if cap is None:
        return None
    tkeys, tlos, this, all_placed = build_table(sorted_keys, cap)
    return (tkeys, tlos, this) if bool(dispatch.device_get(all_placed)) else None


def probe_ranges(sorted_keys: torch.Tensor, probes: torch.Tensor):
    """(lo, hi) per probe over the sorted keys: through the table when it
    is eligible and every run was placed, else searchsorted. Equal to
    searchsorted wherever the join reads the ranges (hi - lo, and lo on a
    hit)."""
    table = placed_table(sorted_keys)
    if table is None:
        return sorted_probe_ranges(sorted_keys, probes)
    return probe_table(*table, sorted_keys, probes)


def probe_for_join(sorted_hashes: torch.Tensor, probes: torch.Tensor,
                   mode: str, ok: Optional[torch.Tensor] = None):
    """(lo, hi, unplaced): lo and hi int64 per probe over the sorted build
    hashes (searchsorted left/right wherever a join reads them: hi - lo,
    and lo on a hit), through probe_chunk: one tidb_probe_count launch on
    a CUDA tensor, on the table route when `mode` takes the table on this
    device and the build's size allows it, else on the sorted route. Rows
    where `ok` is False get hi == lo. Nothing is read on the host:
    `unplaced` is an int64 0-d tensor, 1 when the table left a run
    unplaced (lo and hi are then void, and the caller re-runs on the
    sorted route), or None on the sorted route. The counterpart of the
    reference's `probe_for_join`, which makes that choice inside its
    program; `mode` is the statement's probe mode."""
    route, table, unplaced = "sorted", None, None
    if resolve_mode(mode, sorted_hashes.device) == "table":
        cap = table_capacity(sorted_hashes.shape[0])
        if cap is not None:
            tkeys, tlos, this, all_placed = build_table(sorted_hashes, cap)
            table, unplaced = (tkeys, tlos, this), (~all_placed).to(torch.int64)
            route = "table"
    n = probes.shape[0]
    dev = probes.device
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    # a fill, not a copy from the host (a fragment's program may be captured)
    n_build = torch.full((), sorted_hashes.shape[0], dtype=torch.int64, device=dev)
    start, count = probe_chunk(probes.to(torch.int64), ones, None,
                               ones if ok is None else ok, n_build, sorted_hashes,
                               route=route, table=table)[:2]
    return start, start + count, unplaced
