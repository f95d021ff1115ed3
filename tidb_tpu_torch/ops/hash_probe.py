"""Open-addressing hash probe for the device join.

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
  * PROBE (`probe_table`): on a CUDA tensor the hand-written kernel of
    csrc/hash_probe.cu (B3, the reference's `_probe_pallas`), one thread
    per key, stopping at the first hit or EMPTY slot; on a CPU tensor its
    plain version, the reference's 32-round window scan (`_probe_xla`).
    There is no fallback from the card to the plain version.

`resolve_mode` maps tidb_tpu_join_probe_mode to a route. The port has no
XLA and an eager window scan is 32 rounds of launches, so on the card
'auto', 'xla' and 'pallas' all take the kernel; on the CPU 'auto' keeps
searchsorted, as the reference's CPU run does.

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

__all__ = ["MAX_PROBES", "MAX_CAPACITY", "LAUNCHES", "reset_launches",
           "resolve_mode", "table_capacity", "build_table", "probe_table",
           "plain_probe_table", "placed_table", "probe_ranges",
           "sorted_probe_ranges", "srl", "i64_bits",
           "load_kernels", "SOURCE"]

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

# launches on CUDA tensors (the plain CPU path counts nothing)
LAUNCHES = {"hash_probe": 0}


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
# the probe: the plain window scan and the kernel
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


def load_kernels() -> ctypes.CDLL:
    """Build (once per source version, ops/nvcc_build.py) and load B3."""
    return load_library(SOURCE, {"tidb_hash_probe": [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]})


def probe_table(tkeys: torch.Tensor, tlos: torch.Tensor, this: torch.Tensor,
                sorted_keys: torch.Tensor,
                probes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) int64 per probe key through the table: the B3 kernel on a
    CUDA tensor (or an error), the plain window scan on a CPU tensor."""
    if not probes.is_cuda:
        return plain_probe_table(tkeys, tlos, this, sorted_keys, probes)
    ops = (tkeys, tlos, this, sorted_keys)
    if not all(t.is_cuda and t.device == probes.device for t in ops):
        raise ExecutionError("hash_probe: every operand must be on the probe's card")
    cap = tkeys.shape[0]
    if cap <= 0 or cap & (cap - 1) or cap > MAX_CAPACITY:
        raise ExecutionError(f"hash_probe: capacity {cap} is not a power of two <= 2^19")
    if not (tlos.shape == tkeys.shape and this.shape == tkeys.shape):
        raise ExecutionError("hash_probe: table arrays differ in shape")
    if any(t.dtype != torch.int32 for t in (tkeys, tlos, this)):
        raise ExecutionError("hash_probe: table arrays must be int32")
    if sorted_keys.dim() != 1 or sorted_keys.shape[0] == 0:
        raise ExecutionError("hash_probe: sorted keys must be a non-empty vector")
    if probes.dim() != 1:
        raise ExecutionError("hash_probe: probes must be a vector")
    probes = probes.to(torch.int64).contiguous()
    sorted_keys = sorted_keys.to(torch.int64).contiguous()
    tkeys, tlos, this = tkeys.contiguous(), tlos.contiguous(), this.contiguous()
    n = probes.shape[0]
    lo = torch.empty(n, dtype=torch.int64, device=probes.device)
    hi = torch.empty(n, dtype=torch.int64, device=probes.device)
    lib = load_kernels()
    stream = torch.cuda.current_stream(probes.device).cuda_stream
    with torch.cuda.device(probes.device):
        err = lib.tidb_hash_probe(probes.data_ptr(), n, tkeys.data_ptr(),
                                  tlos.data_ptr(), this.data_ptr(), cap,
                                  sorted_keys.data_ptr(), sorted_keys.shape[0],
                                  lo.data_ptr(), hi.data_ptr(), stream)
    if err != 0:
        raise ExecutionError(f"hash_probe: CUDA launch failed with error {err}")
    LAUNCHES["hash_probe"] += 1
    return lo, hi


def sorted_probe_ranges(sorted_keys: torch.Tensor, probes: torch.Tensor):
    """(lo, hi) = searchsorted left/right: the route without a table."""
    probes = probes.to(torch.int64)
    return (torch.searchsorted(sorted_keys, probes),
            torch.searchsorted(sorted_keys, probes, right=True))


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
    return (tkeys, tlos, this) if bool(all_placed) else None


def probe_ranges(sorted_keys: torch.Tensor, probes: torch.Tensor):
    """(lo, hi) per probe over the sorted keys: through the table when it
    is eligible and every run was placed, else searchsorted. Equal to
    searchsorted wherever the join reads the ranges (hi - lo, and lo on a
    hit)."""
    table = placed_table(sorted_keys)
    if table is None:
        return sorted_probe_ranges(sorted_keys, probes)
    return probe_table(*table, sorted_keys, probes)
