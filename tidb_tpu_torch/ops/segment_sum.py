"""Segment aggregation: hand-written CUDA kernels and their plain versions.

Counterpart of tidb_tpu/ops/segment_sum.py. The TPU kernels there are
tiled one-hot contractions (Pallas): `_pallas_segsum_f32` (B1, which
`segment_count` drives with the mask as values) and the byte-limb
`_pallas_segsum_i64` (B2). Here both are one CUDA C++ kernel for Hopper,
`tidb_segagg` in csrc/segment_sum.cu, built with nvcc for sm_90a on first
use and bound through ctypes (a plain C ABI). It does a chunk's whole
segment-aggregation update in one launch: `segment_accumulate` takes up to
32 accumulators (counts, int64 sums, two-limb sums) over one set of ids and
adds into the caller's [G] state in place. `segment_count` and
`segment_sum_i64` are the same kernel with one accumulator.

Every wrapper takes its plain PyTorch version (`index_add_` over the ids
in [0, G)) only for a tensor on the CPU. For a CUDA tensor it launches the
kernel, or raises: there is no fallback to the plain version or to a
library scatter. Each wrapper counts its launches in `LAUNCHES`.

Semantics shared by the kernels and the plain versions:
  * ids outside [0, G) contribute nothing (the Pallas kernels' rule;
    tidb_tpu's XLA fallback would wrap negative ids instead);
  * counts are exact at any row count and int64;
  * int64 sums are exact and wrap mod 2^64, bit for bit;
  * segment_sum_f32 accumulates in float32; the kernel's atomics add in
    an order that changes from run to run.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional

import torch

from tidb_tpu_torch.errors import ExecutionError
from tidb_tpu_torch.ops.nvcc_build import load_library

__all__ = ["SegAcc", "segment_accumulate", "plain_segment_accumulate",
           "segment_count", "segment_sum_f32", "segment_sum_i64",
           "plain_segment_count", "plain_segment_sum_f32",
           "plain_segment_sum_i64", "LAUNCHES", "reset_launches",
           "load_kernels", "SOURCE", "MAX_ACCS"]

SOURCE = "segment_sum.cu"
MAX_ACCS = 32  # accumulators per tidb_segagg launch

# launches per wrapper on CUDA tensors (the plain CPU path counts nothing)
LAUNCHES = {"segagg": 0, "segsum_count": 0, "segsum_f32": 0, "segsum_i64": 0}

_KINDS = {"count": 0, "sum": 1, "limbs": 2}
_LO_MASK = (1 << 32) - 1


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclass
class SegAcc:
    """One accumulator of a segment update, over the rows where the chunk's
    sel and `mask` (None: every row) hold and the id lies in [0, G):
      count: out[g] += number of such rows with id g;
      sum:   out[g] += vals over them, mod 2^64;
      limbs: the sum split as split_limbs does, lo = v & (2^32 - 1) into
             out and hi = v >> 32 (arithmetic) into out_hi, then the pair
             normalized as normalize_limbs does (lo's overflow carried
             into hi, lo left in [0, 2^32)).
    Every out is an int64 [G] tensor, updated in place."""

    kind: str
    out: torch.Tensor
    vals: Optional[torch.Tensor] = None
    mask: Optional[torch.Tensor] = None
    out_hi: Optional[torch.Tensor] = None


class _AccIn(ctypes.Structure):
    _fields_ = [("out", ctypes.c_void_p), ("out_hi", ctypes.c_void_p),
                ("vals", ctypes.c_void_p), ("mask", ctypes.c_void_p),
                ("kind", ctypes.c_int), ("pad", ctypes.c_int)]


_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p]
_SEGAGG_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]

# one uint32 per card: tidb_segagg's count of finished blocks, which its
# last block wraps back to 0 (the launches of a card run on one stream)
_TICKETS = {}


def _ticket(device: torch.device) -> torch.Tensor:
    t = _TICKETS.get(device)
    if t is None:
        t = _TICKETS[device] = torch.zeros(1, dtype=torch.int32, device=device)
    return t


def load_kernels() -> ctypes.CDLL:
    """Build (once per source version, ops/nvcc_build.py) and load the
    kernel library."""
    sigs = {fn: _ARGS for fn in ("tidb_segsum_count", "tidb_segsum_f32",
                                 "tidb_segsum_i64")}
    sigs["tidb_segagg"] = _SEGAGG_ARGS
    return load_library(SOURCE, sigs)


def _check_ids(fn_name: str, seg: torch.Tensor, G: int) -> None:
    if not seg.is_cuda:
        raise ExecutionError(f"{fn_name}: every operand must be on the card")
    if seg.dim() != 1 or seg.dtype != torch.int64 or not seg.is_contiguous():
        raise ExecutionError(f"{fn_name}: seg must be contiguous int64 [R], got "
                             f"{seg.dtype} {tuple(seg.shape)}")
    if not 0 < G < (1 << 31):
        raise ExecutionError(f"{fn_name}: G={G} outside [1, 2^31)")


def _check_operand(fn_name: str, t: torch.Tensor, seg: torch.Tensor, shape,
                   dtype) -> None:
    if not t.is_cuda or t.device != seg.device:
        raise ExecutionError(f"{fn_name}: every operand must be on the card "
                             f"beside seg ({seg.device}), got {t.device}")
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or not t.is_contiguous():
        raise ExecutionError(f"{fn_name}: expected contiguous {dtype} {tuple(shape)}, "
                             f"got {t.dtype} {tuple(t.shape)}")


def _launch(fn_name: str, counter: str, vals: torch.Tensor, seg: torch.Tensor,
            G: int, out: torch.Tensor) -> torch.Tensor:
    """Check operands and launch one single-column kernel on the current
    stream."""
    _check_ids(fn_name, seg, G)
    _check_operand(fn_name, vals, seg, seg.shape, vals.dtype)
    _check_operand(fn_name, out, seg, (G,), out.dtype)
    lib = load_kernels()
    stream = torch.cuda.current_stream(seg.device).cuda_stream
    with torch.cuda.device(seg.device):
        err = getattr(lib, fn_name)(vals.data_ptr(), seg.data_ptr(),
                                    seg.shape[0], G, out.data_ptr(), stream)
    if err != 0:
        raise ExecutionError(f"{fn_name}: CUDA launch failed with error {err}")
    LAUNCHES[counter] += 1
    return out


# ---------------------------------------------------------------------------
# plain versions (CPU path, and the reference the kernels are held to)
# ---------------------------------------------------------------------------


def _in_range(seg: torch.Tensor, G: int) -> torch.Tensor:
    return (seg >= 0) & (seg < G)


def plain_segment_count(mask: torch.Tensor, seg: torch.Tensor, G: int) -> torch.Tensor:
    seg = seg.to(torch.int64)
    keep = _in_range(seg, G) & mask.to(torch.bool)
    out = torch.zeros(G, dtype=torch.int64, device=seg.device)
    return out.index_add_(0, seg[keep], torch.ones_like(seg[keep]))


def plain_segment_sum_f32(vals: torch.Tensor, seg: torch.Tensor, G: int) -> torch.Tensor:
    seg = seg.to(torch.int64)
    keep = _in_range(seg, G)
    out = torch.zeros(G, dtype=torch.float32, device=seg.device)
    return out.index_add_(0, seg[keep], vals.to(torch.float32)[keep])


def plain_segment_sum_i64(vals: torch.Tensor, seg: torch.Tensor, G: int) -> torch.Tensor:
    seg = seg.to(torch.int64)
    keep = _in_range(seg, G)
    out = torch.zeros(G, dtype=torch.int64, device=seg.device)
    return out.index_add_(0, seg[keep], vals.to(torch.int64)[keep])


def plain_segment_accumulate(seg: torch.Tensor, G: int, sel: Optional[torch.Tensor],
                             accs: List[SegAcc]) -> None:
    """The plain version of tidb_segagg, built on the single-column plain
    functions: each accumulator's rows masked, split into limbs where
    asked, summed per group and added into its outputs in place."""
    seg = seg.to(torch.int64)
    live = None if sel is None else sel.to(torch.bool)
    for a in accs:
        m = live
        if a.mask is not None:
            mb = a.mask.to(torch.bool)
            m = mb if m is None else m & mb
        if a.kind == "count":
            a.out += plain_segment_count(
                torch.ones_like(seg, dtype=torch.bool) if m is None else m, seg, G)
            continue
        v = torch.broadcast_to(a.vals, seg.shape).to(torch.int64)
        if m is not None:
            v = torch.where(m, v, 0)
        if a.kind == "sum":
            a.out += plain_segment_sum_i64(v, seg, G)
        elif a.kind == "limbs":
            a.out += plain_segment_sum_i64(v & _LO_MASK, seg, G)
            a.out_hi += plain_segment_sum_i64(v >> 32, seg, G)
            a.out_hi += a.out >> 32
            a.out &= _LO_MASK
        else:
            raise ExecutionError(f"segment_accumulate: unknown kind {a.kind!r}")


# ---------------------------------------------------------------------------
# wrappers: the plain version on CPU tensors, the kernel on CUDA tensors
# ---------------------------------------------------------------------------


def segment_accumulate(seg: torch.Tensor, G: int, sel: Optional[torch.Tensor],
                       accs: List[SegAcc]) -> None:
    """A chunk's segment-aggregation update: every accumulator of `accs`
    (see SegAcc) over the ids `seg` [R] and the live rows `sel` [R] (None:
    every row), added into its [G] outputs in place. On the card one
    tidb_segagg launch per 32 accumulators."""
    if not seg.is_cuda:
        plain_segment_accumulate(seg, G, sel, accs)
        return
    fn = "segment_accumulate"
    _check_ids(fn, seg, G)
    R = seg.shape[0]
    keep = []  # converted operands stay alive until the launch is queued
    if sel is not None:
        sel = sel.to(torch.bool).contiguous()
        _check_operand(fn, sel, seg, (R,), torch.bool)
        keep.append(sel)
    descs = []
    for a in accs:
        if a.kind not in _KINDS:
            raise ExecutionError(f"{fn}: unknown kind {a.kind!r}")
        outs = [a.out] + ([a.out_hi] if a.kind == "limbs" else [])
        for o in outs:
            if o is None:
                raise ExecutionError(f"{fn}: a {a.kind} accumulator lacks an output")
            _check_operand(fn, o, seg, (G,), torch.int64)
        vals = mask = None
        if a.kind != "count":
            if a.vals is None:
                raise ExecutionError(f"{fn}: a {a.kind} accumulator lacks values")
            vals = torch.broadcast_to(a.vals, (R,)).to(torch.int64).contiguous()
            _check_operand(fn, vals, seg, (R,), torch.int64)
            keep.append(vals)
        if a.mask is not None:
            mask = torch.broadcast_to(a.mask, (R,)).to(torch.bool).contiguous()
            _check_operand(fn, mask, seg, (R,), torch.bool)
            keep.append(mask)
        descs.append(_AccIn(a.out.data_ptr(),
                            a.out_hi.data_ptr() if a.kind == "limbs" else None,
                            None if vals is None else vals.data_ptr(),
                            None if mask is None else mask.data_ptr(),
                            _KINDS[a.kind], 0))
    if R == 0 or not descs:
        return
    lib = load_kernels()
    stream = torch.cuda.current_stream(seg.device).cuda_stream
    sel_ptr = None if sel is None else sel.data_ptr()
    ticket = _ticket(seg.device).data_ptr()
    for i in range(0, len(descs), MAX_ACCS):
        part = descs[i:i + MAX_ACCS]
        arr = (_AccIn * len(part))(*part)
        with torch.cuda.device(seg.device):
            err = lib.tidb_segagg(seg.data_ptr(), sel_ptr, R, G, arr, len(part), ticket,
                                  stream)
        if err != 0:
            raise ExecutionError(f"tidb_segagg: CUDA launch failed with error {err}")
        LAUNCHES["segagg"] += 1


def segment_count(mask: torch.Tensor, seg: torch.Tensor, G: int) -> torch.Tensor:
    """Count mask-true rows per segment, exact, int64 [G]: tidb_segagg
    with one count accumulator."""
    if not mask.is_cuda:
        return plain_segment_count(mask, seg, G)
    out = torch.zeros(G, dtype=torch.int64, device=mask.device)
    return _launch("tidb_segsum_count", "segsum_count",
                   mask.to(torch.bool).contiguous(),
                   seg.to(torch.int64).contiguous(), G, out)


def segment_sum_f32(vals: torch.Tensor, seg: torch.Tensor, G: int) -> torch.Tensor:
    """Float32 segment sum, [G]."""
    if not vals.is_cuda:
        return plain_segment_sum_f32(vals, seg, G)
    out = torch.zeros(G, dtype=torch.float32, device=vals.device)
    return _launch("tidb_segsum_f32", "segsum_f32",
                   vals.to(torch.float32).contiguous(),
                   seg.to(torch.int64).contiguous(), G, out)


def segment_sum_i64(vals: torch.Tensor, seg: torch.Tensor, G: int) -> torch.Tensor:
    """Exact int64/decimal segment sum, wrapping mod 2^64, [G]: tidb_segagg
    with one sum accumulator."""
    if not vals.is_cuda:
        return plain_segment_sum_i64(vals, seg, G)
    out = torch.zeros(G, dtype=torch.int64, device=vals.device)
    return _launch("tidb_segsum_i64", "segsum_i64",
                   vals.to(torch.int64).contiguous(),
                   seg.to(torch.int64).contiguous(), G, out)
