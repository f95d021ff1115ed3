"""Segment aggregation: hand-written CUDA kernels and their plain versions.

Counterpart of tidb_tpu/ops/segment_sum.py. The TPU kernels there are
tiled one-hot contractions (Pallas): `_pallas_segsum_f32` (B1, which
`segment_count` drives with the mask as values) and the byte-limb
`_pallas_segsum_i64` (B2). Here each is a CUDA C++ kernel for Hopper in
csrc/segment_sum.cu — per-block private histograms in shared memory,
flushed with one global atomic per group per block — built with nvcc for
sm_90a on first use and bound through ctypes (a plain C ABI).

Every wrapper takes its plain PyTorch version (`index_add_` over the ids
in [0, G)) only for a tensor on the CPU. For a CUDA tensor it launches the
kernel, or raises: there is no fallback to the plain version or to a
library scatter. Each wrapper counts its launches in `LAUNCHES`.

Semantics shared by the kernels and the plain versions:
  * ids outside [0, G) contribute nothing (the Pallas kernels' rule;
    tidb_tpu's XLA fallback would wrap negative ids instead);
  * segment_count is exact at any row count and returns int64;
  * segment_sum_i64 is exact and wraps mod 2^64, bit for bit;
  * segment_sum_f32 accumulates in float32; the kernel's atomics add in
    an order that changes from run to run.
"""

from __future__ import annotations

import ctypes

import torch

from tidb_tpu_torch.errors import ExecutionError
from tidb_tpu_torch.ops.nvcc_build import load_library

__all__ = ["segment_count", "segment_sum_f32", "segment_sum_i64",
           "plain_segment_count", "plain_segment_sum_f32",
           "plain_segment_sum_i64", "LAUNCHES", "reset_launches",
           "load_kernels", "SOURCE"]

SOURCE = "segment_sum.cu"

# launches per wrapper on CUDA tensors (the plain CPU path counts nothing)
LAUNCHES = {"segsum_count": 0, "segsum_f32": 0, "segsum_i64": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_void_p, ctypes.c_void_p]


def load_kernels() -> ctypes.CDLL:
    """Build (once per source version, ops/nvcc_build.py) and load the
    kernel library."""
    return load_library(SOURCE, {fn: _ARGS for fn in (
        "tidb_segsum_count", "tidb_segsum_f32", "tidb_segsum_i64")})


def _launch(fn_name: str, counter: str, vals: torch.Tensor, seg: torch.Tensor,
            G: int, out: torch.Tensor) -> torch.Tensor:
    """Check operands and launch one kernel on the current stream."""
    if not (vals.is_cuda and seg.is_cuda and out.is_cuda):
        raise ExecutionError(f"{fn_name}: every operand must be on the card")
    if vals.device != seg.device or vals.device != out.device:
        raise ExecutionError(f"{fn_name}: operands on different devices")
    if vals.dim() != 1 or seg.shape != vals.shape:
        raise ExecutionError(f"{fn_name}: vals and seg must be [R] alike, got "
                             f"{tuple(vals.shape)} and {tuple(seg.shape)}")
    if seg.dtype != torch.int64:
        raise ExecutionError(f"{fn_name}: seg must be int64, got {seg.dtype}")
    if not (vals.is_contiguous() and seg.is_contiguous() and out.is_contiguous()):
        raise ExecutionError(f"{fn_name}: operands must be contiguous")
    if not 0 < G < (1 << 31):
        raise ExecutionError(f"{fn_name}: G={G} outside [1, 2^31)")
    lib = load_kernels()
    stream = torch.cuda.current_stream(vals.device).cuda_stream
    with torch.cuda.device(vals.device):
        err = getattr(lib, fn_name)(vals.data_ptr(), seg.data_ptr(),
                                    vals.shape[0], G, out.data_ptr(), stream)
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


# ---------------------------------------------------------------------------
# wrappers: the plain version on CPU tensors, the kernel on CUDA tensors
# ---------------------------------------------------------------------------


def segment_count(mask: torch.Tensor, seg: torch.Tensor, G: int) -> torch.Tensor:
    """Count mask-true rows per segment, exact, int64 [G]. The hottest
    accumulator shape of segment aggregation: occ and every cnt."""
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
    """Exact int64/decimal segment sum, wrapping mod 2^64, [G]. Covers
    Q1's decimal sum_qty/sum_base_price/sum_disc_price/sum_charge limbs."""
    if not vals.is_cuda:
        return plain_segment_sum_i64(vals, seg, G)
    out = torch.zeros(G, dtype=torch.int64, device=vals.device)
    return _launch("tidb_segsum_i64", "segsum_i64",
                   vals.to(torch.int64).contiguous(),
                   seg.to(torch.int64).contiguous(), G, out)
