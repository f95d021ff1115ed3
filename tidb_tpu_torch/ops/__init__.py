"""Device kernels for the hot relational primitives.

segment_sum.py holds the hand-written CUDA segment-aggregation kernel
(csrc/segment_sum.cu, one launch per chunk's update) and hash_probe.py
the hash-join probe kernel (csrc/hash_probe.cu), each with its plain PyTorch version and a launch
counter; nvcc_build.py builds the sources at first use. join_kernels.py
holds the join's plain-torch programs around the probe.
"""

from tidb_tpu_torch.ops.segment_sum import (
    LAUNCHES,
    SegAcc,
    reset_launches,
    segment_accumulate,
    segment_count,
    segment_sum_f32,
    segment_sum_i64,
)

__all__ = ["SegAcc", "segment_accumulate", "segment_count", "segment_sum_f32",
           "segment_sum_i64", "LAUNCHES", "reset_launches"]
