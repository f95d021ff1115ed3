"""Executor (ref: executor/ — the Open/Next/Close Volcano operators).

  scan.py      -- TableScanExec (segments or raw slices staged to the
                  device per chunk) + SelectionExec / ProjectionExec
  pipeline.py  -- FusedScanAggExec / FusedScanProbeExec (fused scan
                  fragments), ChunkPrefetcher (pinned staging on a copy
                  stream), DeviceBufferCache (staged inputs across
                  statements)
  aggregate.py -- HashAggExec: packed-code segment strategy on the
                  device through the CUDA segment kernels, or the host
                  generic groupby
  sort.py      -- SortExec / TopNExec / LimitExec / UnionExec (root, host)
  builder.py   -- physical plan -> executor tree (fused where the gates
                  allow, else the classic tree)
  base.py      -- Executor protocol, ExecContext, ResultSet, run_plan
"""

from tidb_tpu_torch.executor.base import ExecContext, Executor, ResultSet, run_plan
from tidb_tpu_torch.executor.builder import build_executor

__all__ = ["ExecContext", "Executor", "ResultSet", "build_executor", "run_plan"]
