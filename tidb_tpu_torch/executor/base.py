"""Executor protocol and execution context."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional

import torch

from tidb_tpu_torch.chunk.chunk import Chunk
from tidb_tpu_torch.planner.binder import PlanCol

__all__ = ["ExecContext", "Executor", "ResultSet", "run_plan"]


@dataclass
class ExecContext:
    chunk_capacity: int = 1 << 16
    # where scans stage their chunks and device state lives
    device: torch.device = torch.device("cpu")
    # GROUP_CONCAT result truncation (group_concat_max_len sysvar)
    group_concat_max_len: int = 1024
    # hash-join build packs and sorts on the device; False sorts on the
    # host and stages the sorted keys (tidb_tpu_join_device_build sysvar)
    join_device_build: bool = True
    # output tiles one join expand call may emit; bounds the [T, C] buffer
    # of a many-to-many join (tidb_tpu_join_tiles_per_dispatch sysvar)
    join_tiles: int = 8
    # probe route of the hash join: off = searchsorted, auto = the
    # open-addressing table on the card and searchsorted on the CPU,
    # xla/pallas = the table (tidb_tpu_join_probe_mode sysvar)
    join_probe_mode: str = "auto"


class Executor:
    """Open/Next/Close — the same operator boundary as the reference's
    executor.Executor, pulling device Chunks."""

    schema: List[PlanCol]

    def __init__(self, schema: List[PlanCol], children: List["Executor"]):
        self.schema = schema
        self.children = children

    def open(self, ctx: ExecContext) -> None:
        for c in self.children:
            c.open(ctx)

    def next(self) -> Optional[Chunk]:
        raise NotImplementedError

    def close(self) -> None:
        for c in self.children:
            c.close()

    def chunks(self) -> Iterator[Chunk]:
        while True:
            ch = self.next()
            if ch is None:
                return
            yield ch


@dataclass
class ResultSet:
    names: List[str]
    rows: List[tuple]

    def __len__(self):
        return len(self.rows)


def run_plan(root: Executor, ctx: ExecContext, n_visible: Optional[int] = None) -> ResultSet:
    """Drive an executor tree to completion and materialize host rows."""
    opened = False
    try:
        root.open(ctx)  # inside try: open() can raise after acquiring
        opened = True
        visible = root.schema if n_visible is None else root.schema[:n_visible]
        uids = [c.uid for c in visible]
        dicts = {c.uid: c.dict_ for c in visible if c.dict_ is not None}
        rows: List[tuple] = []
        for ch in root.chunks():
            rows.extend(ch.to_pylist(dicts=dicts, names=uids))
        return ResultSet(names=[c.name for c in visible], rows=rows)
    finally:
        try:
            root.close()
        except Exception:
            if opened:
                raise
