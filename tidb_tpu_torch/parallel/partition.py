"""Sharded tables: the partition catalog (counterpart of
tidb_tpu/parallel/partition.py).

A host Table is split row-wise into P equal fixed-capacity partitions,
one per mesh part, padded to a static per-part row capacity R: part p
holds rows [p*R, (p+1)*R) with R = ceil(n / P), as in the reference.
Where the reference keeps one [P, R] array sharded over the mesh, the
port keeps one [R] tensor per part on that part's device. On a mesh of
one device (the one-card mesh, or shards over one card) a sharding is
packed: every column, validity, live mask and FoR base of every part is
a view of one buffer, staged by one host->device copy, and the sharding
is one argument of a fragment program (``ShardedTable.args()``, a
``jitcache.PackedTuple``): read in place when resident, copied in at
once when it is a streamed batch. On a mesh over several devices, parts
that share a device are views of one [k, R] staging copy, so each device
gets one host->device copy per column.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from tidb_tpu_torch.parallel.mesh import Mesh
from tidb_tpu_torch.types import SQLType

__all__ = ["ShardedTable", "shard_table", "stream_batches", "table_bytes",
           "part_args", "upload_packed"]


@dataclass
class ShardedTable:
    """Columns as one [R] tensor per part, on that part's device.

    With ``encode=True`` staging, integer-backed columns travel
    frame-of-reference encoded: ``data[name][p]`` holds ``value - ref`` in
    the narrowest of int8/int16/int32 that covers the column's valid
    range, and ``refs[name]`` carries the int64 base. Fragment programs
    decode (``stored + ref``, widened to the column's device repr) on the
    device, so the narrow bytes are all that cross host->device."""

    mesh: Mesh
    n_parts: int
    rows_per_part: int
    total_rows: int
    data: Dict[str, List[torch.Tensor]]     # name -> P x [R]
    valid: Dict[str, List[torch.Tensor]]    # name -> P x [R] bool
    sel: List[torch.Tensor]                 # P x [R] bool: live rows
    types: Dict[str, SQLType]
    dicts: Dict[str, object]                # string dictionaries (host-side)
    # FoR bases of encoded columns (absent name = raw staging)
    refs: Dict[str, int] = field(default_factory=dict)
    # process-unique, never-recycled id: cache keys built from it can never
    # alias a different sharding the way id()-based keys can after GC
    serial: int = field(default_factory=itertools.count().__next__)
    # on a mesh of one device, the sharding's (data, valid, sel, refs)
    # packed over one buffer (refs as int64 [1] tensors), else None
    packed: object = None

    def args(self) -> tuple:
        """The sharding as one argument of a fragment program: (data,
        valid, sel, refs), packed into one buffer on a mesh of one device."""
        if self.packed is not None:
            return self.packed
        return (self.data, self.valid, self.sel, self.refs)


def part_args(data, valid, sel, refs, p: int) -> tuple:
    """Part p's (data, valid, sel, refs) from a sharding's per-part lists:
    the arguments of its per-shard program."""
    return ({n: d[p] for n, d in data.items()},
            {n: v[p] for n, v in valid.items()}, sel[p], refs)


def table_bytes(table, columns: Optional[List[str]] = None) -> int:
    """Device bytes a full sharding of `table` would occupy (data +
    validity for the chosen columns)."""
    names = columns or [c.name for c in table.schema.columns]
    n = table.n
    total = 0
    for name in names:
        total += n * (table.data[name].dtype.itemsize + 1)  # + valid byte
    return total + n  # + sel mask


def _encode_staged(d: np.ndarray, v: np.ndarray, type_: SQLType):
    """(stored, ref) when FoR staging pays for this column slice, else
    (None, 0), through columnar.encoding.encode_column (the one encoder
    whose payloads ops/segment_scan.decode_for decodes)."""
    from tidb_tpu_torch.columnar.encoding import INT_BACKED_KINDS, encode_column

    if type_.kind not in INT_BACKED_KINDS \
            or not np.issubdtype(d.dtype, np.integer) \
            or d.dtype.itemsize <= 1 or not v.any():
        return None, 0
    enc, stored = encode_column(d, v, type_)
    if enc.kind != "for" or stored.dtype.itemsize >= d.dtype.itemsize:
        return None, 0
    return stored, int(enc.ref)


def stream_batches(table, mesh: Mesh, columns: Optional[List[str]],
                   rows_per_part: int, encode: bool = False):
    """Yield fixed-shape ShardedTable batches covering the whole table:
    batch b stages rows [b*P*R, (b+1)*P*R). Every batch has the same
    shapes and types, so one fragment program serves every batch."""
    rows_per_batch = mesh.n_parts * rows_per_part
    n = table.n
    for start in range(0, max(n, 1), rows_per_batch):
        yield shard_table(table, mesh, columns=columns,
                          rows_per_part=rows_per_part,
                          row_range=(start, min(start + rows_per_batch, n)),
                          encode=encode)


def upload_packed(arrays: List[np.ndarray], dev) -> tuple:
    """The host arrays on `dev` by ONE host->device copy: (buf, views),
    the 1-d uint8 device buffer and, in order, a view of it per array,
    each starting on a 256-byte boundary (jitcache.packed_view takes
    them as one packed tree)."""
    from tidb_tpu_torch.utils import dispatch

    offs, off = [], 0
    for a in arrays:
        offs.append(off)
        off += (max(a.nbytes, 1) + 255) // 256 * 256
    host = np.zeros(max(off, 256), dtype=np.uint8)
    for a, o in zip(arrays, offs):
        host[o:o + a.nbytes] = np.ascontiguousarray(a).reshape(-1).view(np.uint8)
    buf = torch.from_numpy(host).to(dev)
    if buf.is_cuda:
        dispatch.record_xfer(host.nbytes)
    views = [buf[o:o + a.nbytes].view(torch.from_numpy(a[:0].reshape(-1)).dtype)
             .view(a.shape) for a, o in zip(arrays, offs)]
    return buf, views


def _place_packed(host_cols, live: np.ndarray, refs: Dict[str, int],
                  names: List[str], dev):
    """A one-device sharding's (data, valid, sel, refs), every part's
    tensors views of one device buffer staged by one copy, as a
    jitcache.PackedTuple (refs as int64 [1] tensors)."""
    from tidb_tpu_torch.utils.jitcache import packed_view

    ref_names = [n for n in names if n in refs]
    arrays = ([host_cols[n][0] for n in names] + [host_cols[n][1] for n in names]
              + [live] + [np.array([refs[n]], dtype=np.int64) for n in ref_names])
    buf, views = upload_packed(arrays, dev)
    k, n_parts = len(names), live.shape[0]

    def parts(v):
        return [v[p] for p in range(n_parts)]

    tree = ({n: parts(views[i]) for i, n in enumerate(names)},
            {n: parts(views[k + i]) for i, n in enumerate(names)},
            parts(views[2 * k]),
            {n: views[2 * k + 1 + i] for i, n in enumerate(ref_names)})
    return packed_view(buf, tree)


def _place(buf: np.ndarray, mesh: Mesh) -> List[torch.Tensor]:
    """Per-part tensors of a host [P, R] buffer: one copy per device,
    each part a row view of its device's copy."""
    from tidb_tpu_torch.utils import dispatch

    out: List[Optional[torch.Tensor]] = [None] * mesh.n_parts
    by_dev: Dict[torch.device, List[int]] = {}
    for p, dev in enumerate(mesh.devices):
        by_dev.setdefault(dev, []).append(p)
    for dev, parts in by_dev.items():
        host = np.ascontiguousarray(buf[parts])
        t = torch.from_numpy(host).to(dev)
        if t.is_cuda:
            dispatch.record_xfer(host.nbytes)
        for i, p in enumerate(parts):
            out[p] = t[i]
    return out


def shard_table(table, mesh: Mesh, columns: Optional[List[str]] = None,
                rows_per_part: Optional[int] = None,
                row_range: Optional[tuple] = None,
                encode: bool = False) -> ShardedTable:
    """Partition a host Table (or a row range of it) across the mesh's
    (dcn x shard) grid. ``encode=True`` stages integer-backed columns
    FoR-encoded in narrow dtypes (see ShardedTable.refs). On a mesh of
    one device the whole sharding is staged by one copy into one buffer
    (ShardedTable.packed)."""
    n_parts = mesh.n_parts
    lo, hi = row_range if row_range is not None else (0, table.n)
    n = hi - lo
    R = rows_per_part or max((n + n_parts - 1) // n_parts, 1)
    if R * n_parts < n:
        raise ValueError(f"rows_per_part {R} too small for {n} rows / {n_parts} parts")
    names = columns or [c.name for c in table.schema.columns]

    live = np.zeros((n_parts, R), dtype=np.bool_)
    types: Dict[str, SQLType] = {}
    dicts: Dict[str, object] = {}
    refs: Dict[str, int] = {}
    host_cols = {}
    for name in names:
        info = table.schema.col(name)
        d, v = table.column_slice(name, lo, hi)
        if encode:
            stored, ref = _encode_staged(d, v, info.type_)
            if stored is not None:
                d = stored
                refs[name] = ref
        buf = np.zeros((n_parts, R), dtype=d.dtype)
        vbuf = np.zeros((n_parts, R), dtype=np.bool_)
        host_cols[name] = (buf, vbuf, d, v)
        types[name] = info.type_
        dc = table.dicts.get(name)
        if dc is not None:
            dicts[name] = dc

    row_live = table.live_mask(lo, hi)
    for p in range(n_parts):
        s, e = p * R, min((p + 1) * R, n)
        if s >= n:
            break
        m = e - s
        live[p, :m] = row_live[s:e]
        for name in names:
            buf, vbuf, d, v = host_cols[name]
            buf[p, :m] = d[s:e]
            vbuf[p, :m] = v[s:e]

    one = mesh.single_device
    if one is not None:
        packed = _place_packed(host_cols, live, refs, names, one)
        data, valid, sel, dev_refs = packed
        return ShardedTable(
            mesh=mesh, n_parts=n_parts, rows_per_part=R, total_rows=n,
            data=data, valid=valid, sel=sel, types=types, dicts=dicts,
            refs=dev_refs, packed=packed)
    data = {name: _place(host_cols[name][0], mesh) for name in names}
    valid = {name: _place(host_cols[name][1], mesh) for name in names}
    return ShardedTable(
        mesh=mesh, n_parts=n_parts, rows_per_part=R, total_rows=n,
        data=data, valid=valid, sel=_place(live, mesh), types=types,
        dicts=dicts, refs=refs,
    )
