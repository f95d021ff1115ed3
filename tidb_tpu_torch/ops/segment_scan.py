"""Segment decode + scan pipeline (the device side of the columnar segment
store; counterpart of tidb_tpu/ops/segment_scan.py).

The encoded columns cross the host->device boundary in their narrow
storage dtypes (int8/int16/int32 frame-of-reference payloads, raw
floats/bools), and the decode, ``ref + stored`` widened to the column's
device repr, happens on the device right before the scan's pushed filter
and projections. In the reference both run as one XLA program; here they
are plain torch on the staged tensors (a kernel comes only once a
profile on the card puts the decode on the critical path).

Frame-of-reference refs arrive as arguments (host ints, or a [k] vector
for a packed batch), so one built closure serves every segment of a
layout. `scan_fn` caches the built closures per (stages, layout, stride)
under the reference's key (`segment_scan_key`), so compiled expressions
are not rebuilt for each statement.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Tuple

import torch

from tidb_tpu_torch.chunk.chunk import Chunk
from tidb_tpu_torch.chunk.column import Column
from tidb_tpu_torch.utils.device import torch_dtype
from tidb_tpu_torch.utils.lru import get_or_build

__all__ = ["make_segment_scan_fn", "segment_scan_key", "decode_for", "scan_fn"]

# built scan closures, keyed by segment_scan_key; bounded because keys
# bake in literal values (dictionary codes of string literals)
MAX_ENTRIES = 512
_FNS: "OrderedDict[str, Callable]" = OrderedDict()
# statements on concurrent server workers share the cache: a lookup's
# move_to_end must not race another's eviction of the same key
_FNS_LOCK = threading.Lock()


def decode_for(d: torch.Tensor, ref, np_dtype) -> torch.Tensor:
    """THE FoR decode: widen the narrow stored payload to the column's
    device repr and add the base (`ref` None = raw staging: dtype-align
    only). `ref` is a Python int or an int64 tensor broadcastable to `d`;
    the sum wraps in the column's dtype, as the reference's does."""
    dt = torch_dtype(np_dtype)
    if ref is not None:
        if isinstance(ref, torch.Tensor) and ref.dim() > 0:
            # one kernel: the narrow payload promotes to int64 in the add
            # (a dimensioned int64 operand promotes; a Python int or a 0-d
            # tensor would not), and an int64 column needs no cast after it
            out = d + ref
            return out if out.dtype == dt else out.to(dt)
        return d.to(dt) + (ref.to(dt) if isinstance(ref, torch.Tensor) else int(ref))
    if d.dtype != dt:
        return d.to(dt)
    return d


def segment_scan_key(stages, col_types, seg_stride: Optional[int] = None) -> str:
    """Cache key covering everything the closure bakes in: the compiled
    pipeline IR, the (uid -> SQLType) output layout, and the packed
    segment stride."""
    return repr(stages) + "|" + repr(
        [(uid, t.kind.value, t.precision, t.scale, t.members)
         for uid, t in col_types]) + f"|stride={seg_stride}"


def make_segment_scan_fn(stages, col_types: List[Tuple[str, object]],
                         seg_stride: Optional[int] = None) -> Callable:
    """Build the Chunk-producing function for one scan layout.

    `col_types`: (uid, SQLType) pairs of the staged storage columns. The
    returned function takes (data, valid, refs, sel): dicts of staged
    tensors, refs holding the FoR base per encoded uid (absent for raw
    columns), and returns the post-pipeline Chunk.

    With `seg_stride`, the staged buffer packs several segments at a
    fixed stride: a ref may then be a [k] per-segment base vector, and
    row i decodes against ref[i // seg_stride]. The batch holds exactly k
    strides, so the decode is a broadcast add over its [k, stride] view
    (no gather), and the narrow payload is still all that crosses
    host->device."""
    from tidb_tpu_torch.executor.scan import make_pipeline_fn

    pipeline = make_pipeline_fn(stages) if stages else None
    types = list(col_types)

    def run(data: Dict, valid: Dict, refs: Dict, sel) -> Chunk:
        cols = {}
        for uid, t in types:
            d = data[uid]
            r = refs.get(uid)
            if (r is not None and seg_stride is not None
                    and isinstance(r, torch.Tensor) and r.dim() >= 1):
                # packed batch: segment j's rows are [j * stride, (j + 1) *
                # stride), so its base broadcasts over row j of the view
                k = r.shape[0]
                out = decode_for(d.view(k, -1), r.view(k, 1), t.np_dtype).view(-1)
            else:
                out = decode_for(d, r, t.np_dtype)
            cols[uid] = Column(out, valid[uid], t)
        ch = Chunk(cols, sel)
        return pipeline(ch) if pipeline is not None else ch

    return run


def scan_fn(stages, col_types, seg_stride: Optional[int] = None) -> Callable:
    """The cached make_segment_scan_fn closure for this layout."""
    key = segment_scan_key(stages, col_types, seg_stride)
    with _FNS_LOCK:
        return get_or_build(
            _FNS, key, lambda: make_segment_scan_fn(stages, col_types, seg_stride),
            MAX_ENTRIES)
