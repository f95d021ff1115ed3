"""Per-column segment encodings (a copy of
tidb_tpu/columnar/encoding.py; numpy only).

Encoding selection is value-driven, per segment, per column:

  * integer-backed device reprs (INT, DECIMAL scaled ints, DATE day
    counts, DATETIME/TIME micros, ENUM/SET ordinals, and dictionary
    codes for STRING/JSON — the dictionary itself lives on the table)
    encode **frame-of-reference**: store ``value - min`` in the
    narrowest signed dtype that holds the range (int8/int16/int32),
    falling back to raw int64 when the range spans more than 31 bits
    (the full-int64-range case must round-trip exactly);
  * FLOAT and BOOL store raw (float narrowing is lossy; bool is
    already one byte).

NULL slots store 0 and are carried by the validity mask, exactly like
the uncompressed path. Decoding is ``ref + stored``, done on the device
right after staging (`ops/segment_scan.py`), so the device sees
full-width columns while the host->device transfer moves the narrow
bytes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from tidb_tpu_torch.types import SQLType, TypeKind

__all__ = ["Encoding", "encode_column", "decode_host", "INT_BACKED_KINDS"]

# kinds whose device repr is an int64-family array eligible for FoR
INT_BACKED_KINDS = frozenset({
    TypeKind.INT, TypeKind.DECIMAL, TypeKind.DATE, TypeKind.DATETIME,
    TypeKind.TIME, TypeKind.ENUM, TypeKind.SET, TypeKind.STRING,
    TypeKind.JSON,
})

_NARROW = ((np.int8, 1 << 7), (np.int16, 1 << 15), (np.int32, 1 << 31))


@dataclass(frozen=True)
class Encoding:
    """Static descriptor of one encoded column payload."""

    kind: str          # "for" | "raw"
    dtype: str         # numpy dtype name of the stored array
    ref: int = 0       # frame-of-reference base (device-repr units)


def encode_column(data: np.ndarray, valid: np.ndarray,
                  type_: SQLType, zone=None) -> Tuple[Encoding, np.ndarray]:
    """(encoding, stored array) for one column slice. The stored array
    is always a fresh buffer (segments must not alias table storage —
    the table may grow/rewrite its buffers later). `zone`, the slice's
    ZoneMap when the caller built it, gives the valid slots' count and
    bounds without a second pass."""
    if type_.kind not in INT_BACKED_KINDS or len(data) == 0:
        return Encoding("raw", str(data.dtype)), np.array(data, copy=True)
    if zone is not None:
        every = zone.null_count == 0
        if zone.min is None:
            return (Encoding("for", "int8", 0),
                    np.zeros(len(data), dtype=np.int8))
        mn, mx = int(zone.min), int(zone.max)
    else:
        every = bool(valid.all())
        vals = data if every else data[valid]
        if len(vals) == 0:
            # all-NULL: nothing to reference; one byte per row of zeros
            return (Encoding("for", "int8", 0),
                    np.zeros(len(data), dtype=np.int8))
        mn = int(vals.min())
        mx = int(vals.max())
    span = mx - mn  # python ints: immune to int64 overflow
    for dt, lim in _NARROW:
        if span < lim:
            # NULL slots store the reference (0 after the shift)
            full = data if every else np.where(valid, data, mn)
            shifted = np.subtract(full, np.int64(mn), dtype=np.int64)
            return Encoding("for", np.dtype(dt).name, mn), shifted.astype(dt)
    return Encoding("raw", str(data.dtype)), np.array(data, copy=True)


def decode_host(enc: Encoding, stored: np.ndarray,
                type_: Optional[SQLType] = None) -> np.ndarray:
    """Host-side decode (the test oracle and spill re-materialization
    sanity check; the hot path decodes on the device after staging). NULL slots decode to the reference value — callers mask
    them via the validity array like every other read path."""
    if enc.kind == "raw":
        return stored
    out_dtype = type_.np_dtype if type_ is not None else np.int64
    return stored.astype(np.int64) + np.int64(enc.ref) \
        if out_dtype == np.int64 \
        else (stored.astype(np.int64) + np.int64(enc.ref)).astype(out_dtype)
