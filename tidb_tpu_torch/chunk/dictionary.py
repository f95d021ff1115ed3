"""Sorted string dictionaries — collation-aware.

TPUs cannot chase string offsets, so every string column is dictionary
encoded at ingest: column data becomes int32 codes, and this host-side
Dictionary maps codes <-> strings. The dictionary is kept **sorted in
collation order**, so

  code(a) < code(b)  <=>  a sorts before b under the column's collation

which lets <, <=, BETWEEN, ORDER BY, and MIN/MAX on strings run directly on
the codes on device. Predicates that need string *content* (LIKE, functions)
are evaluated host-side over the dictionary (small) to produce a boolean
lookup table that is gathered on device — O(|dict|) host work instead of
O(rows) device work.

Collations (ref: MySQL's per-column collations; the reference erases
them to binary only when the column declares a _bin collation):

- ``utf8mb4_bin``: bytewise order, every distinct byte string is its own
  equivalence class (the pre-round-5 behavior).
- ``utf8mb4_general_ci`` (the default, matching MySQL's case-insensitive
  default): values sort by ``(fold(v), v)`` so each case-fold class is a
  CONTIGUOUS code range; equality against a literal compiles to a code
  range test, and col-vs-col equality / join keys / GROUP BY keys go
  through the ``canon`` LUT that maps every code to its class
  representative. Folding is ASCII case folding — exactly sqlite's
  NOCASE, so the test oracle matches by construction; full Unicode
  simple folding is a swap of ``_fold`` away.
"""

from __future__ import annotations

import bisect
from typing import Iterable, Optional, Sequence

import numpy as np

__all__ = ["Dictionary", "DEFAULT_COLLATION", "BIN_COLLATION"]

DEFAULT_COLLATION = "utf8mb4_general_ci"
BIN_COLLATION = "utf8mb4_bin"

_ASCII_LOWER = str.maketrans(
    {c: chr(ord(c) + 32) for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ"})


def _is_ci(collation: str) -> bool:
    return collation.endswith("_ci")


class Dictionary:
    """Immutable sorted string dictionary.

    `values` is a list of unique strings sorted in collation order; code
    i represents values[i]. Code -1 is never produced by encoding (NULLs
    are carried by the validity mask) but is used as "absent" in
    translations.
    """

    __slots__ = ("values", "_index", "collation", "_folded", "_canon")

    def __init__(self, values: Sequence[str],
                 collation: str = BIN_COLLATION):
        self.collation = collation
        if _is_ci(collation):
            vals = sorted(set(values), key=lambda v: (self.fold(v), v))
            self.values = vals
            folded = [self.fold(v) for v in vals]
            self._folded = folded
            # canonical code = first code of each fold class (classes
            # are contiguous under the (fold, raw) sort)
            canon = np.arange(len(vals), dtype=np.int32)
            for i in range(1, len(vals)):
                if folded[i] == folded[i - 1]:
                    canon[i] = canon[i - 1]
            self._canon = canon
        else:
            vals = sorted(set(values))
            self.values = vals
            self._folded = None
            self._canon = None
        self._index = {v: i for i, v in enumerate(vals)}

    def fold(self, s: str) -> str:
        """Collation fold key (identity for _bin)."""
        if _is_ci(self.collation):
            return s.translate(_ASCII_LOWER)
        return s

    @property
    def is_ci(self) -> bool:
        return self._canon is not None

    def __len__(self) -> int:
        return len(self.values)

    def __contains__(self, s: str) -> bool:
        return s in self._index

    def __eq__(self, other) -> bool:
        return (isinstance(other, Dictionary)
                and self.collation == other.collation
                and self.values == other.values)

    def __hash__(self) -> int:
        return hash((self.collation, tuple(self.values)))

    # -- encoding ----------------------------------------------------------

    @classmethod
    def encode(cls, strings: Iterable[Optional[str]],
               collation: str = BIN_COLLATION) -> tuple["Dictionary", np.ndarray, np.ndarray]:
        """Build a dictionary from raw strings.

        Returns (dict, codes int32[n], valid bool[n]); None entries encode
        as code 0 with valid=False.
        """
        strings = list(strings)
        valid = np.array([s is not None for s in strings], dtype=np.bool_)
        present = np.array([s for s in strings if s is not None], dtype=object)
        if len(present) == 0:
            return cls([], collation), np.zeros(len(strings), dtype=np.int32), valid
        # vectorized: ingest is the per-column hot path for 1M-row chunks
        uniq, inverse = np.unique(present.astype(str), return_inverse=True)
        d = cls(uniq.tolist(), collation)
        codes = np.zeros(len(strings), dtype=np.int32)
        if d.values == uniq.tolist():
            codes[valid] = inverse.astype(np.int32)
        else:
            # collation order differs from bytewise: remap unique codes
            remap = np.array([d._index[v] for v in uniq.tolist()],
                             dtype=np.int32)
            codes[valid] = remap[inverse]
        return d, codes, valid

    def encode_with(self, strings: Iterable[Optional[str]]) -> tuple[np.ndarray, np.ndarray]:
        """Encode strings against this existing dictionary; unknown strings
        raise (the catalog must re-encode the column to grow a dictionary).
        Lookup is by exact raw value — a _ci dictionary still stores every
        distinct raw string; equivalence only matters at compare time.
        One hash lookup a value: the codes a bytewise search of the
        sorted values (or, for _ci, of its bytewise view) would find."""
        strings = list(strings)
        valid = np.fromiter((s is not None for s in strings), dtype=np.bool_,
                            count=len(strings))
        codes = np.zeros(len(strings), dtype=np.int32)
        if valid.any():
            index = self._index
            try:
                codes[valid] = np.fromiter(
                    (index[s] for s in strings if s is not None),
                    dtype=np.int32, count=int(valid.sum()))
            except KeyError:
                bad = next(s for s in strings
                           if s is not None and s not in index)
                raise KeyError(f"string {bad!r} not in dictionary") from None
        return codes, valid

    def decode(self, codes: np.ndarray, valid: Optional[np.ndarray] = None) -> list:
        codes = np.asarray(codes)
        vals = self.values
        live = (np.ones(len(codes), dtype=np.bool_) if valid is None
                else np.asarray(valid, dtype=np.bool_))
        picked = codes[live].astype(np.int64, copy=False)
        bad = (picked < 0) | (picked >= len(vals))
        if bad.any():
            # code -1 is the "absent" sentinel from translate_to; letting
            # python's negative indexing map it to the last entry would
            # silently return the wrong string.
            raise IndexError(f"string code {int(picked[bad][0])} out of range "
                             f"for dictionary of {len(vals)}")
        got = [vals[c] for c in picked.tolist()]
        if len(got) == len(codes):
            return got
        out = [None] * len(codes)
        for i, v in zip(np.nonzero(live)[0].tolist(), got):
            out[i] = v
        return out

    # -- predicate support -------------------------------------------------

    def code_of(self, s: str) -> int:
        """Exact-raw-match code, or -1 if the string is absent. Collation
        equality must use eq_range (a _ci class spans several codes)."""
        return self._index.get(s, -1)

    def eq_range(self, s: str) -> tuple[int, int]:
        """[lo, hi) code range equal to s under the collation: the fold
        class for _ci, the single exact code for _bin. Empty (lo == hi)
        when no value compares equal."""
        if self._canon is None:
            c = self._index.get(s, -1)
            return (c, c + 1) if c >= 0 else (0, 0)
        f = self.fold(s)
        lo = bisect.bisect_left(self._folded, f)
        hi = bisect.bisect_right(self._folded, f)
        return lo, hi

    def lower_bound(self, s: str) -> int:
        """First code whose string >= s under the collation (insertion
        point). Lets range predicates on strings compile to integer
        comparisons on codes: col < s  <=>  code < lower_bound(s)."""
        if self._canon is None:
            return bisect.bisect_left(self.values, s)
        return bisect.bisect_left(self._folded, self.fold(s))

    def upper_bound(self, s: str) -> int:
        """First code whose string > s under the collation."""
        if self._canon is None:
            return bisect.bisect_right(self.values, s)
        return bisect.bisect_right(self._folded, self.fold(s))

    def canon_lut(self) -> np.ndarray:
        """int32[len] mapping every code to its equivalence-class
        representative (first code of the fold class). Identity for
        _bin. Monotone, so canon codes preserve collation order — join
        keys, GROUP BY keys, and col-vs-col comparisons gather through
        this so fold-equal values compare equal."""
        if self._canon is not None:
            return self._canon
        return np.arange(len(self.values), dtype=np.int32)

    def match_table(self, pred) -> np.ndarray:
        """Evaluate an arbitrary python predicate over the dictionary,
        returning bool[len(dict)] — the device then gathers codes through
        this LUT. Used for LIKE / regexp / string functions."""
        return np.fromiter((bool(pred(v)) for v in self.values), dtype=np.bool_, count=len(self.values))

    def apply_table(self, fn, out_dtype) -> np.ndarray:
        """Map an arbitrary python fn over the dictionary producing a value
        LUT (e.g. LENGTH, to-number casts)."""
        return np.array([fn(v) for v in self.values], dtype=out_dtype)

    # -- dictionary alignment (joins/unions across columns) ----------------

    def translate_to(self, other: "Dictionary") -> np.ndarray:
        """int32[len(self)] mapping self-codes -> other-codes by EXACT
        raw value (-1 if absent from `other`). Device-side re-encoding
        is then a single gather. Value-preserving: used wherever the
        translated code is decoded back to a string (projections,
        set-op alignment, dictionary growth)."""
        out = np.full(len(self.values), -1, dtype=np.int32)
        oidx = other._index
        for i, v in enumerate(self.values):
            j = oidx.get(v)
            if j is not None:
                out[i] = j
        return out

    def translate_canon_to(self, other: "Dictionary") -> np.ndarray:
        """int32[len(self)] mapping self-codes -> other's CANONICAL codes
        under other's collation (-1 when nothing in `other` compares
        equal). For comparison positions only (join keys, IN-subquery
        alignment): two fold-equal values land on the same code."""
        if other._canon is None:
            return self.translate_to(other)
        out = np.full(len(self.values), -1, dtype=np.int32)
        for i, v in enumerate(self.values):
            lo, hi = other.eq_range(v)
            if lo < hi:
                out[i] = lo  # first of class == canonical
        return out

    @classmethod
    def union(cls, a: "Dictionary", b: "Dictionary") -> "Dictionary":
        """Union dictionary. Collations must agree to keep ci semantics;
        a mixed pair degrades to binary comparison (MySQL would raise
        'illegal mix of collations' — degrading keeps legacy _bin
        columns comparable against new _ci ones)."""
        coll = a.collation if a.collation == b.collation else BIN_COLLATION
        return cls(list(a.values) + list(b.values), coll)


class RuntimeDictionary(Dictionary):
    """A dictionary whose values only exist at execution time (e.g. the
    output of GROUP_CONCAT: result strings are built per run, not at plan
    time). Plan-time LUT construction over a pending runtime dictionary
    would bake in an empty table, so those entry points raise until
    `fill()` provides the values; result decoding (`decode`) then works
    like any other dictionary."""

    __slots__ = ("pending",)

    def __init__(self, values):
        super().__init__(values)
        self.pending = True

    def fill(self, values) -> None:
        """Replace contents in place (same object stays attached to the
        plan column across re-executions)."""
        Dictionary.__init__(self, values, self.collation)
        self.pending = False

    def _guard(self, op: str):
        if self.pending:
            raise ValueError(
                f"{op} over a runtime dictionary before execution")

    def match_table(self, pred):
        self._guard("match_table")
        return super().match_table(pred)

    def apply_table(self, fn, out_dtype):
        self._guard("apply_table")
        return super().apply_table(fn, out_dtype)

    def translate_to(self, other):
        self._guard("translate_to")
        return super().translate_to(other)
