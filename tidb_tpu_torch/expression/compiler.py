"""Compile the typed expression IR to functions over torch chunks.

Each node evaluates to (data, valid) — dense tensors of the chunk capacity
on the chunk's device. `data` is unspecified where ~valid; consumers must
never branch on invalid lanes (WHERE masks are `data & valid`). PyTorch
runs eagerly, so each node is one or a few kernel launches.

Decimal discipline (as in tidb_tpu/expression/compiler.py): the IR carries
scales in types; the compiler inserts power-of-ten rescales so that
    add/sub  operate at the result scale,
    mul      naturally lands on scale_a + scale_b == result scale,
    div      leaves fixed point and produces float64.

Integer division follows jnp: `//` and `%` floor, `jax.lax.div` truncates.
Each becomes `torch.div(..., rounding_mode=...)` with the mode spelled out.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Tuple

import numpy as np
import torch

from tidb_tpu_torch.chunk.column import Column
from tidb_tpu_torch.errors import ExecutionError, PlanError
from tidb_tpu_torch.expression import dates
from tidb_tpu_torch.expression.expr import (
    AggRef,
    Call,
    Case,
    Cast,
    ColumnRef,
    Expr,
    InList,
    Literal,
    Lookup,
)
from tidb_tpu_torch.types import SQLType, TypeKind
from tidb_tpu_torch.utils import dispatch
from tidb_tpu_torch.utils.device import torch_dtype

__all__ = ["compile_expr", "compile_predicate", "eval_expr"]

# Lookup tables already on a device, by (values, dtype, device). Each plan
# builds its own tuples, so a table object maps to its content key once
# (_TABLE_KEYS, which keeps the object alive so its id stays its own) and
# the tensor is shared by every statement with the same values: a chunk's
# gather then makes no blocking host->device copy.
_TABLE_KEYS: "OrderedDict" = OrderedDict()
_TABLES: "OrderedDict" = OrderedDict()
_TABLES_MAX = 64
_TABLES_LOCK = threading.Lock()


def _device_table(values: tuple, np_dtype, dev: torch.device) -> torch.Tensor:
    with _TABLES_LOCK:
        hit = _TABLE_KEYS.get(id(values))
        if hit is None or hit[0] is not values:
            hit = (values, hash(values))
            _TABLE_KEYS[id(values)] = hit
            while len(_TABLE_KEYS) > _TABLES_MAX:
                _TABLE_KEYS.popitem(last=False)
        key = (hit[1], len(values), np.dtype(np_dtype).str, str(dev))
        entry = _TABLES.get(key)
        if entry is None or (entry[0] is not values and entry[0] != values):
            # a CUDA graph's capture cannot upload (a blocking copy): it
            # takes the table its eager warm-up made, even when this cache
            # has evicted it since
            kept = dispatch.held(("lookup",) + key)
            if kept is not None and (kept[0] is values or kept[0] == values):
                entry = kept
            elif dispatch.capturing():
                raise ExecutionError("a lookup table must be on the device before a CUDA "
                                "graph capture: its warm-up uploads it")
            else:
                entry = (values, torch.as_tensor(np.asarray(values, dtype=np_dtype),
                                                 device=dev))
        # hold the caller's tuple: its next chunks match by identity
        entry = _TABLES[key] = (values, entry[1])
        _TABLES.move_to_end(key)
        while len(_TABLES) > _TABLES_MAX:
            _TABLES.popitem(last=False)
    # a graph being captured reads the table: it keeps it alive past an
    # eviction from this cache (and a warm-up holds it for its capture)
    dispatch.retain(entry, key=("lookup",) + key)
    return entry[1]

Pair = Tuple[torch.Tensor, torch.Tensor]  # (data, valid)


def _fdiv(a, b):
    """jnp.floor_divide / python `//`."""
    return torch.div(a, b, rounding_mode="floor")


def _tdiv(a, b):
    """jax.lax.div on integers: truncation toward zero."""
    return torch.div(a, b, rounding_mode="trunc")


def _f64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float64)


def _rescale(data: torch.Tensor, from_scale: int, to_scale: int) -> torch.Tensor:
    if from_scale == to_scale:
        return data
    if to_scale > from_scale:
        return data * (10 ** (to_scale - from_scale))
    # scale-down rounds half away from zero like MySQL
    f = 10 ** (from_scale - to_scale)
    return torch.where(data >= 0, _fdiv(data + f // 2, f),
                       -_fdiv(-data + f // 2, f))


def _to_kind(data: torch.Tensor, frm: SQLType, to: SQLType) -> torch.Tensor:
    """Numeric representation change frm -> to (validity unchanged)."""
    if frm.kind == to.kind:
        if frm.kind == TypeKind.DECIMAL:
            return _rescale(data, frm.scale, to.scale)
        return data.to(torch_dtype(to.np_dtype))
    k_from, k_to = frm.kind, to.kind
    if k_to == TypeKind.FLOAT:
        if k_from == TypeKind.DECIMAL:
            return _f64(data) / (10**frm.scale)
        return _f64(data)
    if k_to == TypeKind.DECIMAL:
        if k_from == TypeKind.FLOAT:
            scaled = data * (10**to.scale)
            return torch.where(scaled >= 0, scaled + 0.5, scaled - 0.5).to(torch.int64)
        return data.to(torch.int64) * (10**to.scale)
    if k_to == TypeKind.INT:
        if k_from == TypeKind.DECIMAL:
            return _rescale(data, frm.scale, 0)
        if k_from == TypeKind.FLOAT:
            return torch.where(data >= 0, data + 0.5, data - 0.5).to(torch.int64)
        return data.to(torch.int64)
    if k_to == TypeKind.BOOL:
        return data != 0
    if k_to == TypeKind.DATETIME and k_from == TypeKind.DATE:
        return data.to(torch.int64) * 86_400_000_000
    if k_to == TypeKind.DATE and k_from == TypeKind.DATETIME:
        return _fdiv(data, 86_400_000_000).to(torch.int32)
    raise PlanError(f"unsupported cast {frm} -> {to}")


def _days(data: torch.Tensor, t: SQLType) -> torch.Tensor:
    """Temporal value -> days-since-epoch."""
    if t.kind == TypeKind.DATETIME:
        return _fdiv(data, 86_400_000_000)
    return data.to(torch.int64)


def _true_div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp true division under x64: integers divide in float64 (torch's
    own int/int gives float32)."""
    if not a.is_floating_point():
        a = _f64(a)
    if not b.is_floating_point():
        b = _f64(b)
    return a / b


# ---------------------------------------------------------------------------
# evaluation
# ---------------------------------------------------------------------------


def eval_expr(e: Expr, chunk) -> Pair:
    """Evaluate IR node `e` over `chunk` -> (data, valid) on chunk.device."""
    cap = chunk.capacity
    dev = chunk.device

    if isinstance(e, (ColumnRef, AggRef)):
        col = chunk.columns[e.name]
        return col.data, col.valid

    if isinstance(e, Literal):
        dt = torch_dtype(e.type_.np_dtype)
        if e.value is None:
            return (torch.zeros(cap, dtype=dt, device=dev),
                    torch.zeros(cap, dtype=torch.bool, device=dev))
        return (torch.full((cap,), e.value, dtype=dt, device=dev),
                torch.ones(cap, dtype=torch.bool, device=dev))

    if isinstance(e, Cast):
        data, valid = eval_expr(e.arg, chunk)
        return _to_kind(data, e.arg.type_, e.type_), valid

    if isinstance(e, Lookup):
        data, valid = eval_expr(e.arg, chunk)
        table = _device_table(e.table, e.type_.np_dtype, dev)
        idx = data.to(torch.int64).clamp(0, len(e.table) - 1)
        out = table[idx]
        if e.table_valid is not None:
            valid = valid & _device_table(e.table_valid, np.bool_, dev)[idx]
        # codes outside the table (e.g. -1 absent sentinel) are invalid
        valid = valid & (data >= 0) & (data < len(e.table))
        return out, valid

    if isinstance(e, InList):
        data, valid = eval_expr(e.arg, chunk)
        vals = np.asarray(e.values, dtype=e.arg.type_.np_dtype)
        hit = torch.zeros(cap, dtype=torch.bool, device=dev)
        for v in vals:  # planner uses Lookup for long lists
            hit = hit | (data == v.item())
        return (~hit if e.negated else hit), valid

    if isinstance(e, Case):
        if e.else_ is not None:
            out, ov = eval_expr(e.else_, chunk)
            out = _to_kind(out, e.else_.type_, e.type_)
        else:
            out = torch.zeros(cap, dtype=torch_dtype(e.type_.np_dtype), device=dev)
            ov = torch.zeros(cap, dtype=torch.bool, device=dev)
        taken = torch.zeros(cap, dtype=torch.bool, device=dev)
        for cond, res in e.whens:
            cd, cv = eval_expr(cond, chunk)
            rd, rv = eval_expr(res, chunk)
            rd = _to_kind(rd, res.type_, e.type_)
            fire = cd & cv & ~taken
            out = torch.where(fire, rd, out)
            ov = torch.where(fire, rv, ov)
            taken = taken | fire
        return out, ov

    if isinstance(e, Call):
        fn = FUNCS.get(e.op)
        if fn is None:
            raise PlanError(f"unknown scalar function {e.op!r}")
        return fn(e, chunk)

    raise PlanError(f"cannot evaluate node {type(e).__name__}")


def compile_expr(e: Expr) -> Callable:
    """IR -> (chunk -> Column)."""

    def run(chunk) -> Column:
        data, valid = eval_expr(e, chunk)
        return Column(data, valid, e.type_)

    return run


def compile_predicate(e: Expr) -> Callable:
    """IR -> (chunk -> bool mask); NULL predicate rows are excluded."""

    def run(chunk) -> torch.Tensor:
        data, valid = eval_expr(e, chunk)
        return data & valid

    return run


# ---------------------------------------------------------------------------
# scalar function registry
# ---------------------------------------------------------------------------


def _strict2(op):
    """Binary strict function: valid = va & vb."""

    def fn(e: Call, chunk) -> Pair:
        a, b = e.args
        (da, va), (db, vb) = eval_expr(a, chunk), eval_expr(b, chunk)
        if e.type_.kind == TypeKind.DECIMAL:
            da = _rescale(da, a.type_.scale, e.type_.scale) if e.op in ("add", "sub") else da
            db = _rescale(db, b.type_.scale, e.type_.scale) if e.op in ("add", "sub") else db
        elif e.type_.kind == TypeKind.FLOAT:
            da = _to_kind(da, a.type_, e.type_)
            db = _to_kind(db, b.type_, e.type_)
        return op(da, db), va & vb

    return fn


def _align_cmp(a, b, da, db):
    if a.type_.kind == TypeKind.DECIMAL or b.type_.kind == TypeKind.DECIMAL:
        s = max(a.type_.scale, b.type_.scale)
        da = _rescale(da, a.type_.scale, s) if a.type_.kind == TypeKind.DECIMAL else da * 10**s
        db = _rescale(db, b.type_.scale, s) if b.type_.kind == TypeKind.DECIMAL else db * 10**s
    return da, db


def _cmp(op):
    """Comparison: builder guarantees comparable kinds; align decimal scales."""

    def fn(e: Call, chunk) -> Pair:
        a, b = e.args
        (da, va), (db, vb) = eval_expr(a, chunk), eval_expr(b, chunk)
        da, db = _align_cmp(a, b, da, db)
        return op(da, db), va & vb

    return fn


def _nseq(e: Call, chunk) -> Pair:
    """Null-safe equal <=> : NULL<=>NULL is TRUE, never returns NULL."""
    a, b = e.args
    (da, va), (db, vb) = eval_expr(a, chunk), eval_expr(b, chunk)
    da, db = _align_cmp(a, b, da, db)
    both_null = ~va & ~vb
    eq = va & vb & (da == db)
    return both_null | eq, torch.ones_like(va)


def _truncate(e: Call, chunk) -> Pair:
    """TRUNCATE(x, d): toward zero, unlike ROUND."""
    a = e.args[0]
    nd = 0
    if len(e.args) > 1:
        lit = e.args[1]
        if not isinstance(lit, Literal):
            raise PlanError("TRUNCATE digits must be a constant")
        nd = int(lit.value)
    d, v = eval_expr(a, chunk)
    if a.type_.kind == TypeKind.DECIMAL:
        f = 10 ** max(a.type_.scale - nd, 0)
        out = _tdiv(d, f) * f if f > 1 else d
        return _rescale(out, a.type_.scale, e.type_.scale), v
    f = 10.0**nd
    return torch.trunc(_f64(d) * f) / f, v


def _and(e: Call, chunk) -> Pair:
    a, b = e.args
    (da, va), (db, vb) = eval_expr(a, chunk), eval_expr(b, chunk)
    ta, tb = da & va, db & vb  # definitely-true lanes
    fa, fb = ~da & va, ~db & vb  # definitely-false lanes
    return ta & tb, (va & vb) | fa | fb


def _or(e: Call, chunk) -> Pair:
    a, b = e.args
    (da, va), (db, vb) = eval_expr(a, chunk), eval_expr(b, chunk)
    ta, tb = da & va, db & vb
    return ta | tb, (va & vb) | ta | tb


def _not(e: Call, chunk) -> Pair:
    d, v = eval_expr(e.args[0], chunk)
    return ~d, v


def _is_null(e: Call, chunk) -> Pair:
    _, v = eval_expr(e.args[0], chunk)
    return ~v, torch.ones_like(v)


def _is_not_null(e: Call, chunk) -> Pair:
    _, v = eval_expr(e.args[0], chunk)
    return v, torch.ones_like(v)


def _safe_divisor(db):
    zero = db == 0
    return zero, torch.where(zero, torch.ones_like(db), db)


def _div(e: Call, chunk) -> Pair:
    a, b = e.args
    (da, va), (db, vb) = eval_expr(a, chunk), eval_expr(b, chunk)
    da = _to_kind(da, a.type_, e.type_)
    db = _to_kind(db, b.type_, e.type_)
    zero, safe = _safe_divisor(db)
    return _true_div(da, safe), va & vb & ~zero  # x/0 -> NULL (MySQL)


def _intdiv(e: Call, chunk) -> Pair:
    a, b = e.args
    (da, va), (db, vb) = eval_expr(a, chunk), eval_expr(b, chunk)
    zero, safe = _safe_divisor(db)
    if e.type_.kind == TypeKind.FLOAT:
        q = torch.trunc(_f64(da) / _f64(safe))
    else:
        q = _tdiv(da.to(torch.int64), safe.to(torch.int64))
    return q, va & vb & ~zero


def _mod(e: Call, chunk) -> Pair:
    a, b = e.args
    (da, va), (db, vb) = eval_expr(a, chunk), eval_expr(b, chunk)
    # align operands on the result representation (decimal scale / float)
    da = _to_kind(da, a.type_, e.type_)
    db = _to_kind(db, b.type_, e.type_)
    zero, safe = _safe_divisor(db)
    # MySQL MOD takes the sign of the dividend (C semantics), not python's
    if e.type_.kind == TypeKind.FLOAT:
        r = da - torch.trunc(da / safe) * safe
    else:
        r = da - _tdiv(da, safe) * safe
    return r, va & vb & ~zero


def _neg(e: Call, chunk) -> Pair:
    d, v = eval_expr(e.args[0], chunk)
    return -d, v


def _strict1(op, cast_float=False):
    def fn(e: Call, chunk) -> Pair:
        a = e.args[0]
        d, v = eval_expr(a, chunk)
        if cast_float:
            d = _to_kind(d, a.type_, e.type_)
        return op(d), v

    return fn


def _coalesce(e: Call, chunk) -> Pair:
    out = None
    for a in e.args:
        d, v = eval_expr(a, chunk)
        d = _to_kind(d, a.type_, e.type_)
        if out is None:
            out, ov = d, v
        else:
            out = torch.where(ov, out, d)
            ov = ov | v
    return out, ov


def _if(e: Call, chunk) -> Pair:
    c, t, f = e.args
    cd, cv = eval_expr(c, chunk)
    (td, tv), (fd, fv) = eval_expr(t, chunk), eval_expr(f, chunk)
    td = _to_kind(td, t.type_, e.type_)
    fd = _to_kind(fd, f.type_, e.type_)
    cond = cd & cv
    return torch.where(cond, td, fd), torch.where(cond, tv, fv)


def _ifnull(e: Call, chunk) -> Pair:
    a, b = e.args
    (da, va), (db, vb) = eval_expr(a, chunk), eval_expr(b, chunk)
    da = _to_kind(da, a.type_, e.type_)
    db = _to_kind(db, b.type_, e.type_)
    return torch.where(va, da, db), va | vb


def _nullif(e: Call, chunk) -> Pair:
    a, b = e.args
    (da, va), (db, vb) = eval_expr(a, chunk), eval_expr(b, chunk)
    eq = (da == db) & va & vb
    return da, va & ~eq


def _temporal_extract(which):
    def fn(e: Call, chunk) -> Pair:
        a = e.args[0]
        d, v = eval_expr(a, chunk)
        days = _days(d, a.type_)
        y, m, dd = dates.civil_from_days(days)
        if which == "quarter":
            out = _fdiv(m - 1, 3) + 1
        elif which == "dayofweek":
            # 1970-01-01 was a Thursday; MySQL: 1=Sunday .. 7=Saturday
            out = torch.remainder(days + 4, 7) + 1
        elif which == "weekday":
            # MySQL WEEKDAY(): 0=Monday .. 6=Sunday
            out = torch.remainder(days + 3, 7)
        elif which == "dayofyear":
            out = days - dates.days_from_civil(y, torch.ones_like(m), torch.ones_like(dd)) + 1
        else:
            out = {"year": y, "month": m, "day": dd}[which]
        return out.to(torch.int64), v

    return fn


def _time_extract(which):
    """HOUR/MINUTE/SECOND/MICROSECOND over DATETIME micros (0 for DATE)."""

    def fn(e: Call, chunk) -> Pair:
        a = e.args[0]
        d, v = eval_expr(a, chunk)
        if a.type_.kind == TypeKind.TIME:
            # durations: HOUR('-120:30:00') = 120 (magnitude, unbounded)
            mag = d.to(torch.int64).abs()
            div, mod_ = {
                "hour": (3_600_000_000, None),
                "minute": (60_000_000, 60),
                "second": (1_000_000, 60),
                "microsecond": (1, 1_000_000),
            }[which]
            out = _fdiv(mag, div)
            return (out if mod_ is None else torch.remainder(out, mod_)), v
        if a.type_.kind != TypeKind.DATETIME:
            return torch.zeros_like(d, dtype=torch.int64), v
        micros = d.to(torch.int64)
        div, mod_ = {
            "hour": (3_600_000_000, 24),
            "minute": (60_000_000, 60),
            "second": (1_000_000, 60),
            "microsecond": (1, 1_000_000),
        }[which]
        return torch.remainder(_fdiv(micros, div), mod_), v

    return fn


def _week(e: Call, chunk) -> Pair:
    """WEEK(d) mode 0 (MySQL default): Sunday-first; week 1 starts at the
    first Sunday of the year, earlier days are week 0."""
    a = e.args[0]
    d, v = eval_expr(a, chunk)
    days = _days(d, a.type_)
    y, _, _ = dates.civil_from_days(days)
    jan1 = dates.days_from_civil(y, torch.ones_like(y), torch.ones_like(y))
    dow_jan1 = torch.remainder(jan1 + 4, 7)  # 0=Sunday
    first_sunday = jan1 + torch.remainder(7 - dow_jan1, 7)
    wk = torch.where(days < first_sunday, torch.zeros_like(days),
                     _fdiv(days - first_sunday, 7) + 1)
    return wk.to(torch.int64), v


def _iso_week(e: Call, chunk) -> Pair:
    """WEEKOFYEAR(d) = ISO-8601 week number (MySQL WEEK(d, 3)): Monday
    first, week 1 contains Jan 4. Handles the year-boundary weeks."""
    a = e.args[0]
    d, v = eval_expr(a, chunk)
    days = _days(d, a.type_)
    y, _, _ = dates.civil_from_days(days)

    def week1_monday(year):
        jan4 = dates.days_from_civil(year, torch.full_like(year, 1),
                                     torch.full_like(year, 4))
        return jan4 - torch.remainder(jan4 + 3, 7)  # Monday on/before Jan 4

    w_this, w_next, w_prev = week1_monday(y), week1_monday(y + 1), week1_monday(y - 1)
    wk = torch.where(
        days >= w_next, torch.ones_like(days),
        torch.where(days < w_this,
                    _fdiv(days - w_prev, 7) + 1,
                    _fdiv(days - w_this, 7) + 1))
    return wk.to(torch.int64), v


_DAYS_0000 = 719_528  # days from year 0 ("0000-01-01") to 1970-01-01


def _to_days(e: Call, chunk) -> Pair:
    a = e.args[0]
    d, v = eval_expr(a, chunk)
    return _days(d, a.type_) + _DAYS_0000, v


def _from_days(e: Call, chunk) -> Pair:
    d, v = eval_expr(e.args[0], chunk)
    return (d.to(torch.int64) - _DAYS_0000).to(torch.int32), v


def _last_day(e: Call, chunk) -> Pair:
    """LAST_DAY(d): the final day of d's month, as a DATE."""
    a = e.args[0]
    d, v = eval_expr(a, chunk)
    days = _days(d, a.type_)
    y, m, _ = dates.civil_from_days(days)
    one = torch.ones_like(m)
    next_start = dates.days_from_civil(
        torch.where(m == 12, y + 1, y), torch.where(m == 12, one, m + 1), one)
    return (next_start - 1).to(torch.int32), v


def _unix_timestamp(e: Call, chunk) -> Pair:
    a = e.args[0]
    d, v = eval_expr(a, chunk)
    if a.type_.kind == TypeKind.DATE:
        return d.to(torch.int64) * 86_400, v
    return _fdiv(d.to(torch.int64), 1_000_000), v


def _from_unixtime(e: Call, chunk) -> Pair:
    d, v = eval_expr(e.args[0], chunk)
    return d.to(torch.int64) * 1_000_000, v


def _tsdiff_months(e: Call, chunk) -> Pair:
    """TIMESTAMPDIFF(MONTH, a, b): whole months from a to b, boundary-
    aware the MySQL way — the raw (y,m) delta, minus one when b's
    (day, time-of-day) hasn't reached a's yet (symmetrically for
    negative spans)."""
    a, b = e.args

    def decompose(x):
        d, v = eval_expr(x, chunk)
        if x.type_.kind == TypeKind.DATETIME:
            micros = d.to(torch.int64)
            days = _fdiv(micros, 86_400_000_000)
            tod = micros - days * 86_400_000_000
        else:
            days = d.to(torch.int64)
            tod = torch.zeros_like(days)
        y, m, dd = dates.civil_from_days(days)
        return y, m, dd, tod, v

    ya, ma, da, ta, va = decompose(a)
    yb, mb, db, tb, vb = decompose(b)
    months = (yb - ya) * 12 + (mb - ma)
    # fractional-month adjustment toward zero
    frac_b = db * 86_400_000_000 + tb
    frac_a = da * 86_400_000_000 + ta
    months = torch.where((months > 0) & (frac_b < frac_a), months - 1, months)
    months = torch.where((months < 0) & (frac_b > frac_a), months + 1, months)
    return months.to(torch.int64), va & vb


def _time_to_sec(e: Call, chunk) -> Pair:
    a = e.args[0]
    d, v = eval_expr(a, chunk)
    micros = d.to(torch.int64)
    if a.type_.kind == TypeKind.DATETIME:
        # seconds OF DAY, not epoch seconds
        micros = torch.remainder(micros, 86_400_000_000)
    # truncate toward zero (MySQL drops fractional seconds)
    return _tdiv(micros, 1_000_000), v


# MySQL TIME range: +-838:59:59
_TIME_MAX_SECS = 838 * 3600 + 59 * 60 + 59


def _sec_to_time(e: Call, chunk) -> Pair:
    d, v = eval_expr(e.args[0], chunk)
    secs = d.to(torch.int64).clamp(-_TIME_MAX_SECS, _TIME_MAX_SECS)
    return secs * 1_000_000, v


def _makedate(e: Call, chunk) -> Pair:
    """MAKEDATE(year, dayofyear): day 0 or negative -> NULL (MySQL)."""
    y, vy = eval_expr(e.args[0], chunk)
    dn, vd = eval_expr(e.args[1], chunk)
    y = y.to(torch.int64)
    dn = dn.to(torch.int64)
    jan1 = dates.days_from_civil(y, torch.ones_like(y), torch.ones_like(y))
    out = (jan1 + dn - 1).to(torch.int32)
    return out, vy & vd & (dn >= 1)


def _addtime(sign: int):
    def fn(e: Call, chunk) -> Pair:
        a, b = e.args
        (da, va), (db, vb) = eval_expr(a, chunk), eval_expr(b, chunk)
        out = da.to(torch.int64) + sign * db.to(torch.int64)
        return out, va & vb

    return fn


def _add_months(e: Call, chunk) -> Pair:
    """date/datetime + N months with end-of-month clamping (the device
    path for +/- INTERVAL MONTH/QUARTER/YEAR on column dates)."""
    a, n_lit = e.args
    d, v = eval_expr(a, chunk)
    n = int(n_lit.value)
    if a.type_.kind == TypeKind.DATETIME:
        micros = d.to(torch.int64)
        days = _fdiv(micros, 86_400_000_000)
        tod = micros - days * 86_400_000_000
    else:
        days = d.to(torch.int64)
        tod = None
    y, m, dd = dates.civil_from_days(days)
    total = y * 12 + (m - 1) + n
    ny = _fdiv(total, 12)
    nm = total - ny * 12 + 1
    one = torch.ones_like(dd)
    month_start = dates.days_from_civil(ny, nm, one)
    next_start = dates.days_from_civil(
        torch.where(nm == 12, ny + 1, ny), torch.where(nm == 12, one, nm + 1), one)
    dd = torch.minimum(dd, next_start - month_start)
    out_days = month_start + dd - 1
    if tod is not None:
        return out_days * 86_400_000_000 + tod, v
    return out_days, v


def _nary_extreme(pick):
    """GREATEST/LEAST: strict (NULL if any arg NULL), over the common
    type the binder computed for the Call."""

    def fn(e: Call, chunk) -> Pair:
        rt = e.type_
        acc_d = acc_v = None
        for a in e.args:
            d, v = eval_expr(a, chunk)
            if rt.kind == TypeKind.DECIMAL and a.type_.kind == TypeKind.DECIMAL:
                d = _rescale(d, a.type_.scale, rt.scale)
            elif rt.kind == TypeKind.DECIMAL:
                d = d.to(torch.int64) * 10**rt.scale
            elif rt.kind == TypeKind.FLOAT:
                d = _to_kind(d, a.type_, rt)
            if acc_d is None:
                acc_d, acc_v = d, v
            else:
                acc_d, acc_v = pick(acc_d, d), acc_v & v
        return acc_d, acc_v

    return fn


def _ushift(left: bool):
    """MySQL shifts are on BIGINT UNSIGNED: logical (zero-fill) on the
    64-bit pattern, and counts >= 64 are defined to give 0. torch's `>>`
    on int64 is arithmetic, so the right shift masks off the sign fill."""

    def f(a, b):
        a = a.to(torch.int64)
        bi = b.to(torch.int64)
        # the count is BIGINT UNSIGNED too: a negative count wraps to
        # >= 2^63, which is >= 64 -> zero
        cnt = torch.where(bi < 0, torch.full_like(bi, 64), bi.clamp(0, 64))
        s = cnt.clamp(max=63)
        if left:
            out = a << s
        else:
            # keep the low (64 - s) bits of the arithmetic shift
            keep = (torch.ones_like(a) << (64 - s.clamp(min=1))) - 1
            out = torch.where(s == 0, a, (a >> s) & keep)
        return torch.where(cnt >= 64, torch.zeros_like(out), out)

    return f


def _ubitnot(a):
    return ~a.to(torch.int64)


def _sign(e: Call, chunk) -> Pair:
    d, v = eval_expr(e.args[0], chunk)
    return torch.sign(d).to(torch.int64), v


def _round(e: Call, chunk) -> Pair:
    a = e.args[0]
    nd = 0
    if len(e.args) > 1:
        lit = e.args[1]
        if not isinstance(lit, Literal):
            raise PlanError("ROUND digits must be a constant")
        nd = int(lit.value)
    d, v = eval_expr(a, chunk)
    if a.type_.kind == TypeKind.DECIMAL:
        out = _rescale(d, a.type_.scale, nd)
        out = _rescale(out, nd, e.type_.scale)
        return out, v
    f = 10.0**nd
    scaled = _f64(d) * f
    return torch.where(scaled >= 0, torch.floor(scaled + 0.5),
                       torch.ceil(scaled - 0.5)) / f, v


FUNCS = {
    "add": _strict2(torch.add),
    "sub": _strict2(torch.sub),
    "mul": _strict2(torch.mul),
    "div": _div,
    "intdiv": _intdiv,
    "mod": _mod,
    "neg": _neg,
    "eq": _cmp(lambda a, b: a == b),
    "ne": _cmp(lambda a, b: a != b),
    "lt": _cmp(lambda a, b: a < b),
    "le": _cmp(lambda a, b: a <= b),
    "gt": _cmp(lambda a, b: a > b),
    "ge": _cmp(lambda a, b: a >= b),
    "and": _and,
    "or": _or,
    "not": _not,
    "nseq": _nseq,
    "is_null": _is_null,
    "is_not_null": _is_not_null,
    "truncate": _truncate,
    "coalesce": _coalesce,
    "if": _if,
    "ifnull": _ifnull,
    "nullif": _nullif,
    "abs": _strict1(torch.abs),
    "ceil": _strict1(torch.ceil, cast_float=True),
    "floor": _strict1(torch.floor, cast_float=True),
    "sqrt": _strict1(torch.sqrt, cast_float=True),
    "exp": _strict1(torch.exp, cast_float=True),
    "ln": _strict1(torch.log, cast_float=True),
    "log2": _strict1(torch.log2, cast_float=True),
    "log10": _strict1(torch.log10, cast_float=True),
    "sin": _strict1(torch.sin, cast_float=True),
    "cos": _strict1(torch.cos, cast_float=True),
    "pow": _strict2(torch.pow),
    "round": _round,
    "year": _temporal_extract("year"),
    "month": _temporal_extract("month"),
    "day": _temporal_extract("day"),
    "quarter": _temporal_extract("quarter"),
    "dayofweek": _temporal_extract("dayofweek"),
    "weekday": _temporal_extract("weekday"),
    "dayofyear": _temporal_extract("dayofyear"),
    "hour": _time_extract("hour"),
    "minute": _time_extract("minute"),
    "second": _time_extract("second"),
    "microsecond": _time_extract("microsecond"),
    "add_months": _add_months,
    "greatest": _nary_extreme(torch.maximum),
    "least": _nary_extreme(torch.minimum),
    "sign": _sign,
    "tan": _strict1(torch.tan, cast_float=True),
    "atan": _strict1(torch.atan, cast_float=True),
    "asin": _strict1(torch.asin, cast_float=True),
    "acos": _strict1(torch.acos, cast_float=True),
    "atan2": _strict2(torch.atan2),
    "radians": _strict1(torch.deg2rad, cast_float=True),
    "degrees": _strict1(torch.rad2deg, cast_float=True),
    "week": _week,
    "weekofyear": _iso_week,
    "to_days": _to_days,
    "from_days": _from_days,
    "last_day": _last_day,
    "unix_timestamp": _unix_timestamp,
    "from_unixtime": _from_unixtime,
    "tsdiff_months": _tsdiff_months,
    "time_to_sec": _time_to_sec,
    "sec_to_time": _sec_to_time,
    "makedate": _makedate,
    "addtime": _addtime(1),
    "subtime": _addtime(-1),
    "cot": _strict1(lambda x: 1.0 / torch.tan(x), cast_float=True),
    "sinh": _strict1(torch.sinh, cast_float=True),
    "cosh": _strict1(torch.cosh, cast_float=True),
    "tanh": _strict1(torch.tanh, cast_float=True),
    # MySQL bit ops are BIGINT UNSIGNED: ~ and >> operate on the 64-bit
    # pattern (logical shift, not arithmetic), and shift counts >= 64
    # are defined to produce 0
    "bitand": _strict2(torch.bitwise_and),
    "bitor": _strict2(torch.bitwise_or),
    "bitxor": _strict2(torch.bitwise_xor),
    "shl": _strict2(_ushift(left=True)),
    "shr": _strict2(_ushift(left=False)),
    "bitnot": _strict1(_ubitnot),
}
