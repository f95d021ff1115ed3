"""The port's columnar segment store (tidb_tpu_torch/columnar,
ops/segment_scan.py) against the JAX package's, on inputs made from a
numpy seed.

- `encode_column`: the same Encoding and the same stored bytes for int8,
  int16, int32, the raw-int64 fallback, all-NULL, empty, float, bool and
  dictionary codes.
- `decode_for` / `make_segment_scan_fn`: the same decoded columns as the
  reference's (run eagerly on the CPU), with and without `seg_stride`
  packing. Exact: integers decode exactly and floats stage raw.
- `collect_prune_bounds` / `segment_pruned`: the same bounds and verdicts,
  decimal-scale alignment included.
- A session with `tidb_tpu_segment_rows = 1024` gives the reference's rows
  for range scans that prune, for the delta tail before and past the
  fold threshold, and with `tidb_tpu_columnar_enable = 0`.
- The repairs: `data_epoch` moves on a dictionary re-encode and the store
  rebuilds (a port of tests/test_columnar.py's
  test_epoch_invalidation_on_dict_growth); int8/int16 map to torch dtypes.

Tolerances: exact everywhere (integers, decimals and raw floats)."""

import numpy as np
import pytest
import torch

from tidb_tpu.columnar import encoding as jenc
from tidb_tpu.columnar import zonemap as jzm
from tidb_tpu.expression import expr as jexpr
from tidb_tpu.ops import segment_scan as jscan
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.types import SQLType as JType
from tidb_tpu.types import TypeKind as JKind
from tidb_tpu_torch.columnar import compaction
from tidb_tpu_torch.columnar import encoding as penc
from tidb_tpu_torch.columnar import store as pstore
from tidb_tpu_torch.columnar import zonemap as pzm
from tidb_tpu_torch.expression import expr as pexpr
from tidb_tpu_torch.ops import segment_scan as pscan
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.types import SQLType as PType
from tidb_tpu_torch.types import TypeKind as PKind
from tidb_tpu_torch.utils.device import torch_dtype

from test_torch_session import _same, reference_witness_paused  # noqa: F401

# (kind, precision, scale) of the types the cases use
TYPES = {"int": ("INT", None, None), "dec2": ("DECIMAL", 10, 2),
         "dec3": ("DECIMAL", 10, 3), "date": ("DATE", None, None),
         "float": ("FLOAT", None, None), "bool": ("BOOL", None, None),
         "str": ("STRING", None, None)}


def _types(name):
    kind, p, s = TYPES[name]
    kw = {} if p is None else {"precision": p, "scale": s}
    return JType(JKind[kind], **kw), PType(PKind[kind], **kw)


def _encode_case(name, rng):
    """(type name, data, valid) of one encode_column case."""
    n = 500
    ones = np.ones(n, dtype=np.bool_)
    if name == "int8":
        return "int", rng.integers(1000, 1100, n).astype(np.int64), rng.random(n) < 0.9
    if name == "int16":
        return "dec2", rng.integers(-4000, 4000, n).astype(np.int64), ones
    if name == "int32":
        return "int", rng.integers(-(1 << 20), 1 << 20, n).astype(np.int64), ones
    if name == "raw_int64":
        info = np.iinfo(np.int64)
        d = rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)
        d[:2] = (info.min, info.max)
        return "int", d, ones
    if name == "all_null":
        return "int", rng.integers(0, 9, n).astype(np.int64), np.zeros(n, dtype=np.bool_)
    if name == "empty":
        return "int", np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.bool_)
    if name == "date":
        return "date", rng.integers(8000, 10000, n).astype(np.int32), ones
    if name == "float":
        return "float", rng.standard_normal(n), rng.random(n) < 0.8
    if name == "bool":
        return "bool", rng.random(n) < 0.5, ones
    if name == "dict":
        return "str", rng.integers(0, 40, n).astype(np.int32), rng.random(n) < 0.95
    raise KeyError(name)


ENCODE_CASES = ["int8", "int16", "int32", "raw_int64", "all_null", "empty",
                "date", "float", "bool", "dict"]


@pytest.mark.parametrize("name", ENCODE_CASES)
def test_encode_column_matches_jax(name):
    tname, data, valid = _encode_case(name, np.random.default_rng(len(name)))
    jt, pt = _types(tname)
    want_enc, want = jenc.encode_column(data, valid, jt)
    got_enc, got = penc.encode_column(data, valid, pt)
    assert (got_enc.kind, got_enc.dtype, got_enc.ref) == \
        (want_enc.kind, want_enc.dtype, want_enc.ref)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert np.array_equal(penc.decode_host(got_enc, got, pt)[valid],
                          jenc.decode_host(want_enc, want, jt)[valid])


def test_narrow_dtypes_map_to_torch():
    """A frame-of-reference payload is staged in its own width."""
    assert torch_dtype(np.int8) is torch.int8
    assert torch_dtype(np.int16) is torch.int16
    # and no column's device dtype is float32 (FLOAT columns are float64)
    for kind in PKind:
        assert torch_dtype(PType(kind).np_dtype) is not torch.float32, kind


# -- decode + scan pipeline ---------------------------------------------------

SCAN_COLS = [("u_a", "int"), ("u_m", "dec2"), ("u_d", "date"), ("u_f", "float"),
             ("u_b", "bool"), ("u_c", "str")]


def _ir(mod, which):
    """The same pushed filter in either package's IR: u_m >= 1.25 and
    u_d < 9000 and u_f is not null."""
    t = _types
    i = 0 if which == "jax" else 1
    boolean = t("bool")[i]
    return mod.Call(type_=boolean, op="and", args=(
        mod.Call(type_=boolean, op="and", args=(
            mod.Call(type_=boolean, op="ge", args=(
                mod.ColumnRef(type_=t("dec2")[i], name="u_m"),
                mod.Literal(type_=t("dec2")[i], value=125))),
            mod.Call(type_=boolean, op="lt", args=(
                mod.ColumnRef(type_=t("date")[i], name="u_d"),
                mod.Literal(type_=t("date")[i], value=9000))))),
        mod.Call(type_=boolean, op="is_not_null", args=(
            mod.ColumnRef(type_=t("float")[i], name="u_f"),))))


def _segments(rng, k, rows):
    """k encoded segments of `rows` rows each: per column, a list of
    (Encoding, stored, valid)."""
    segs = []
    for j in range(k):
        seg = {}
        for uid, tname in SCAN_COLS:
            _jt, pt = _types(tname)
            n = rows
            if tname == "int":
                d = rng.integers(-50 * (j + 1), 50 * (j + 1), n).astype(np.int64)
            elif tname == "dec2":
                d = rng.integers(-20000, 20000 * (j + 1) ** 3, n).astype(np.int64)
            elif tname == "date":
                d = rng.integers(8500, 9500, n).astype(np.int32)
            elif tname == "float":
                d = rng.standard_normal(n)
            elif tname == "bool":
                d = rng.random(n) < 0.5
            else:
                d = rng.integers(0, 30, n).astype(np.int32)
            v = rng.random(n) < 0.9
            enc, stored = penc.encode_column(d, v, pt)
            seg[uid] = (enc, stored, v)
        segs.append(seg)
    return segs


def _batch(segs, stride, packed):
    """(data, valid, refs, sel) numpy inputs of one staged batch."""
    k = len(segs)
    data, valid, refs = {}, {}, {}
    for uid, _t in SCAN_COLS:
        dt = segs[0][uid][1].dtype
        for seg in segs[1:]:
            dt = np.promote_types(dt, seg[uid][1].dtype)
        d = np.zeros(k * stride, dtype=dt)
        v = np.zeros(k * stride, dtype=np.bool_)
        r = np.zeros(k, dtype=np.int64)
        any_for = False
        for j, seg in enumerate(segs):
            enc, stored, sv = seg[uid]
            d[j * stride:j * stride + len(stored)] = stored
            v[j * stride:j * stride + len(stored)] = sv
            if enc.kind == "for":
                r[j] = enc.ref
                any_for = True
        data[uid], valid[uid] = d, v
        if any_for:
            refs[uid] = r if packed else int(r[0])
    sel = np.zeros(k * stride, dtype=np.bool_)
    for j, seg in enumerate(segs):
        sel[j * stride:j * stride + len(seg[SCAN_COLS[0][0]][1]) - 3] = True
    return data, valid, refs, sel


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("with_filter", [False, True])
def test_segment_scan_matches_jax(packed, with_filter):
    rng = np.random.default_rng(7 + packed + 2 * with_filter)
    stride = 256
    segs = _segments(rng, 4 if packed else 1, 200)
    data, valid, refs, sel = _batch(segs, stride, packed)
    jtypes = [(u, _types(t)[0]) for u, t in SCAN_COLS]
    ptypes = [(u, _types(t)[1]) for u, t in SCAN_COLS]
    jstages = [("filter", _ir(jexpr, "jax"))] if with_filter else []
    pstages = [("filter", _ir(pexpr, "port"))] if with_filter else []
    stride_arg = stride if packed else None
    want = jscan.make_segment_scan_fn(jstages, jtypes, seg_stride=stride_arg)(
        data, valid, refs, sel)
    got = pscan.make_segment_scan_fn(pstages, ptypes, seg_stride=stride_arg)(
        {u: torch.from_numpy(a) for u, a in data.items()},
        {u: torch.from_numpy(a) for u, a in valid.items()},
        {u: torch.from_numpy(r) if isinstance(r, np.ndarray) else r
         for u, r in refs.items()},
        torch.from_numpy(sel))
    assert np.array_equal(got.sel.numpy(), np.asarray(want.sel))
    for uid, _t in SCAN_COLS:
        wd = np.asarray(want.columns[uid].data)
        gd = got.columns[uid].data.numpy()
        assert gd.dtype == wd.dtype, uid
        assert gd.tobytes() == wd.tobytes(), uid
        assert np.array_equal(got.columns[uid].valid.numpy(),
                              np.asarray(want.columns[uid].valid)), uid
    if packed:
        assert any(np.asarray(refs[u]).ndim == 1 for u in refs)


def test_decode_for_matches_jax():
    rng = np.random.default_rng(3)
    d = rng.integers(-100, 100, 64).astype(np.int8)
    for ref, np_dtype in ((12345, np.int64), (-7, np.int32), (None, np.int64),
                          (None, np.int8)):
        want = np.asarray(jscan.decode_for(d, ref, np_dtype))
        got = pscan.decode_for(torch.from_numpy(d), ref, np_dtype).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want)


# -- zone maps and pruning ----------------------------------------------------

def _cond(mod, which, case):
    i = 0 if which == "jax" else 1
    b = _types("bool")[i]
    if case == "dec_scale":  # col DECIMAL(2) >= literal DECIMAL(3) 0.055
        return mod.Call(type_=b, op="ge", args=(
            mod.ColumnRef(type_=_types("dec2")[i], name="u_m"),
            mod.Literal(type_=_types("dec3")[i], value=55)))
    if case == "flipped":  # 100 > a, i.e. a < 100
        return mod.Call(type_=b, op="gt", args=(
            mod.Literal(type_=_types("int")[i], value=100),
            mod.ColumnRef(type_=_types("int")[i], name="u_a")))
    if case == "in":
        return mod.InList(type_=b, arg=mod.ColumnRef(type_=_types("int")[i], name="u_a"),
                          values=(99, 205, None))
    if case == "null_lit":
        return mod.Call(type_=b, op="eq", args=(
            mod.ColumnRef(type_=_types("int")[i], name="u_a"),
            mod.Literal(type_=_types("int")[i], value=None)))
    if case == "float_on_int":  # contributes no bound
        return mod.Call(type_=b, op="eq", args=(
            mod.ColumnRef(type_=_types("int")[i], name="u_a"),
            mod.Literal(type_=_types("float")[i], value=150.0)))
    if case == "and_isnull":
        return mod.Call(type_=b, op="and", args=(
            mod.Call(type_=b, op="le", args=(
                mod.ColumnRef(type_=_types("int")[i], name="u_a"),
                mod.Literal(type_=_types("int")[i], value=210))),
            mod.Call(type_=b, op="is_null", args=(
                mod.ColumnRef(type_=_types("float")[i], name="u_f"),))))
    raise KeyError(case)


PRUNE_CASES = ["dec_scale", "flipped", "in", "null_lit", "float_on_int", "and_isnull"]


@pytest.mark.parametrize("case", PRUNE_CASES)
def test_prune_bounds_and_verdicts_match_jax(case):
    jmap = {"u_a": ("a", _types("int")[0]), "u_m": ("m", _types("dec2")[0]),
            "u_f": ("f", _types("float")[0])}
    pmap = {"u_a": ("a", _types("int")[1]), "u_m": ("m", _types("dec2")[1]),
            "u_f": ("f", _types("float")[1])}
    want = jzm.collect_prune_bounds(_cond(jexpr, "jax", case), jmap)
    got = pzm.collect_prune_bounds(_cond(pexpr, "port", case), pmap)
    assert [(b.col, b.kind, b.value, b.values, b.col_scale_mul) for b in got] == \
        [(b.col, b.kind, b.value, b.values, b.col_scale_mul) for b in want]
    rng = np.random.default_rng(11)
    for lo, hi in ((0, 6), (0, 7), (90, 99), (100, 200), (150, 260), (205, 206)):
        a = np.arange(lo, hi, dtype=np.int64)
        f = rng.standard_normal(len(a))
        fv = rng.random(len(a)) < 0.5
        cols = {"a": (a, np.ones(len(a), dtype=np.bool_)), "m": (a, np.ones(len(a), dtype=np.bool_)),
                "f": (f, fv)}
        jz = {n: jzm.build_zone_map(d, v) for n, (d, v) in cols.items()}
        pz = {n: pzm.build_zone_map(d, v) for n, (d, v) in cols.items()}
        assert pz == {n: pzm.ZoneMap(**z.__dict__) for n, z in jz.items()}
        assert pzm.segment_pruned(pz, got) == jzm.segment_pruned(jz, want), (case, lo, hi)


# -- sessions with small segments ---------------------------------------------

def _seg_pair(segment_rows=1024, delta_rows=1024, cap=1 << 12, n=10000, seed=5):
    """A JAX and a port Session holding the same table t(a, b, c, d)."""
    js, ps = JaxSession(chunk_capacity=cap), Session(chunk_capacity=cap, device="cpu")
    rng = np.random.default_rng(seed)
    a = np.arange(n, dtype=np.int64)  # clustered: zone maps prune ranges
    b = rng.integers(0, 1000, n).astype(np.int64)
    d = rng.integers(0, 100000, n).astype(np.int64)
    strs = [f"name{int(x) % 11}" for x in b]
    for s in (js, ps):
        s.execute(f"set tidb_tpu_segment_rows = {segment_rows}")
        s.execute(f"set tidb_tpu_segment_delta_rows = {delta_rows}")
        s.execute("create table t (a int, b int, c varchar(16), d decimal(10,2))")
        s.catalog.table("test", "t").insert_columns(
            {"a": a, "b": b, "d": d}, strings={"c": list(strs)})
    return js, ps


RANGE_SCANS = [
    "select count(*), sum(b), sum(d) from t where a < 1500",
    "select c, count(*), sum(d) from t where a >= 3000 and a <= 3100 group by c order by c",
    "select a, b, c from t where a in (5, 9000, 12000) order by a",
    "select count(*) from t where a > 20000",
    "select c, sum(b) from t group by c order by c",
]


def test_range_scans_prune_and_match_jax():
    js, ps = _seg_pair()
    for sql in RANGE_SCANS:
        s0 = dict(pstore.SCAN_SEGMENTS_TOTAL)
        got = ps.query(sql)
        _same(got, js.query(sql), ordered=True)
        if "where" in sql:
            assert pstore.SCAN_SEGMENTS_TOTAL["pruned"] > s0["pruned"], sql
    store = ps.catalog.table("test", "t")._segment_store
    assert store is not None and len(store.segments) == 10  # 10,000 rows / 1024


def test_delta_tail_before_and_past_threshold():
    js, ps = _seg_pair()
    sql = "select c, count(*), sum(b), sum(d) from t where a >= 9000 group by c order by c"
    _same(ps.query(sql), js.query(sql), ordered=True)
    store = ps.catalog.table("test", "t")._segment_store
    covered0 = store.covered
    rng = np.random.default_rng(9)
    for batch in (300, 900):  # 300 rows stay a raw tail; 1200 pass 1024
        a = np.arange(10000 + (0 if batch == 300 else 300), 10000 + (300 if batch == 300 else 1200),
                      dtype=np.int64)
        b = rng.integers(0, 1000, len(a)).astype(np.int64)
        d = rng.integers(0, 100000, len(a)).astype(np.int64)
        strs = [f"name{int(x) % 11}" for x in b]
        for s in (js, ps):
            s.catalog.table("test", "t").insert_columns(
                {"a": a, "b": b, "d": d}, strings={"c": list(strs)})
        _same(ps.query(sql), js.query(sql), ordered=True)
        if batch == 300:
            assert store.covered == covered0  # the delta merges raw
        else:
            # tidb_tpu_compaction is on: the background worker folds it
            assert compaction.default_worker().drain(30)
            assert store.covered == 11200  # folded into segments


def test_columnar_disable_matches():
    js, ps = _seg_pair()
    for s in (js, ps):
        s.execute("set tidb_tpu_columnar_enable = 0")
    s0 = dict(pstore.SCAN_SEGMENTS_TOTAL)
    for sql in RANGE_SCANS[:3]:
        _same(ps.query(sql), js.query(sql), ordered=True)
    assert pstore.SCAN_SEGMENTS_TOTAL == s0
    assert ps.catalog.table("test", "t")._segment_store is None


def test_epoch_invalidation_on_dict_growth():
    """A dictionary-growth re-encode rewrites stored codes in place: the
    store must rebuild, not decode stale codes."""
    js, ps = _seg_pair(segment_rows=2048, delta_rows=2048, cap=1 << 13)
    t = ps.catalog.table("test", "t")
    ps.query("select count(*) from t where a < 10")  # builds the store
    store = t._segment_store
    gen0 = store.generation
    epoch0 = t.data_epoch
    # 'aaaa' sorts before every 'nameN': every existing code shifts
    for s in (js, ps):
        s.execute("insert into t (a, b, c, d) values (30000, 1, 'aaaa', 1)")
    assert t.data_epoch > epoch0
    sql = "select c, count(*) from t group by c order by c"
    _same(ps.query(sql), js.query(sql), ordered=True)
    ps.query("select count(*) from t where a >= 0")
    assert t._segment_store.generation > gen0
