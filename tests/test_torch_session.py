"""SQL through the port's Session (tidb_tpu_torch, plain PyTorch on the CPU)
against the JAX package's Session on identical data, row for row.

Both engines get the same tables: the TPC-H tables the JAX generator made
are exported as numpy arrays and loaded into the port with
`tidb_tpu_torch.storage.tpch.load_arrays`; the small tables are created by
the same SQL in both. Rows compare with `rows_equal` (rel 1e-6 on numbers)
and then exactly: decimals are exact strings, and the port computes every
float (AVG) with the same float64 operations as the reference, so the rows
must also be equal as Python values."""

import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage.tpch import load_tpch as jax_load_tpch
from tidb_tpu.testutil import rows_equal
from tidb_tpu_torch.errors import ExecutionError
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage.table import ColumnInfo
from tidb_tpu_torch.storage.tpch import load_arrays
from tidb_tpu_torch.storage.tpch_queries import Q
from tidb_tpu_torch.types import SQLType, TypeKind

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The port's CPU path runs torch's intra-op OpenMP pool. Under pytest-xdist
# every worker process collects this module, and six workers each spinning
# eight OpenMP threads on an eight-core host slow a 64k-row torch.sort from
# about 1 ms to about 1 s; one thread per worker keeps the port's tests at
# their single-process speed. It only sets torch's pool (the reference does
# not use torch).
torch.set_num_threads(1)


@contextlib.contextmanager
def reference_witness_off():
    """The reference's runtime sanitizer (tidb_tpu/analysis/sanitizer.py),
    once a sanitized statement has turned it on, stays on for the whole
    process and records every tracked lock order, from every thread, into
    one graph that a later sanitized reference test checks for cycles. A
    port test that drives reference sessions must add nothing to it: the
    witness is off for the block and on again afterwards, with the graph
    and findings as they were."""
    from tidb_tpu.analysis import sanitizer as san

    was_on = san.enabled()
    if was_on:
        san.disable(reset_state=False)
    try:
        yield
    finally:
        if was_on:
            san.enable()


@pytest.fixture(autouse=True)
def reference_witness_paused():
    """Every port test that imports this fixture runs with the
    reference's lock-order witness off (reference_witness_off)."""
    with reference_witness_off():
        yield


def _port_type(t) -> SQLType:
    return SQLType(TypeKind[t.kind.name], t.precision, t.scale, t.members)


def _export_into(port_session, jax_table, name):
    """Copy one reference table's rows (device representation, validity,
    dictionaries) and its schema into the port's catalog: primary key,
    secondary indexes, CLUSTER BY column and watermark, partitioning,
    CHECK constraints, generated columns and foreign keys (whose parents
    must be exported first, under the same names)."""
    from tidb_tpu_torch.storage.table import PartitionInfo

    n = jax_table.n
    cols, arrays, valids, dicts = [], {}, {}, {}
    for c in jax_table.schema.columns:
        cols.append(ColumnInfo(c.name, _port_type(c.type_), not_null=c.not_null,
                               collation=c.collation))
        arrays[c.name] = np.asarray(jax_table.data[c.name][:n])
        valids[c.name] = np.asarray(jax_table.valid[c.name][:n])
        if c.name in jax_table.dicts:
            dicts[c.name] = list(jax_table.dicts[c.name].values)
    indexes = [(ix.name, list(ix.columns), ix.unique)
               for ix in jax_table.indexes.values() if ix.name != "PRIMARY"]
    pk = jax_table.schema.primary_key
    pi = jax_table.schema.partition
    part = None if pi is None else PartitionInfo(
        kind=pi.kind, column=pi.column, names=list(pi.names),
        uppers=list(pi.uppers), n_parts=pi.n_parts)
    return load_arrays(
        port_session.catalog, name, cols, arrays, valids, dicts,
        primary_key=list(pk) if pk else None, indexes=indexes,
        cluster_by=jax_table.schema.cluster_by,
        clustered_rows=jax_table.clustered_rows, partition=part,
        checks=[(c.name, c.sql) for c in jax_table.checks],
        generated=[(g.col, g.sql, g.stored) for g in jax_table.generated],
        foreign_keys=[(list(fk.columns), fk.parent.schema.name,
                       list(fk.parent_cols), fk.on_delete, fk.on_update)
                      for fk in jax_table.foreign_keys])


@pytest.fixture(scope="module")
def tpch_pair():
    js = JaxSession()
    jax_load_tpch(js.catalog, sf=0.01)
    ps = Session(device="cpu")
    for name in ("lineitem", "orders", "customer", "supplier", "nation", "region"):
        _export_into(ps, js.catalog.table("test", name), name)
    return js, ps


def _same(got, want, ordered):
    ok, msg = rows_equal(got, want, ordered=ordered)
    assert ok, msg
    if ordered:
        assert got == want
    else:
        key = lambda r: tuple((v is None, str(v)) for v in r)  # noqa: E731
        assert sorted(got, key=key) == sorted(want, key=key)


@pytest.mark.parametrize("q", ["q1", "q6"])
def test_tpch_matches_jax(tpch_pair, q):
    js, ps = tpch_pair
    want = js.query(Q[q][0])
    got = ps.query(Q[q][0])
    assert want, "reference returned no rows"
    _same(got, want, ordered=True)


def test_exported_strings_carry_across(tpch_pair):
    """Dictionary codes carry across with their dictionaries: a string
    GROUP BY over an exported column gives the reference's groups."""
    js, ps = tpch_pair
    sql = ("select c_mktsegment, count(*), sum(c_acctbal) from customer "
           "group by c_mktsegment order by c_mktsegment")
    _same(ps.query(sql), js.query(sql), ordered=True)


_SETUP = [
    "create table t (a bigint, b varchar(10), c decimal(10,2), d double, e date)",
    "insert into t values "
    "(1, 'x', 1.50, 0.5, '1995-01-01'), (2, 'y', -2.25, NULL, '1996-06-30'), "
    "(NULL, 'x', 3.00, 2.5, NULL), (4, NULL, NULL, -1.0, '1994-12-31'), "
    "(5, 'z', -7.75, 3.25, '1998-08-02'), (6, 'y', 0.01, NULL, '1995-01-01'), "
    "(NULL, NULL, -0.01, 0.0, '1992-02-29'), (8, 'x', 100.10, 7.0, '1997-03-15')",
]

_CASES = [
    # scan, filter and projection with NULL rows
    ("scan_nulls", "select a, b, c, d, e from t", False),
    ("filter_nulls", "select a, c from t where a > 1", False),
    ("is_null", "select a, b from t where b is null or a is null", False),
    ("projection", "select a * 2 + 1, c * 3, c + 1.005, d / 2, -a from t", False),
    ("date_pred", "select a from t where e >= date '1995-01-01' "
                  "and e < date '1995-01-01' + interval '2' year", False),
    # a string predicate on a literal absent from the dictionary
    ("absent_literal", "select a from t where b = 'nope'", False),
    ("absent_range", "select a, b from t where b < 'w' or b > 'zz'", False),
    # decimal SUM/AVG with negative values (segment and generic strategies)
    ("decimal_segment", "select b, sum(c), avg(c), count(c), count(*), min(c), "
                        "max(d) from t group by b", False),
    ("decimal_global", "select sum(c), avg(c), sum(d), count(*) from t", False),
    ("decimal_generic", "select a, sum(c), avg(c) from t group by a", False),
    ("having", "select b, sum(c) as s from t group by b having sum(c) > 0", False),
    # ORDER BY with NULLs, both directions, and LIMIT
    ("order_asc", "select a, b from t order by a, b", True),
    ("order_desc", "select b, c from t order by b desc, c desc", True),
    ("order_limit", "select a, d from t order by d desc, a limit 3", True),
    ("empty_global", "select count(*), sum(c) from t where a > 100", False),
]


@pytest.fixture(scope="module")
def small_pair():
    js = JaxSession()
    ps = Session(device="cpu")
    for sql in _SETUP:
        js.execute(sql)
        ps.execute(sql)
    return js, ps


@pytest.mark.parametrize("name,sql,ordered", _CASES, ids=[c[0] for c in _CASES])
def test_sql_matches_jax(small_pair, name, sql, ordered):
    js, ps = small_pair
    _same(ps.query(sql), js.query(sql), ordered)


def test_port_imports_neither_jax_nor_reference():
    """Every module of the port, and chip_smoke.py, imports without jax
    and without tidb_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import tidb_tpu_torch\n"
        "for m in pkgutil.walk_packages(tidb_tpu_torch.__path__, 'tidb_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'tidb_tpu' or m.startswith('tidb_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n"
    )
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "clean" in r.stdout


def test_session_defaults_to_cuda():
    if torch.cuda.is_available():
        assert Session().device.type == "cuda"
    else:
        with pytest.raises(ExecutionError, match="no CUDA device"):
            Session()


def test_q1_goes_through_the_segment_functions(tpch_pair, monkeypatch):
    """Q1's segment aggregation makes one segment_accumulate call per chunk
    with 16 accumulators and 23 outputs: 9 counts (occ + 8 cnt) and 7
    two-limb sums (4 decimal SUMs and 3 decimal AVGs). On the card that
    call is one tidb_segagg launch. SF0.01 is one chunk."""
    from tidb_tpu_torch import ops

    calls = []
    real = ops.segment_accumulate

    def accumulate(seg, G, sel, accs):
        calls.append([a.kind for a in accs])
        return real(seg, G, sel, accs)

    monkeypatch.setattr(ops, "segment_accumulate", accumulate)
    _js, ps = tpch_pair
    ps.query(Q["q1"][0])
    assert len(calls) == 1
    kinds = calls[0]
    assert {k: kinds.count(k) for k in set(kinds)} == {"count": 9, "limbs": 7}
    assert len(kinds) + kinds.count("limbs") == 23


# Expression parity: every scalar function family the compiler ports, over
# ints, decimals, floats, dates, datetimes and strings with a NULL row.
# Floats compare with rows_equal's rel 1e-6: XLA and torch's math
# libraries round a few transcendental results differently in the last bit.
_EXPR_SETUP = [
    "create table e (i bigint, j bigint, c decimal(12,3), f double, d date, "
    "t datetime, s varchar(20))",
    "insert into e values "
    "(7, 3, 12.345, 2.5, '2024-02-29', '2024-02-29 13:45:10', 'apple'), "
    "(-7, 2, -0.505, -1.25, '1970-01-01', '1969-12-31 23:59:59', 'Banana'), "
    "(0, -4, 999.999, 0.0, '1999-12-31', '2000-01-01 00:00:00', 'cherry'), "
    "(NULL, 5, NULL, NULL, NULL, NULL, NULL), "
    "(123456789, 0, -1000.001, 1e10, '1600-03-01', '2038-01-19 03:14:07', 'apple pie'), "
    "(-1, 64, 0.000, -0.5, '2000-02-28', '2000-03-01 12:00:00', '')",
]

_EXPRS = [
    'i + j', 'i - j', 'i * j', 'i / j', 'i div j', 'i % j', 'mod(i, j)',
    '-i', 'abs(i)', 'c + 1', 'c - f', 'c * 2', 'c * c', 'c / 3', 'c + i',
    'round(c)', 'round(c, 1)', 'round(f)', 'round(f, 1)', 'truncate(c, 1)',
    'truncate(f, 0)', 'ceil(c)', 'floor(c)', 'ceil(f)', 'floor(f)',
    'sign(c)', 'sign(i)', 'sqrt(abs(f))', 'pow(f, 2)', 'exp(f / 1e10)',
    'ln(abs(f) + 1)', 'log2(abs(i) + 1)', 'log10(abs(i) + 1)', 'sin(f)',
    'cos(f)', 'greatest(i, j)', 'least(i, j)', 'greatest(c, f)',
    'coalesce(i, j)', 'coalesce(c, f)', 'ifnull(i, 99)', 'nullif(i, 7)',
    'if(i > j, i, j)',
    "case when i > 0 then 'pos' when i < 0 then 'neg' else 'zero' end",
    'case i when 7 then c else f end', 'i in (7, 0, 5)', 'i not in (7, 0)',
    'i between -1 and 10', 'i & j', 'i ', ' j', 'i ^ j', 'i << 2', 'i >> 1',
    'j >> 70', '~i', 'year(d)', 'month(d)', 'day(d)', 'quarter(d)',
    'dayofweek(d)', 'weekday(d)', 'dayofyear(d)', 'week(d)', 'weekofyear(d)',
    'to_days(d)', 'last_day(d)', 'unix_timestamp(d)',
    "d + interval '1' month", "d - interval '3' day",
    "d + interval '1' year", 'hour(t)', 'minute(t)', 'second(t)', 'year(t)',
    "datediff(d, '2000-01-01')", "t + interval '90' minute", "s = 'apple'",
    "s < 'b'", "s like 'a%'", "s like '%an%'", 's is null', "s > 'zzz'",
    'upper(s)', 'length(s)', 'c = 12.345', 'c > f', 'f = 2.5', 'i = c',
    "d = '2024-02-29'", "d > '2000-01-01'", "t < '2000-01-01 00:00:00'",
    'not (i > 0)', 'i > 0 and j > 0', 'i > 0 or j > 0',
    'cast(f as decimal(10,2))', 'cast(i as double)', 'cast(c as double)',
    'cast(d as datetime)',
]


@pytest.fixture(scope="module")
def expr_pair():
    js = JaxSession()
    ps = Session(device="cpu")
    for sql in _EXPR_SETUP:
        js.execute(sql)
        ps.execute(sql)
    return js, ps


@pytest.mark.parametrize("expr", _EXPRS)
def test_expression_matches_jax(expr_pair, expr):
    js, ps = expr_pair
    sql = f"select {expr} from e"
    ok, msg = rows_equal(ps.query(sql), js.query(sql), ordered=True)
    assert ok, msg


def test_lookup_tables_upload_once_per_content():
    """A Lookup's table crosses to the device once per content: each plan
    builds its own tuple, and a chunk's gather must not copy it again."""
    from tidb_tpu_torch.expression import compiler

    dev = torch.device("cpu")
    a = tuple(float(i) for i in range(10))
    b = tuple(float(i) for i in range(10))
    assert a is not b
    ta = compiler._device_table(a, np.float64, dev)
    assert compiler._device_table(b, np.float64, dev) is ta
    assert compiler._device_table(a, np.float64, dev) is ta
    c = a[:-1] + (99.0,)
    tc = compiler._device_table(c, np.float64, dev)
    assert tc is not ta and tc.tolist() == list(c)
    assert compiler._device_table(a, np.int64, dev) is not ta
