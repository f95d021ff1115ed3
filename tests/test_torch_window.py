"""Window functions through the port (tidb_tpu_torch on the CPU) against
the JAX package: the SQL of tests/test_window.py and
tests/test_window_frames.py on both, over the same rows.

ROW_NUMBER / RANK / DENSE_RANK / NTILE, LAG / LEAD (offsets and
defaults), FIRST_VALUE / LAST_VALUE, COUNT / SUM / AVG / MIN / MAX over
MySQL's default frames and explicit ROWS and RANGE frames, windows over
an aggregate, in a derived table and under ORDER BY. Rows compare with
`rows_equal` (numbers within 1e-6 relative) and then exactly as Python
values, ordered where the SQL orders; refusals must agree in class and
message.
"""

import numpy as np
import pytest

from tidb_tpu.session import Session as JaxSession
from tidb_tpu_torch.session import Session

from test_torch_keys import both
from test_torch_session import _same, reference_witness_paused  # noqa: F401


def _pair(setup, chunk_capacity=None):
    js = JaxSession(chunk_capacity=chunk_capacity)
    js.execute("set tidb_tpu_compaction = 0")
    ps = Session(chunk_capacity=chunk_capacity, device="cpu")
    for sql in setup:
        both(js, ps, sql)
    return js, ps


def _w_rows():
    """tests/test_window.py's table: 300 rows, three groups, NULLs."""
    rng = np.random.default_rng(4)
    rows = []
    for i in range(300):
        g = ["a", "b", "c"][rng.integers(0, 3)]
        v = int(rng.integers(0, 40)) if rng.random() > 0.1 else None
        p = f"{rng.integers(0, 999) / 10:.2f}"
        rows.append(f"({i}, '{g}', {'null' if v is None else v}, {p})")
    return ["create table w (id bigint primary key, g varchar(4), v bigint, "
            "p decimal(8,2))", "insert into w values " + ", ".join(rows)]


@pytest.fixture(scope="module")
def w_pair():
    return _pair(_w_rows(), chunk_capacity=128)


WINDOW_QUERIES = [
    "select id, row_number() over (partition by g order by id) from w",
    "select id, rank() over (partition by g order by v) from w",
    "select id, dense_rank() over (partition by g order by v) from w",
    "select id, sum(v) over (partition by g) from w",
    "select id, sum(v) over (partition by g order by id) from w",
    "select id, sum(v) over (partition by g order by v) from w",
    "select id, count(*) over (partition by g) from w",
    "select id, count(v) over (partition by g order by id) from w",
    "select id, min(v) over (partition by g order by id) from w",
    "select id, max(v) over (partition by g) from w",
    "select id, avg(v) over (partition by g) from w",
    "select id, sum(p) over (partition by g order by id) from w",
    "select id, row_number() over (order by v desc, id) from w",
    "select id, min(g) over (order by id) from w",
    "select id, row_number() over (partition by g order by id),"
    " sum(v) over (partition by g) from w",
    "select g, sum(v) as sv, rank() over (order by sum(v) desc)"
    " from w group by g",
    "select id, row_number() over (partition by g order by id) * 10 as rn"
    " from w order by rn, id limit 20",
    "select id, lag(v) over (partition by g order by id) from w",
    "select id, lag(v, 2) over (partition by g order by id) from w",
    "select id, lag(v, 1, -1) over (partition by g order by id) from w",
    "select id, lead(v) over (partition by g order by id) from w",
    "select id, first_value(v) over (partition by g order by id) from w",
    "select id, last_value(v) over (partition by g order by id) from w",
    "select id, ntile(4) over (partition by g order by id) from w",
    "select id, lag(g) over (order by id) from w",
    "select id from (select id, row_number() over"
    " (partition by g order by id) as rn from w) d where rn <= 3",
    "select id, sum(v) over (partition by g) from w where id < 0",
    "select id, lag(g, 1, 'a') over (order by id) from w order by id limit 1",
    "select lag(p, 1, 9) over (order by id) from w order by id limit 1",
]

WINDOW_REFUSALS = [
    "select id from w where row_number() over (order by id) < 5",
    "select lag(g, 1, 'zzz') over (order by id) from w",
    "select lag(v, null) over (order by id) from w",
    "select ntile(null) over (order by id) from w",
    "select lag(v, -1) over (order by id) from w",
    "select first_value(v, 99) over (order by id) from w",
]


@pytest.mark.parametrize("sql", WINDOW_QUERIES)
def test_window_matches_reference(w_pair, sql):
    js, ps = w_pair
    want = js.query(sql)
    assert want or "id < 0" in sql
    _same(ps.query(sql), want, ordered=" order by " in sql.split(")")[-1])


@pytest.mark.parametrize("sql", WINDOW_REFUSALS)
def test_window_refusal_matches_reference(w_pair, sql):
    js, ps = w_pair
    assert both(js, ps, sql) is not None


# -- explicit frames (tests/test_window_frames.py) ----------------------------

def _frame_rows():
    rng = np.random.default_rng(9)
    rows = [(g, i, int(rng.integers(-20, 20))) for g in range(3) for i in range(50)]
    return ["create table w (g bigint, i bigint, v bigint)",
            "insert into w values " + ", ".join(f"({g},{i},{v})" for g, i, v in rows),
            "create table r (k bigint, v bigint)",
            "insert into r values (1,1),(1,2),(2,10),(3,4),(3,5),(3,6)"]


@pytest.fixture(scope="module")
def frame_pair():
    return _pair(_frame_rows())


_SPECS = ["rows between 2 preceding and 2 following",
          "rows between 4 preceding and 1 preceding",
          "rows between current row and 3 following",
          "rows between unbounded preceding and 1 following",
          "rows between 1 preceding and unbounded following",
          "rows 3 preceding"]

FRAME_QUERIES = [
    f"select g, i, sum(v) over (partition by g order by i {spec}) as sm, "
    f"count(*) over (partition by g order by i {spec}) as cn, "
    f"min(v) over (partition by g order by i {spec}) as mn, "
    f"max(v) over (partition by g order by i {spec}) as mx "
    f"from w order by g, i" for spec in _SPECS] + [
    "select g, i, avg(v) over (partition by g order by i "
    "rows between 3 preceding and 1 preceding) from w order by g, i",
    "select g, i, first_value(v) over (partition by g order by i "
    "  rows between 1 following and 3 following) as fv, "
    "last_value(v) over (partition by g order by i "
    "  rows between 2 preceding and 1 preceding) as lv from w order by g, i",
    "select k, v, sum(v) over (order by k range between unbounded preceding and "
    "  unbounded following) as whole, sum(v) over (order by k range between "
    "  current row and unbounded following) as rev, sum(v) over (order by k "
    "  range between current row and current row) as peers, min(v) over "
    "  (order by k range between current row and current row) as pmin "
    "from r order by k, v",
    "select g, i, min(v) over (partition by g order by i "
    "rows between 1000 preceding and 2 preceding) from w order by g, i",
    "select i, row_number() over (partition by g order by i "
    "rows between 1 preceding and current row) from w "
    "where g = 0 order by i limit 3",
]

FRAME_REFUSALS = [
    "select max(v) over (order by i rows unbounded following) from w",
    "select max(v) over (order by i rows between current row "
    "and unbounded preceding) from w",
    "select sum(v) over (order by i rows 1.5 preceding) from w",
    "select sum(v) over (order by i rows between current row "
    "and 2 preceding) from w",
    "select sum(v) over (order by i rows between 2 following "
    "and current row) from w",
    "select sum(v) over (order by i range between 1 preceding and current row) from w",
]


@pytest.mark.parametrize("sql", FRAME_QUERIES)
def test_frame_matches_reference(frame_pair, sql):
    js, ps = frame_pair
    want = js.query(sql)
    assert want
    _same(ps.query(sql), want, ordered=True)


@pytest.mark.parametrize("sql", FRAME_REFUSALS)
def test_frame_refusal_matches_reference(frame_pair, sql):
    js, ps = frame_pair
    assert both(js, ps, sql) == "ParseError"
