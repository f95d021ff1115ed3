"""LOAD DATA [LOCAL] INFILE and SELECT ... INTO OUTFILE through the port
(tidb_tpu_torch on the CPU) against the JAX package.

The cases of tests/test_load_data.py: every file is loaded by a
reference session and by a port session built alike (each writes its
OUTFILE to a path of its own), the statements succeed or fail alike,
and the loaded rows are the same. The file is the state both packages
carry, so the round trip crosses them too: the reference's OUTFILE
loads into the port and the port's into the reference, and both files
are byte for byte the same.
"""

import pytest

from tidb_tpu.session import Session as JaxSession
from tidb_tpu_torch.session import Session

from test_torch_keys import both, same_rows
from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)


class Pair:
    """A reference session and a port session: `run` gives each its own
    copy of every `{p}` path (OUTFILE refuses an existing file)."""

    def __init__(self, tmp_path):
        self.js = JaxSession()
        self.js.execute("set tidb_tpu_compaction = 0")
        self.ps = Session(device="cpu")
        self.tmp = tmp_path

    def path(self, name, who):
        return self.tmp / f"{who}_{name}"

    def write(self, name, text):
        for who in ("jax", "port"):
            self.path(name, who).write_text(text)

    def run(self, sql, name=None):
        """`sql` with `{p}` set to each session's own path of `name`;
        both must succeed or fail alike. Returns the two results."""
        outs, res = [], []
        for who, s in (("jax", self.js), ("port", self.ps)):
            q = sql.format(p=self.path(name, who)) if name else sql
            try:
                r = s.execute(q)
                res.append(None if r is None else r.rows)
                outs.append(None)
            except Exception as e:  # noqa: BLE001 — the class is the result
                res.append(None)
                outs.append(type(e).__name__)
        assert outs[0] == outs[1], (sql, outs)
        assert res[0] == res[1], (sql, res)
        return outs[1], res[1]

    def same(self, sql, ordered=True):
        same_rows(self.js, self.ps, sql, ordered=ordered)
        return self.ps.query(sql)


@pytest.fixture
def s(tmp_path):
    p = Pair(tmp_path)
    p.run("create table t (a bigint, s varchar(20), d double)")
    return p


def test_basic_tab_separated(s):
    s.write("t.tsv", "1\thello\t1.5\n2\tworld\t2.5\n")
    assert s.run("load data infile '{p}' into table t", "t.tsv") == (None, [(2,)])
    assert s.same("select a, s, d from t order by a") == [
        (1, "hello", 1.5), (2, "world", 2.5)]


def test_csv_options_and_nulls(s):
    s.write("t.csv", 'id,name,val\n1,"a,b",\\N\n2,,3.5\n\\N,x,\n')
    _e, rows = s.run(
        "load data infile '{p}' into table t "
        "fields terminated by ',' optionally enclosed by '\"' "
        "lines terminated by '\\n' ignore 1 lines", "t.csv")
    assert rows == [(3,)]
    # \N -> NULL everywhere; '' -> NULL for numerics, '' for strings
    assert s.same("select a, s, d from t order by a") == [
        (None, "x", None), (1, "a,b", None), (2, "", 3.5)]


def test_column_subset_and_defaults(s):
    s.run("create table u (id bigint auto_increment, v bigint, "
          "tag varchar(8) default 'none')")
    s.write("u.tsv", "10\n20\n30\n")
    s.run("load data infile '{p}' into table u (v)", "u.tsv")
    assert s.same("select id, v, tag from u order by id") == [
        (1, 10, "none"), (2, 20, "none"), (3, 30, "none")]


def test_unique_violation_rolls_back(s):
    s.run("create table pkt (k bigint primary key)")
    s.write("pk.tsv", "1\n2\n1\n")
    assert s.run("load data infile '{p}' into table pkt", "pk.tsv")[0] == "ExecutionError"
    # implicit txn rolled back: nothing half-loaded
    assert s.same("select count(*) from pkt") == [(0,)]


def _lines(n):
    return [f"{i}\tv{i % 7}\n" for i in range(n)]


def test_file_over_one_batch_loads_whole(s):
    """10,000 lines load in three 4,096-row batches under one
    transaction. The reference iterates the file and calls tell() after
    a batch, which a text file refuses (OSError past line 4,096: ROADMAP
    Queue C); the port reads by readline, and its rows equal the
    reference's load of the same lines in pieces under one batch."""
    lines = _lines(10_000)
    for eng in ("columnar", "delta"):
        s.run(f"create table big_{eng} (k bigint, v varchar(8)) engine={eng}")
        path = s.path(f"big_{eng}.tsv", "port")
        path.write_text("".join(lines))
        rs = s.ps.execute(f"load data infile '{path}' into table big_{eng}")
        assert rs.rows == [(10_000,)]
        with pytest.raises(OSError):
            s.js.execute(f"load data infile '{path}' into table big_{eng}")
        for k in range(0, len(lines), 4000):
            piece = s.path(f"big_{eng}_{k}.tsv", "jax")
            piece.write_text("".join(lines[k:k + 4000]))
            s.js.execute(f"load data infile '{piece}' into table big_{eng}")
        assert s.same(f"select count(*), sum(k), min(v), max(v) from big_{eng}") \
            == [(10_000, sum(range(10_000)), "v0", "v6")]
        s.same(f"select k, v from big_{eng} order by k")


def test_unique_violation_rolls_back_every_batch(s):
    """A duplicate in the last of three 4,096-row batches undoes the two
    batches already inserted under the statement's transaction; the
    delta engine writes a keyed table through, without buffering. (The
    reference stops at its first tell() with OSError instead, also with
    nothing loaded.)"""
    for eng in ("columnar", "delta"):
        s.run(f"create table pk_{eng} (k bigint primary key, v varchar(8)) "
              f"engine={eng}")
        path = s.path(f"pk_{eng}.tsv", "port")
        path.write_text("".join(_lines(10_000)) + "17\tdup\n")
        with pytest.raises(Exception) as ei:
            s.ps.execute(f"load data infile '{path}' into table pk_{eng}")
        assert type(ei.value).__name__ == "ExecutionError"
        assert "duplicate" in str(ei.value).lower()
        assert s.ps.query(f"select count(*) from pk_{eng}") == [(0,)]
        pt = s.ps.catalog.table("test", f"pk_{eng}")
        assert getattr(pt, "buffered_rows", 0) == 0
        assert pt.n == 0 or pt.live_rows == 0


def test_delta_engine_target(s):
    s.run("create table ev (a bigint, s varchar(12)) engine=delta")
    s.write("ev.tsv", "".join(f"{i}\ttag{i}\n" for i in range(500)))
    assert s.run("load data infile '{p}' into table ev", "ev.tsv")[1] == [(500,)]
    assert s.same("select count(*), min(s) from ev") == [(500, "tag0")]


def test_mysql_escape_semantics(s):
    """mysqldump-format escapes: \\t inside a field survives the split,
    \\\\ collapses, quoted 'N' is data while bare \\N is NULL."""
    s.write("esc.tsv", "1\ta\\tb\t1.0\n2\tc\\\\d\t2.0\n3\t\\N\t3.0\n")
    s.run("load data infile '{p}' into table t", "esc.tsv")
    assert s.same("select a, s from t order by a") == [
        (1, "a\tb"), (2, "c\\d"), (3, None)]


def test_quoted_N_is_data(s):
    s.write("qn.csv", '1,"N",1.0\n2,\\N,2.0\n')
    s.run("load data infile '{p}' into table t "
          "fields terminated by ',' enclosed by '\"'", "qn.csv")
    assert s.same("select a, s from t order by a") == [(1, "N"), (2, None)]


def test_multichar_delim_refused(s):
    s.write("x.tsv", "1||y||2.0\n")
    err, _ = s.run("load data infile '{p}' into table t "
                   "fields terminated by '||'", "x.tsv")
    assert err == "UnsupportedError"


def test_bool_zero_loads_false(s):
    s.run("create table bt (b boolean, x bigint)")
    s.write("b.tsv", "0\t1\n1\t2\nfalse\t3\ntrue\t4\n")
    s.run("load data infile '{p}' into table bt", "b.tsv")
    assert s.same("select b, x from bt order by x") == [
        (False, 1), (True, 2), (False, 3), (True, 4)]


def test_local_needs_only_insert(s):
    s.write("l.tsv", "7\tz\t1.0\n")
    s.run("create user 'carl'")
    s.run("grant insert on *.* to 'carl'")
    s.js.user = s.ps.user = "carl"
    try:
        assert s.run("load data local infile '{p}' into table t",
                     "l.tsv") == (None, [(1,)])
    finally:
        s.js.user = s.ps.user = "root"


def test_blank_line_is_empty_field_row(s):
    s.run("create table one (v varchar(8))")
    s.write("one.tsv", "a\n\nb\n")
    assert s.run("load data infile '{p}' into table one", "one.tsv")[1] == [(3,)]
    assert s.same("select v from one order by v") == [("",), ("a",), ("b",)]


def test_escape_table_delimiter_roundtrip(s):
    """Delimiter chars that collide with escape keys (t, n, 0...) must
    still round-trip: an escaped delimiter is the delimiter."""
    s.run("create table zt (v varchar(8), w bigint)")
    s.run("insert into zt values ('a0b', 1), ('plain', 2)")
    s.run("select v, w from zt into outfile '{p}' fields terminated by '0'",
          "z.txt")
    s.run("create table zt2 (v varchar(8), w bigint)")
    s.run("load data infile '{p}' into table zt2 fields terminated by '0'",
          "z.txt")
    assert s.same("select v, w from zt2 order by w") == [("a0b", 1), ("plain", 2)]


def test_nested_into_outfile_refused(s):
    err, _ = s.run("select a from t union select a from t into outfile '{p}'",
                   "n.tsv")
    assert err == "UnsupportedError"
    assert not s.path("n.tsv", "port").exists()
    assert not s.path("n.tsv", "jax").exists()


def test_into_outfile_roundtrip(s):
    """SELECT ... INTO OUTFILE writes the format LOAD DATA reads: every
    value — NULLs, embedded delimiters/newlines/backslashes — survives
    the round trip."""
    s.run("insert into t values (1, 'plain', 1.5), (2, NULL, NULL), "
          "(3, 'has\ttab', 2.5)")
    s.run("insert into t values (4, 'back\\\\slash', 3.5)")
    assert s.run("select a, s, d from t into outfile '{p}'",
                 "out.tsv") == (None, [(4,)])
    s.run("create table t2 (a bigint, s varchar(20), d double)")
    s.run("load data infile '{p}' into table t2", "out.tsv")
    assert s.same("select a, s, d from t2 order by a") == \
        s.same("select a, s, d from t order by a")
    # refuses to overwrite
    assert s.run("select a from t into outfile '{p}'", "out.tsv")[0] == "ExecutionError"


def test_into_outfile_csv_quoted(s):
    s.run("insert into t values (1, 'a,b', 1.0), (2, 'say \"hi\"', 2.0)")
    s.run("select a, s from t into outfile '{p}' "
          "fields terminated by ',' enclosed by '\"'", "out.csv")
    s.run("create table t3 (a bigint, s varchar(20))")
    s.run("load data infile '{p}' into table t3 "
          "fields terminated by ',' enclosed by '\"'", "out.csv")
    assert s.same("select a, s from t3 order by a") == [(1, "a,b"), (2, 'say "hi"')]


def test_requires_privileges(s):
    s.write("x.tsv", "1\ty\t2.0\n")
    s.run("create user 'bob'")
    s.run("grant insert on *.* to 'bob'")  # but not SUPER
    s.js.user = s.ps.user = "bob"
    try:
        assert s.run("load data infile '{p}' into table t", "x.tsv")[0] == \
            "PrivilegeError"
        assert s.run("select a from t into outfile '{p}'", "y.tsv")[0] == \
            "PrivilegeError"
    finally:
        s.js.user = s.ps.user = "root"


# -- the file crosses the packages ------------------------------------------

_ROUND = [
    "create table r (id bigint, name varchar(16), amt decimal(12,2), "
    "d date, f double, ok boolean)",
]


def _fill(pair, n=3000, seed=7):
    """n rows from a seed: strings with tabs, commas, quotes, backslashes
    and newlines, NULLs in every column, negative decimals."""
    import numpy as np

    rng = np.random.default_rng(seed)
    specials = ["plain", "tab\there", "comma,here", 'quo"te', "back\\\\slash",
                "new\\nline", "N", ""]
    rows = []
    for i in range(n):
        name = "NULL" if i % 11 == 0 else \
            "'" + specials[i % len(specials)] + str(i % 5) + "'"
        amt = "NULL" if i % 13 == 0 else f"{rng.integers(-10**6, 10**6) / 100:.2f}"
        d = "NULL" if i % 17 == 0 else \
            f"'{1992 + i % 7}-{1 + i % 12:02d}-{1 + i % 28:02d}'"
        f = "NULL" if i % 19 == 0 else repr(float(rng.normal()))
        ok = "NULL" if i % 23 == 0 else ("true" if i % 2 else "false")
        rows.append(f"({i}, {name}, {amt}, {d}, {f}, {ok})")
    for k in range(0, n, 500):
        pair.run("insert into r values " + ", ".join(rows[k:k + 500]))


@pytest.mark.parametrize("fmt", [
    "", "fields terminated by ',' enclosed by '\"'"])
def test_outfile_crosses_packages(s, fmt):
    """The reference's OUTFILE loads into the port and the port's into
    the reference, with the same rows as the source; both files are the
    same bytes."""
    for sql in _ROUND:
        s.run(sql)
    _fill(s)
    s.run(f"select * from r order by id into outfile '{{p}}' {fmt}", "r.out")
    jfile, pfile = s.path("r.out", "jax"), s.path("r.out", "port")
    assert jfile.read_bytes() == pfile.read_bytes()
    s.run("create table r2 like r")
    # each package loads the OTHER one's file
    s.js.execute(f"load data infile '{pfile}' into table r2 {fmt}")
    s.ps.execute(f"load data infile '{jfile}' into table r2 {fmt}")
    want = s.same("select * from r order by id")
    assert len(want) == 3000
    assert s.same("select * from r2 order by id") == want
