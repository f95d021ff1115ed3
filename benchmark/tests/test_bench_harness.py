"""The harness on the CPU: names found from files, the reference against
the program's rows at SF0.01, the work model, the modules a run loads,
and the command's refusals without a card or without the program."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from conftest import BENCH, ROOT
from harness import check, spec, tpchgen, traffic

SCALE = 0.01
SEED = 2 ** 31 + 12345  # the driver's seeds pass 32 signed bits
RUN = [sys.executable, os.path.join(BENCH, "run.py")]
CELL_SCRIPT = os.path.join(BENCH, "tests", "cpu_cell.py")


def bench():
    return spec.Benchmark(ROOT)


def cell_names():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


def test_every_name_in_benchmark_json_is_found_as_files():
    b = bench()
    for w in b.doc["workloads"]:
        cell = b.cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["name"] == w["traffic"]
        for q in cell.traffic["queries"]:
            query = spec.query(q)
            assert {"COLUMNS", "ORDER_BY", "draw", "reference"} <= set(dir(query.mod))
    for m in b.metrics:
        assert callable(spec.metric_reader(m.name).read), m.name
    for c in b.doc["configs"]:
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert spec.config(c["name"])["source"] == c["source"]
        assert sorted(spec.config(c["name"])["reduced"]) == sorted(c["reduced"])


def test_unknown_names_are_refused():
    with pytest.raises(spec.SpecError):
        bench().cell("no_such.cell")
    with pytest.raises(spec.SpecError):
        spec.query("q99")


def test_traffic_is_a_function_of_the_seed():
    cell = bench().cell("tpch_sf1_single.join_reports")
    a, b, c = traffic.plan(cell, SEED), traffic.plan(cell, SEED), traffic.plan(cell, SEED + 1)
    assert a.streams == b.streams and a.sql == b.sql
    assert a.streams != c.streams
    assert len(a.streams) == cell.config["query_streams"]
    assert all(len(a.params[q]) == 3 for q in cell.traffic["queries"])
    # every round runs each query of the mix once
    first = a.streams[0][:3]
    assert sorted(traffic.untag(t)[0] for t in first) == sorted(cell.traffic["queries"])


@pytest.fixture(scope="module")
def loaded():
    """SF0.01 tables, and a CPU Session over the program's bulk load of them."""
    from harness import sut
    from tidb_tpu_torch.session import Session

    tables = tpchgen.generate(SCALE, SEED)
    catalog = sut.load(tables)
    return tables, Session(catalog=catalog, db=sut.DB, device="cpu")


def _all_statements():
    out = []
    for name in cell_names():
        cell = bench().cell(name)
        for tag in traffic.plan(cell, SEED, rounds=1).tags():
            out.append((name, tag))
    return out


@pytest.mark.parametrize("name,tag", _all_statements())
def test_reference_equals_the_programs_rows(loaded, name, tag):
    tables, sess = loaded
    plan = traffic.plan(bench().cell(name), SEED, rounds=1)
    q, i = traffic.untag(tag)
    mod = plan.queries[q].mod
    want, _work = mod.reference(tables, plan.params[q][i])
    rs = sess.execute(plan.sql[tag])
    got = [tuple(None if v is None else str(v) for v in r) for r in rs.rows]
    wrong, gap, why = check.judge(got, want, mod.COLUMNS, mod.ORDER_BY)
    assert not wrong, why
    assert gap <= check.AVG_GAP_LIMIT


def test_work_model_on_a_hand_worked_case():
    wb = spec.metric_reader("work_bytes")
    # 1,000 rows into an aggregation with 5 arguments and a group id, 4
    # groups of 8 outputs: (1,000 x 6 + 32) x 8 bytes
    assert wb.segagg({"agg": {"rows": 1000, "values": 6, "outputs": 32}, "joins": []}) \
        == 48_256
    # a 100-key build, a 5,000-key probe, 400 matches; then 400 against 20
    work = {"agg": None, "joins": [{"build": 100, "probe": 5000, "out": 400},
                                   {"build": 20, "probe": 400, "out": 400}]}
    assert wb.probe(work) == (100 + 5000 + 400 + 20 + 400 + 400) * 8
    assert wb.segagg(work) == 0


def test_reference_work_counts_are_the_data_s():
    tables = tpchgen.generate(SCALE, SEED)
    q6 = spec.query("q6").mod
    p = {"date": "1994-01-01", "discount": "0.06", "quantity": 24}
    _rows, work = q6.reference(tables, p)
    a = tables["lineitem"].arrays
    m = ((a["l_shipdate"] >= 8766) & (a["l_shipdate"] < 9131) & (a["l_discount"] >= 5)
         & (a["l_discount"] <= 7) & (a["l_quantity"] < 2400))
    assert work["agg"] == {"rows": int(m.sum()), "values": 1, "outputs": 1}
    rows, work = spec.query("q3").mod.reference(tables, {"segment": "BUILDING",
                                                        "date": "1995-03-15"})
    assert work["joins"][1]["out"] >= len(rows)


def test_generator_copy_matches_the_programs_loader_but_for_the_spec_keys():
    """One seed gives the program's own TPC-H data (its loader's draws),
    but for TPC-H clause 4.2.3's keys, which the program's loader does not
    follow: sparse order keys, no customer key divisible by 3, and each
    line's supplier one of its part's four in PARTSUPP."""
    from tidb_tpu_torch.storage.catalog import Catalog
    from tidb_tpu_torch.storage.tpch import load_tpch

    cat = Catalog()
    load_tpch(cat, sf=SCALE, seed=SEED)
    tables = tpchgen.generate(SCALE, SEED)
    prog = {name: cat.table("test", name) for name in tables}

    def col(name, c):
        t = prog[name]
        return np.asarray(t.data[c][:t.n])

    for name, cols in (("customer", ("c_custkey", "c_nationkey", "c_acctbal")),
                       ("supplier", ("s_suppkey", "s_nationkey", "s_acctbal")),
                       ("part", ("p_partkey", "p_retailprice")),
                       ("partsupp", ("ps_partkey", "ps_availqty", "ps_supplycost")),
                       ("orders", ("o_totalprice", "o_orderdate")),
                       ("lineitem", ("l_partkey", "l_linenumber", "l_quantity",
                                     "l_extendedprice", "l_discount", "l_shipdate"))):
        for c in cols:
            np.testing.assert_array_equal(col(name, c), tables[name].arrays[c], err_msg=c)
    seg = np.asarray(prog["customer"].dicts["c_mktsegment"].values, dtype=object)
    assert list(seg[col("customer", "c_mktsegment")]) == \
        list(tables["customer"].strings("c_mktsegment"))

    # the keys: the program's dense order key k is the spec's k-th sparse one
    dense = col("orders", "o_orderkey") - 1
    sparse = dense // 8 * 32 + dense % 8 + 1
    o, li = tables["orders"].arrays, tables["lineitem"].arrays
    np.testing.assert_array_equal(o["o_orderkey"], sparse)
    np.testing.assert_array_equal(li["l_orderkey"],
                                  sparse[col("lineitem", "l_orderkey") - 1])
    ncust, nsupp = len(tables["customer"].arrays["c_custkey"]), \
        len(tables["supplier"].arrays["s_suppkey"])
    assert (o["o_custkey"] % 3 != 0).all()
    assert o["o_custkey"].min() >= 1 and o["o_custkey"].max() <= ncust
    assert len(np.unique(o["o_custkey"])) > ncust // 2
    ps = tables["partsupp"].arrays
    pairs = set(zip(ps["ps_partkey"].tolist(), ps["ps_suppkey"].tolist()))
    assert len(pairs) == len(ps["ps_partkey"])
    assert set(zip(li["l_partkey"].tolist(), li["l_suppkey"].tolist())) <= pairs
    pk = ps["ps_partkey"]
    i = np.tile(np.arange(4), len(pk) // 4)
    np.testing.assert_array_equal(
        ps["ps_suppkey"], (pk + i * (nsupp // 4 + (pk - 1) // nsupp)) % nsupp + 1)


def _cpu_cell(workload, seconds, fault=None):
    args = [sys.executable, CELL_SCRIPT, workload, str(SEED), str(seconds), str(SCALE)]
    p = subprocess.run(args + ([fault] if fault else []), capture_output=True, text=True,
                       timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_its_clients_no_torch():
    out = _cpu_cell("tpch_sf1_single.join_reports", 3)
    assert out["result"]["correct"], out["result"]["checks"]
    assert out["found"] == []
    assert not {"jax", "jaxlib", "flax", "tidb_tpu"} & set(out["modules"])
    assert "tidb_tpu_torch" in out["modules"]
    assert not {"torch", "tidb_tpu_torch", "jax", "numpy"} & set(out["child_modules"])
    res = out["result"]
    assert list(res)[-1] == "checks"
    assert {"queries_per_s", "setup_s"} == set(res["metrics"])


def test_the_command_exits_nonzero_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run(RUN + ["--workload", "tpch_sf1_single.join_reports", "--seed", str(SEED),
                              "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_the_command_exits_nonzero_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "tpch_sf1_single.join_reports", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, timeout=300,
                       cwd=tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card):
    p = subprocess.run(RUN + ["--workload", "tpch_sf1_single.join_reports", "--seed", str(SEED),
                              "--seconds", "5", "--trace", "1"],
                       capture_output=True, text=True, timeout=1200, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["kind"] == card and res["device"]["busy_s"] > 0
