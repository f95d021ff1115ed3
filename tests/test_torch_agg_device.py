"""The port's device generic aggregation (tidb_tpu_torch/executor/agg_device.py)
against the reference's (tidb_tpu/executor/agg_device.py, jitted on the CPU)
on identical inputs made from a seed with numpy.

Each case builds one chunk per package from the same arrays, runs the
reference's make_partial_kernel / make_merge_kernel / GroupTableStack /
table_to_host_partial and the port's counterparts, and compares the group
tables slot by slot up to n. Keys (floats by bit pattern), validity, counts,
int, min/max and limb states and n are exact; float64 sums within rel 1e-12
(the two scatter-adds sum a group in different orders)."""

import jax
import numpy as np
import pytest
import torch

from tidb_tpu.chunk.chunk import Chunk as JChunk
from tidb_tpu.chunk.column import Column as JColumn
from tidb_tpu.executor import agg_device as jad
from tidb_tpu.expression.expr import ColumnRef as JRef
from tidb_tpu.planner.logical import AggSpec as JAgg
from tidb_tpu import types as jt
from tidb_tpu_torch.chunk.chunk import Chunk as PChunk
from tidb_tpu_torch.chunk.column import Column as PColumn
from tidb_tpu_torch.executor import agg_device as pad
from tidb_tpu_torch.expression.expr import ColumnRef as PRef
from tidb_tpu_torch.planner.logical import AggSpec as PAgg
from tidb_tpu_torch import types as pt
from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)

R = 256
# the reference's GroupTableStack donates its merge inputs, which the CPU
# backend cannot honour: it warns once per compile
pytestmark = pytest.mark.filterwarnings("ignore:Some donated buffers were not usable")


def _types(kind: str):
    """(reference SQLType, port SQLType) of one column kind."""
    if kind == "dec":
        return jt.decimal_type(15, 2), pt.decimal_type(15, 2)
    name = {"int": "INT", "float": "FLOAT", "date": "DATE"}[kind]
    return jt.SQLType(jt.TypeKind[name]), pt.SQLType(pt.TypeKind[name])


class Case:
    """Columns {name: (kind, data, valid)}, a sel mask, group key names and
    aggregate (func, column or None) specs, as both packages' objects."""

    def __init__(self, cols, sel, keys, aggs):
        self.cols, self.sel = cols, sel
        types = {n: _types(k) for n, (k, _d, _v) in cols.items()}
        self.jkeys = [JRef(types[n][0], n) for n in keys]
        self.pkeys = [PRef(types[n][1], n) for n in keys]
        self.jaggs, self.paggs = [], []
        for j, (func, arg) in enumerate(aggs):
            jt_, pt_ = types[arg] if arg else (jt.SQLType(jt.TypeKind.INT),
                                               pt.SQLType(pt.TypeKind.INT))
            self.jaggs.append(JAgg(f"a{j}", func, JRef(jt_, arg) if arg else None, type_=jt_))
            self.paggs.append(PAgg(f"a{j}", func, PRef(pt_, arg) if arg else None, type_=pt_))
        self.types = types

    def chunks(self, lo=0, hi=None):
        hi = R if hi is None else hi
        jcols, pcols = {}, {}
        for n, (_k, d, v) in self.cols.items():
            jty, pty = self.types[n]
            jcols[n] = JColumn.from_numpy(d[lo:hi], jty, valid=v[lo:hi])
            pcols[n] = PColumn.from_numpy(d[lo:hi], pty, valid=v[lo:hi])
        sel = self.sel[lo:hi]
        return JChunk(jcols, jax.numpy.asarray(sel)), PChunk(pcols, torch.from_numpy(sel.copy()))


def _host(table) -> dict:
    return {k: np.asarray(v) for k, v in table.items()}


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.int64) if a.dtype == np.float64 else a


def assert_tables_equal(ref, got, float_sums=()):
    ref, got = _host(ref), {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
                            for k, v in got.items()}
    assert set(ref) == set(got)
    n = int(ref["n"])
    assert int(got["n"]) == n
    for name in ref:
        if name == "n":
            continue
        r, g = ref[name][:n], got[name][:n]
        assert r.dtype == g.dtype, name
        if name in float_sums:
            np.testing.assert_allclose(g, r, rtol=1e-12, atol=0, err_msg=name)
        else:
            np.testing.assert_array_equal(_bits(g), _bits(r), err_msg=name)


def _nan(bits: int) -> float:
    return np.array([bits], dtype=np.uint64).view(np.float64)[0]


def _case(kind: str, seed: int) -> Case:
    rng = np.random.default_rng(seed)
    sel = rng.random(R) < 0.85  # dead rows throughout
    ints = rng.integers(-20, 20, R)
    ints_v = rng.random(R) < 0.9
    ints[:4] = 0  # a NULL key beside a live 0
    ints_v[:2] = False
    fvals = rng.standard_normal(R).round(2)
    fvals[rng.random(R) < 0.05] = np.nan
    fvals_v = rng.random(R) < 0.9
    dec = rng.integers(-10**9, 10**9, R)
    dec_v = rng.random(R) < 0.95
    cols = {"k": ("int", ints, ints_v), "f": ("float", fvals, fvals_v),
            "v": ("int", rng.integers(-1000, 1000, R), rng.random(R) < 0.9),
            "d": ("dec", dec, dec_v)}
    aggs = [("count", None), ("count", "v"), ("sum", "v"), ("avg", "d"), ("sum", "d"),
            ("min", "v"), ("max", "v"), ("min", "f"), ("max", "f"), ("sum", "f"),
            ("avg", "f")]
    if kind == "one_key":
        return Case(cols, sel, ["k"], aggs)
    if kind == "three_keys":
        cols["k2"] = ("date", rng.integers(9000, 9004, R).astype(np.int32), rng.random(R) < 0.9)
        cols["k3"] = ("float", rng.integers(0, 3, R).astype(np.float64), np.ones(R, bool))
        return Case(cols, sel, ["k", "k2", "k3"], aggs)
    if kind == "float_keys":
        fk = rng.choice([-0.0, 0.0, 1.5, -2.25, np.nan, _nan(0x7FF8000000000001),
                         _nan(0xFFF8000000000000)], R)
        cols["fk"] = ("float", fk, rng.random(R) < 0.9)
        return Case(cols, sel, ["fk"], aggs)
    if kind == "limbs_past_2e32":
        # one hot group whose low limbs add far past 2^32 in every chunk
        big = rng.integers(3 << 30, 4 << 30, R)
        cols["d"] = ("dec", big, np.ones(R, bool))
        cols["k"] = ("int", (rng.random(R) < 0.9).astype(np.int64), np.ones(R, bool))
        return Case(cols, sel, ["k"], [("sum", "d"), ("avg", "d"), ("count", None)])
    raise ValueError(kind)


_FLOAT_SUMS = {"a9.sum", "a10.sum"}
KINDS = ["one_key", "three_keys", "float_keys", "limbs_past_2e32"]


@pytest.mark.parametrize("kind", KINDS)
def test_partial_kernel_matches_reference(kind):
    case = _case(kind, seed=11)
    jch, pch = case.chunks()
    ref = jax.jit(jad.make_partial_kernel(case.jkeys, case.jaggs))(jch)
    got = pad.make_partial_kernel(case.pkeys, case.paggs)(pch)
    assert_tables_equal(ref, got, _FLOAT_SUMS)


@pytest.mark.parametrize("kind", KINDS)
def test_merge_kernel_matches_reference(kind):
    case = _case(kind, seed=12)
    half = R // 2
    jpart = jax.jit(jad.make_partial_kernel(case.jkeys, case.jaggs))
    ppart = pad.make_partial_kernel(case.pkeys, case.paggs)
    (ja, pa), (jb, pb) = case.chunks(0, half), case.chunks(half, R)
    ref = jax.jit(jad.make_merge_kernel(len(case.jkeys), case.jaggs))(jpart(ja), jpart(jb))
    got = pad.make_merge_kernel(len(case.pkeys), case.paggs)(ppart(pa), ppart(pb))
    assert_tables_equal(ref, got, _FLOAT_SUMS)


@pytest.mark.parametrize("kind", KINDS)
def test_five_chunks_through_the_stack(kind):
    """Five chunks: the stack holds a level-0 table (chunk 5) and a level-2
    table (chunks 1-4 merged twice), slot for slot as the reference's; the
    host partials (and the limbs past 2^32, carry-normalized) equal too."""
    case = _case(kind, seed=13)
    step = R // 5
    jpart = jax.jit(jad.make_partial_kernel(case.jkeys, case.jaggs))
    ppart = pad.make_partial_kernel(case.pkeys, case.paggs)
    jstack = jad.GroupTableStack(len(case.jkeys), case.jaggs, f"port-parity-{kind}")
    pstack = pad.GroupTableStack(len(case.pkeys), case.paggs)
    for i in range(5):
        jch, pch = case.chunks(i * step, (i + 1) * step)
        jstack.push(jpart(jch))
        pstack.push(ppart(pch))
    jt_, pt_ = jstack.tables(), pstack.tables()
    assert [int(t["n"]) for t in pt_] == [int(t["n"]) for t in jt_]
    assert len(pt_) == 2
    for r, g in zip(jt_, pt_):
        assert_tables_equal(r, g, _FLOAT_SUMS)
    host = pad.fetch_tables(pt_)
    for r, g in zip(jt_, host):
        want = jad.table_to_host_partial(_host(r), len(case.jkeys), case.jaggs)
        have = pad.table_to_host_partial(g, len(case.pkeys), case.paggs)
        np.testing.assert_array_equal(have["mat"], want["mat"])
        for a, b in zip(have["keys"] + have["kvalids"], want["keys"] + want["kvalids"]):
            np.testing.assert_array_equal(_bits(a), _bits(b))
        for j, (sa, sb) in enumerate(zip(have["states"], want["states"])):
            assert set(sa) == set(sb)
            for name in sa:
                if f"a{j}.{name}" in _FLOAT_SUMS:
                    np.testing.assert_allclose(sa[name], sb[name], rtol=1e-12, atol=0)
                else:
                    np.testing.assert_array_equal(_bits(sa[name]), _bits(sb[name]))
    if kind == "limbs_past_2e32":
        lo = host[-1]["a0.sum"]
        assert (lo >= 0).all() and (lo < (1 << 32)).all()
        assert (host[-1]["a0.sumhi"] > 0).any()


def test_fetch_tables_is_the_live_prefix():
    """fetch_tables returns each table's [:n] slots and n, dtype for dtype."""
    case = _case("one_key", seed=14)
    _jch, pch = case.chunks()
    table = pad.make_partial_kernel(case.pkeys, case.paggs)(pch)
    (host,) = pad.fetch_tables([table])
    n = int(table["n"])
    assert host["n"] == n
    for k, v in table.items():
        if k != "n":
            assert host[k].dtype == v.numpy().dtype
            np.testing.assert_array_equal(_bits(host[k]), _bits(v.numpy()[:n]))
