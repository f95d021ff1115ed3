"""The port's fused segment update (tidb_tpu_torch/ops/segment_sum.py's
segment_accumulate, and executor/aggregate.py's make_segment_kernel that
calls it) against the JAX package's functions on identical numpy-seeded
inputs.

On the CPU segment_accumulate runs its plain version; the JAX side runs
`segment_count` and `segment_sum_i64` (with `split_limbs` for two-limb
sums) through their Pallas kernels in interpret mode, forced on as
tests/test_torch_segment_sum.py does. The CUDA kernel (tidb_segagg) is
held against the plain version on the card by tests/test_torch_cuda.py
and chip_smoke.py.

Tolerances: counts and int64 sums bit for bit; float64 sums (index_add_
against XLA's scatter-add, which add in different orders) within rel
1e-12."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tidb_tpu.executor.aggregate as jax_agg
import tidb_tpu.expression.expr as jax_expr
import tidb_tpu.planner.logical as jax_logical
import tidb_tpu.types as jax_types
from tidb_tpu.chunk.chunk import Chunk as JaxChunk
from tidb_tpu.chunk.column import Column as JaxColumn
from tidb_tpu.ops import segment_count, segment_sum_i64, set_pallas_enabled
import tidb_tpu_torch.executor.aggregate as port_agg
import tidb_tpu_torch.expression.expr as port_expr
import tidb_tpu_torch.planner.logical as port_logical
import tidb_tpu_torch.types as port_types
from tidb_tpu_torch.chunk.chunk import Chunk as PortChunk
from tidb_tpu_torch.chunk.column import Column as PortColumn
from tidb_tpu_torch.ops import segment_sum as port

_INFO = np.iinfo(np.int64)
_EXTREMES = np.array([_INFO.max, _INFO.min, _INFO.max - 1, _INFO.min + 1, -1, 1, 0],
                     dtype=np.int64)


@pytest.fixture(autouse=True)
def force_pallas():
    set_pallas_enabled(True)
    yield
    set_pallas_enabled(None)


# ---------------------------------------------------------------------------
# segment_accumulate against segment_count / segment_sum_i64 / split_limbs
# ---------------------------------------------------------------------------


def _inputs(rng, R, G, case):
    """ids (a tenth at or above G, a twentieth below 0), sel, and four
    accumulators' values and masks for one case."""
    seg = rng.integers(0, G, R)
    bad = rng.random(R)
    seg[bad < 0.1] = G + rng.integers(0, 5, int((bad < 0.1).sum()))
    seg[bad > 0.95] = -rng.integers(1, 4, int((bad > 0.95).sum()))
    sel = rng.random(R) < 0.7
    masks = [rng.random(R) < 0.8 for _ in range(3)]
    if case == "extremes":
        vals = [_EXTREMES[rng.integers(0, len(_EXTREMES), R)] for _ in range(2)]
    else:
        vals = [rng.integers(-10**13, 10**13, R, dtype=np.int64) for _ in range(2)]
    if case == "all_false":
        sel[:] = False
    elif case == "null_validity":
        masks[0][:] = False  # a column that is NULL on every row
        masks[2][:] = False
    elif case == "no_sel":
        sel = None
    return seg.astype(np.int64), sel, masks, vals


def _jax_accumulate(seg, sel, masks, vals, G, init):
    """The reference's per-accumulator calls: occ, count(mask), sum(mask),
    limbs(mask) over the live rows, added to `init`; the limb pair then
    carry-normalized as the reference's update does."""
    sj = jnp.asarray(seg.astype(np.int32))
    live = np.ones(len(seg), bool) if sel is None else sel
    ok = [live & m for m in masks]
    out = [init[0] + np.asarray(segment_count(jnp.asarray(live), sj, G)),
           init[1] + np.asarray(segment_count(jnp.asarray(ok[0]), sj, G)),
           init[2] + np.asarray(segment_sum_i64(jnp.asarray(np.where(ok[1], vals[0], 0)),
                                                sj, G))]
    lo, hi = jax_agg.split_limbs(jnp.asarray(np.where(ok[2], vals[1], 0)))
    lo, hi = jax_agg.normalize_limbs(init[3] + segment_sum_i64(lo, sj, G),
                                     init[4] + segment_sum_i64(hi, sj, G))
    return out + [np.asarray(lo), np.asarray(hi)]


@pytest.mark.parametrize("G", [1, 12, 26, 33, 300])
@pytest.mark.parametrize("R", [2048, 3001])  # one tile-aligned, one ragged
@pytest.mark.parametrize("case", ["decimal", "extremes", "all_false",
                                  "null_validity", "no_sel"])
def test_accumulate_matches_jax(G, R, case):
    rng = np.random.default_rng(G * 31 + R + len(case))
    seg, sel, masks, vals = _inputs(rng, R, G, case)
    init = [rng.integers(-10**6, 10**6, G, dtype=np.int64) for _ in range(5)]
    want = _jax_accumulate(seg, sel, masks, vals, G, init)
    outs = [torch.from_numpy(x.copy()) for x in init]
    t = torch.from_numpy
    accs = [port.SegAcc("count", outs[0]),
            port.SegAcc("count", outs[1], mask=t(masks[0])),
            port.SegAcc("sum", outs[2], vals=t(vals[0]), mask=t(masks[1])),
            port.SegAcc("limbs", outs[3], vals=t(vals[1]), mask=t(masks[2]),
                        out_hi=outs[4])]
    port.reset_launches()
    port.segment_accumulate(t(seg), G, None if sel is None else t(sel), accs)
    assert all(v == 0 for v in port.LAUNCHES.values())  # the CPU path
    for got, w in zip(outs, want):
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), w)


def test_accumulate_splits_past_32_accumulators():
    """More accumulators than one launch takes: the CPU path gives each
    its own sum all the same (the card splits them into launches)."""
    rng = np.random.default_rng(3)
    R, G = 1500, 12
    seg = torch.from_numpy(rng.integers(0, G, R))
    vals = [torch.from_numpy(rng.integers(-1000, 1000, R)) for _ in range(40)]
    outs = [torch.zeros(G, dtype=torch.int64) for _ in range(40)]
    port.segment_accumulate(seg, G, None, [port.SegAcc("sum", o, vals=v)
                                           for o, v in zip(outs, vals)])
    for o, v in zip(outs, vals):
        assert torch.equal(o, port.plain_segment_sum_i64(v, seg, G))


# ---------------------------------------------------------------------------
# make_segment_kernel's update against the reference's, over three chunks
# ---------------------------------------------------------------------------


def _spec(ns, name):
    """(group column names, domains, aggs) of Q1's, Q5's or a mixed
    aggregate, built from package `ns` (types, expr, logical)."""
    types, expr, logical = ns
    dec = types.decimal_type

    def col(n, t):
        return expr.ColumnRef(type_=t, name=n)

    def agg(uid, func, arg, t=types.INT64):
        return logical.AggSpec(uid=uid, func=func, arg=arg, type_=t)

    if name == "q1":
        qty, ext = col("qty", dec(15, 2)), col("ext", dec(15, 2))
        dp, ch, disc = col("dp", dec(15, 4)), col("ch", dec(15, 6)), col("disc", dec(15, 2))
        aggs = [agg("a0", "sum", qty), agg("a1", "sum", ext), agg("a2", "sum", dp),
                agg("a3", "sum", ch), agg("a4", "avg", qty), agg("a5", "avg", ext),
                agg("a6", "avg", disc), agg("a7", "count", None)]
        return [("rf", 4), ("ls", 3)], aggs
    if name == "q5":
        return [("nation", 26)], [agg("a0", "sum", col("rev", dec(15, 4)))]
    x, f = col("x", types.INT64), col("f", types.FLOAT64)
    aggs = [agg("a0", "count", x), agg("a1", "sum", x), agg("a2", "sum", f),
            agg("a3", "min", x), agg("a4", "max", x), agg("a5", "avg", col("qty", dec(15, 2))),
            agg("a6", "count", None)]
    return [("k", 33)], aggs


_VALUE_COLS = {"qty": (1, 5001), "ext": (90000, 10**7), "dp": (-10**11, 10**11),
               "ch": (-10**13, 10**13), "disc": (0, 11), "rev": (-10**12, 10**12),
               "x": (-10**9, 10**9)}


def _chunk_data(rng, R, groups, nulls):
    """numpy columns: name -> (data, valid), and sel."""
    cols = {}
    for g, dom in groups:
        cols[g] = (rng.integers(0, dom - 1, R), rng.random(R) > (0.1 if nulls else 0))
    for c, (lo, hi) in _VALUE_COLS.items():
        cols[c] = (rng.integers(lo, hi, R, dtype=np.int64),
                   rng.random(R) > (0.15 if nulls else 0))
    cols["f"] = (rng.standard_normal(R) * 1e6, rng.random(R) > (0.15 if nulls else 0))
    return cols, rng.random(R) < 0.75


def _col_type(ns, aggs, name):
    for a in aggs:
        if a.arg is not None and a.arg.name == name:
            return a.arg.type_
    return ns[0].FLOAT64 if name == "f" else ns[0].INT64


@pytest.mark.parametrize("name", ["q1", "q5", "mixed"])
@pytest.mark.parametrize("nulls", [False, True])
def test_update_matches_jax(name, nulls):
    rng = np.random.default_rng(len(name) * 7 + nulls)
    jax_ns = (jax_types, jax_expr, jax_logical)
    port_ns = (port_types, port_expr, port_logical)
    groups, jaggs = _spec(jax_ns, name)
    _, paggs = _spec(port_ns, name)
    domains = [d for _, d in groups]

    def gexprs(ns):
        return [ns[1].ColumnRef(type_=ns[0].INT64, name=g) for g, _ in groups]

    j_init, j_update, jG = jax_agg.make_segment_kernel(gexprs(jax_ns), jaggs, domains)
    p_init, p_update, pG = port_agg.make_segment_kernel(gexprs(port_ns), paggs, domains)
    assert jG == pG
    j_state, p_state = j_init(), p_init("cpu")
    for R in (3000, 1024, 2500):  # three chunks, the state carried across
        cols, sel = _chunk_data(rng, R, groups, nulls)
        jc = JaxChunk({n: JaxColumn.from_numpy(d, _col_type(jax_ns, jaggs, n), valid=v)
                       for n, (d, v) in cols.items()}, jnp.asarray(sel))
        pc = PortChunk({n: PortColumn.from_numpy(d, _col_type(port_ns, paggs, n), valid=v)
                        for n, (d, v) in cols.items()}, torch.from_numpy(sel))
        j_state = j_update(j_state, jc)
        p_state = p_update(p_state, pc)
    assert list(p_state) == list(j_state)
    for k, v in j_state.items():
        want = np.asarray(v)
        got = p_state[k].numpy()
        assert got.dtype == want.dtype, k
        if want.dtype == np.float64:
            np.testing.assert_allclose(got, want, rtol=1e-12, err_msg=k)
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)
