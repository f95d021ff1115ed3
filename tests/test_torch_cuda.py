"""Card-only tests of the port: the CUDA kernels against their plain
PyTorch versions, and the port's Session on cuda against itself on the
CPU. Each test carries the `cuda` marker and skips without a card (a CUDA
kernel has no CPU mode).

This file imports neither jax nor tidb_tpu, so it also runs on a machine
that has only PyTorch; there, skip the repository's conftest (which sets
up jax):

    python -m pytest tests/test_torch_cuda.py --noconftest -q

Tolerances: counts and int64 sums bit-equal (the fused update's every
output too); f32 sums within 1e-5 of each
group's absolute mass (atomics add in a different order on every run); the
hash probe's (lo, hi) bit-equal to its plain window scan; query rows
exactly equal (decimals are exact, and float AVGs are computed on the host
from exact sums); the probe program's seven outputs bit-equal to its plain
version. The hash-probe and probe-program cases are chip_smoke.py's
phase-1 cases, imported from the repository root (run from there)."""

import numpy as np
import pytest
import torch

from tidb_tpu_torch.ops import segment_sum as port

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("R,G", [(65536, 1), (65536, 12), (65536, 8192),
                                 (65536, 1 << 16), (65573, 12), (1000, 300)])
def test_kernels_match_plain(card, R, G):
    rng = np.random.default_rng(R + G)
    seg = rng.integers(0, G, R)
    bad = rng.random(R) < 0.1
    seg[bad] = G + rng.integers(0, 5, int(bad.sum()))  # ids >= G are dropped
    seg = torch.from_numpy(seg.astype(np.int64)).to(card)
    mask = torch.from_numpy(rng.random(R) < 0.5).to(card)
    info = np.iinfo(np.int64)
    pool = np.array([info.max, info.min, -1, 1, 0, 10**15], dtype=np.int64)
    vals = torch.from_numpy(pool[rng.integers(0, len(pool), R)]).to(card)
    f = torch.from_numpy(rng.standard_normal(R).astype(np.float32)).to(card)
    port.reset_launches()
    assert torch.equal(port.segment_count(mask, seg, G),
                       port.plain_segment_count(mask, seg, G))
    assert torch.equal(port.segment_sum_i64(vals, seg, G),
                       port.plain_segment_sum_i64(vals, seg, G))
    got = port.segment_sum_f32(f, seg, G).double()
    want = port.plain_segment_sum_f32(f, seg, G).double()
    mass = port.plain_segment_sum_f32(f.abs(), seg, G).double()
    assert bool(((got - want).abs() <= 1e-5 * mass + 1e-6).all())
    assert port.LAUNCHES == {"segagg": 0, "segsum_count": 1, "segsum_f32": 1,
                             "segsum_i64": 1}


@pytest.mark.parametrize("name", ["q1_shape", "mixed_G1", "mixed_G12", "mixed_G26",
                                  "mixed_G33", "mixed_G300", "mixed_G8192",
                                  "global_atomics", "ragged_r", "ragged_hist", "no_sel",
                                  "all_false", "misaligned", "forty_accs"])
def test_segagg_matches_plain(card, name):
    """tidb_segagg on chip_smoke.py's phase-1 cases (Q1's 23-output shape,
    the G cases, ragged R, no sel, all-false sel, a NULL column, unaligned
    operands, 40 accumulators): every output bit-equal to
    plain_segment_accumulate, one launch per 32 accumulators."""
    import chip_smoke

    R, G, opts = chip_smoke.segagg_cases()[name]
    seg, sel, accs = chip_smoke.make_segagg_case(torch, np, port, R, G, opts, 11, card)
    port.reset_launches()
    launches = chip_smoke.check_segagg_case(torch, port, seg, G, sel, accs)
    assert launches == -(-len(accs) // port.MAX_ACCS)
    assert port.LAUNCHES["segsum_count"] == port.LAUNCHES["segsum_i64"] == 0


def test_segagg_raises_without_a_card_operand(card):
    from tidb_tpu_torch.errors import ExecutionError

    seg = torch.zeros(64, dtype=torch.int64, device=card)
    out = torch.zeros(4, dtype=torch.int64)  # on the host
    with pytest.raises(ExecutionError):
        port.segment_accumulate(seg, 4, None, [port.SegAcc("count", out)])


def test_hash_probe_matches_plain(card):
    """B3 on every phase-1 case of chip_smoke.py: bit-equal to the plain
    window scan, counts equal to searchsorted."""
    import chip_smoke
    from tidb_tpu_torch.ops import hash_probe as hp

    hp.reset_launches()
    cases = chip_smoke.probe_cases(np)
    for name, (b, p) in cases.items():
        sk = torch.from_numpy(b).to(card)
        pr = torch.from_numpy(p).to(card)
        chip_smoke.check_probe_case(torch, hp, sk, pr)
        torch.cuda.synchronize()
    # every case with a table launched the kernel once
    assert hp.LAUNCHES["hash_probe"] == len(cases) - 1


def test_hash_probe_raises_without_a_card_operand(card):
    from tidb_tpu_torch.errors import ExecutionError
    from tidb_tpu_torch.ops import hash_probe as hp

    sk = torch.arange(64, dtype=torch.int64, device=card)
    t = hp.build_table(sk, hp.table_capacity(64))
    with pytest.raises(ExecutionError):
        hp.probe_table(t[0].cpu(), t[1], t[2], sk, sk)


PROBE_COUNT_CASES = [
    "direct", "direct_left", "direct_flags", "direct_ragged", "table", "table_left",
    "table_flags", "table_ragged", "sorted", "sorted_left", "sorted_flags", "sorted_ragged",
    "table_cap_2e18", "table_cap_2e18_flags", "table_empty_preimage", "two_key_direct",
    "two_key_sorted", "two_key_table", "hash_table", "hash_sorted", "one_partial_tile"]


@pytest.mark.parametrize("name", PROBE_COUNT_CASES)
def test_probe_count_matches_plain(card, name):
    """tidb_probe_count on chip_smoke.py's phase-1 cases (each route plain,
    LEFT-padded, flags-only and ragged; a cap-2^18 table; EMPTY-preimage
    keys; two-key and hash packing; a chunk below one tile): all seven
    outputs bit-equal to plain_probe_chunk, one launch."""
    import chip_smoke
    from tidb_tpu_torch.ops import hash_probe as hp
    from tidb_tpu_torch.ops import join_kernels as jk

    R, B, opts = chip_smoke.probe_count_cases()[name]
    case = chip_smoke.make_probe_count_case(torch, np, jk, hp, R, B, opts, 17, card)
    args, kw = chip_smoke.chunk_args(jk, case)
    hp.reset_launches()
    assert chip_smoke.check_chunk(torch, hp, args, kw)["launches"] == 1
    assert hp.LAUNCHES == {"probe_count": 1, "hash_probe": 0}


def test_probe_count_raises_without_a_card_operand(card):
    import chip_smoke
    from tidb_tpu_torch.errors import ExecutionError
    from tidb_tpu_torch.ops import hash_probe as hp
    from tidb_tpu_torch.ops import join_kernels as jk

    case = chip_smoke.make_probe_count_case(torch, np, jk, hp, 512, 64, {"route": "sorted"},
                                            3, card)
    (packed, kvalid, in_range, sel, n_build, sk), kw = chip_smoke.chunk_args(jk, case)
    with pytest.raises(ExecutionError):
        hp.probe_chunk(packed, kvalid, in_range, sel.cpu(), n_build, sk, **kw)


def test_joins_on_card_equal_cpu(card):
    """Q3, Q5 and Q18 at SF0.01 on cuda equal the port on the CPU; each
    probe chunk is one tidb_probe_count launch, and Q18's semi join goes
    through the table route."""
    from tidb_tpu_torch.ops import hash_probe as hp
    from tidb_tpu_torch.ops import join_kernels as jk
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage.catalog import Catalog
    from tidb_tpu_torch.storage.tpch import load_tpch
    from tidb_tpu_torch.storage.tpch_queries import Q

    cat = Catalog()
    load_tpch(cat, sf=0.01)
    on_card, on_cpu = Session(cat), Session(cat, device="cpu")
    for q in ("q3", "q5", "q18"):
        hp.reset_launches()
        jk.reset_routes()
        got = on_card.query(Q[q][0])
        # one tidb_probe_count launch per probe chunk, on every route
        assert hp.LAUNCHES["probe_count"] == sum(jk.PROBE_ROUTES.values()) > 0
        assert hp.LAUNCHES["hash_probe"] == 0
        if q == "q18":
            assert jk.PROBE_ROUTES["table"] > 0
        assert got == on_cpu.query(Q[q][0]), q
    low = Q["q18"][0].replace("> 300", "> 200")
    assert on_card.query(low) == on_cpu.query(low)


def test_q1_q6_on_card_equal_cpu(card):
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage.catalog import Catalog
    from tidb_tpu_torch.storage.tpch import load_tpch
    from tidb_tpu_torch.storage.tpch_queries import Q

    cat = Catalog()
    load_tpch(cat, sf=0.01)
    on_card, on_cpu = Session(cat), Session(cat, device="cpu")
    for q in ("q1", "q6"):
        port.reset_launches()
        got = on_card.query(Q[q][0])
        # SF0.01 is one chunk: one fused launch, no single-column one
        assert port.LAUNCHES["segagg"] == 1
        assert port.LAUNCHES["segsum_count"] == port.LAUNCHES["segsum_i64"] == 0
        assert got == on_cpu.query(Q[q][0])


def _staging_jobs(n, rows):
    """n jobs whose batches are random int64 and int16 columns (seeded by
    the batch index), carved from one arena each."""
    from tidb_tpu_torch.executor.pipeline import HostArena

    def job_for(i):
        def job(arena_for):
            rng = np.random.default_rng(i)
            arena = arena_for(HostArena.nbytes_for([(rows, np.int64), (rows, np.int16)]))
            x = arena.zeros(rows, np.int64)
            x[:] = rng.integers(0, 1 << 20, rows)
            y = arena.zeros(rows, np.int16)
            y[:] = rng.integers(-(1 << 15), 1 << 15, rows)
            return {"x": x, "y": y}
        return job

    return [job_for(i) for i in range(n)]


def test_prefetcher_copy_stream_matches_inline(card):
    """50 consecutive batches staged ahead on the prefetcher's copy stream
    are bit-equal to inline staging, while kernels on the compute stream
    still read the previous batch after the consumer dropped it: the copy
    event orders the compute stream after each copy, and record_stream
    keeps the caching allocator from handing a block that a queued kernel
    reads to the next copy."""
    from tidb_tpu_torch.executor.base import ExecContext
    from tidb_tpu_torch.executor.pipeline import PIPELINE_PREFETCH_TOTAL, ChunkPrefetcher

    n, rows = 50, 1 << 20

    def run(depth):
        pf = ChunkPrefetcher(_staging_jobs(n, rows), ExecContext(device=card,
                                                                 prefetch_depth=depth))
        sums, copies = [], []
        try:
            for i in range(n):
                b = pf.get(i)
                acc = torch.zeros((), dtype=torch.int64, device=card)
                for r in range(8):  # a chain of kernels reading the batch
                    acc = acc + (b["x"] * (r + 1)).sum() + b["y"].to(torch.int64).sum()
                sums.append(acc)
                copies.append((b["x"].clone(), b["y"].clone()))
                del b  # only the queued kernels still read it
        finally:
            pf.close()
        torch.cuda.synchronize()
        return torch.stack(sums).cpu(), copies

    inline0 = PIPELINE_PREFETCH_TOTAL["inline"]
    want_sums, want = run(0)
    assert PIPELINE_PREFETCH_TOTAL["inline"] == inline0 + n
    ahead0 = PIPELINE_PREFETCH_TOTAL["hit"] + PIPELINE_PREFETCH_TOTAL["wait"]
    got_sums, got = run(2)
    assert PIPELINE_PREFETCH_TOTAL["hit"] + PIPELINE_PREFETCH_TOTAL["wait"] == ahead0 + n
    assert torch.equal(got_sums, want_sums)
    for i, ((gx, gy), (wx, wy)) in enumerate(zip(got, want)):
        assert torch.equal(gx, wx) and torch.equal(gy, wy), i
    rng = np.random.default_rng(n - 1)  # the last batch against the host
    x = rng.integers(0, 1 << 20, rows)
    assert np.array_equal(got[-1][0].cpu().numpy(), x)


def test_fused_packed_batches_on_card_equal_cpu(card):
    """The fused pipeline on the card with 1,024-row segments packed 4 to a
    batch (chunk capacity 4,096) equals the port on the CPU, and the
    segment update launches tidb_segagg once per staged batch."""
    from tidb_tpu_torch.executor import pipeline as pl
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage.catalog import Catalog
    from tidb_tpu_torch.storage.tpch import load_tpch
    from tidb_tpu_torch.storage.tpch_queries import Q

    cat = Catalog()
    load_tpch(cat, sf=0.01)
    on_card = Session(cat, chunk_capacity=1 << 12)
    on_cpu = Session(cat, chunk_capacity=1 << 12, device="cpu")
    for s in (on_card, on_cpu):
        s.execute("set tidb_tpu_segment_rows = 1024")
    on_card.execute("set global tidb_tpu_device_buffer_cache_bytes = 0")
    for q in ("q1", "q6", "q3", "q5"):
        want = on_cpu.query(Q[q][0])
        port.reset_launches()
        pl.reset_counters()
        got = on_card.query(Q[q][0])
        assert got == want, q
        if q in ("q1", "q6"):
            staged = sum(pl.PIPELINE_PREFETCH_TOTAL[k] for k in ("hit", "wait", "inline"))
            assert pl.PIPELINE_FUSED_TOTAL["agg"] == 1
            assert port.LAUNCHES["segagg"] == staged > 1
            assert pl.PIPELINE_PREFETCH_BYTES["copies"] == staged


# -- the device generic aggregation and the top-k state (plain torch) ---------


def _agg_case(seed, R=4096):
    """A chunk with an int key (NULLs beside a live 0), a float key
    (-0.0, 0.0, NaN), dead rows, and count/sum/avg/min/max over int, float
    (NaN) and decimal (two-limb) arguments, as the port's objects."""
    from tidb_tpu_torch.chunk.chunk import Chunk
    from tidb_tpu_torch.chunk.column import Column
    from tidb_tpu_torch.expression.expr import ColumnRef
    from tidb_tpu_torch.planner.logical import AggSpec
    from tidb_tpu_torch.types import FLOAT64, INT64, decimal_type

    rng = np.random.default_rng(seed)
    dec = decimal_type(15, 2)
    cols = {"k": (INT64, rng.integers(-50, 50, R), rng.random(R) < 0.9),
            "fk": (FLOAT64, rng.choice([-0.0, 0.0, 1.5, np.nan], R), rng.random(R) < 0.9),
            "v": (INT64, rng.integers(-1000, 1000, R), rng.random(R) < 0.9),
            "f": (FLOAT64, np.where(rng.random(R) < 0.05, np.nan, rng.standard_normal(R)),
                  rng.random(R) < 0.9),
            "d": (dec, rng.integers(3 << 30, 4 << 30, R), rng.random(R) < 0.95)}
    sel = rng.random(R) < 0.85

    def chunk(dev, lo, hi):
        return Chunk({n: Column(torch.from_numpy(d[lo:hi].astype(t.np_dtype)).to(dev),
                                torch.from_numpy(v[lo:hi].copy()).to(dev), t)
                      for n, (t, d, v) in cols.items()},
                     torch.from_numpy(sel[lo:hi].copy()).to(dev))

    keys = [ColumnRef(INT64, "k"), ColumnRef(FLOAT64, "fk")]
    aggs = [AggSpec("a0", "count", None), AggSpec("a1", "sum", ColumnRef(INT64, "v")),
            AggSpec("a2", "avg", ColumnRef(dec, "d"), type_=FLOAT64),
            AggSpec("a3", "min", ColumnRef(FLOAT64, "f"), type_=FLOAT64),
            AggSpec("a4", "max", ColumnRef(INT64, "v")),
            AggSpec("a5", "sum", ColumnRef(FLOAT64, "f"), type_=FLOAT64)]
    return chunk, keys, aggs


def _same_table(got, want, float_sums=("a5.sum",)):
    n = int(want["n"])
    assert int(got["n"]) == n
    for k in want:
        if k == "n":
            continue
        g, w = got[k][:n].cpu(), want[k][:n].cpu()
        if k in float_sums:
            assert torch.allclose(g, w, rtol=1e-12, atol=0, equal_nan=True), k
        elif w.is_floating_point():
            assert torch.equal(g.view(torch.int64), w.view(torch.int64)), k
        else:
            assert torch.equal(g, w), k


def test_generic_group_tables_on_card_equal_cpu(card):
    """The partial tables, five chunks through the stack and the finalize
    fetch on the card equal the CPU's slot for slot (float sums rel 1e-12)."""
    from tidb_tpu_torch.executor import agg_device as ad

    chunk, keys, aggs = _agg_case(41)
    partial = ad.make_partial_kernel(keys, aggs)
    stacks = {d: ad.GroupTableStack(len(keys), aggs) for d in ("cpu", "cuda")}
    for i in range(5):
        for d, st in stacks.items():
            st.push(partial(chunk(d, i * 800, (i + 1) * 800)))
    cpu_t, card_t = stacks["cpu"].tables(), stacks["cuda"].tables()
    assert len(card_t) == len(cpu_t) == 2
    for g, w in zip(card_t, cpu_t):
        assert g["k0.d"].is_cuda
        _same_table(g, w)
    for g, w in zip(ad.fetch_tables(card_t), ad.fetch_tables(cpu_t)):
        assert set(g) == set(w) and g["n"] == w["n"]
        for k in w:
            if k != "n":
                np.testing.assert_allclose(g[k], w[k], rtol=1e-12 if k == "a5.sum" else 0)


def test_generic_per_chunk_steps_make_no_host_read(card):
    """The partial table and each push (its merges) run under torch's sync
    debug mode "error": no device->host copy, no .item(), no sync."""
    from tidb_tpu_torch.executor import agg_device as ad

    chunk, keys, aggs = _agg_case(42)
    partial = ad.make_partial_kernel(keys, aggs)
    stack = ad.GroupTableStack(len(keys), aggs)
    chunks = [chunk("cuda", i * 512, (i + 1) * 512) for i in range(8)]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for ch in chunks:
            stack.push(partial(ch))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert len(stack.tables()) == 1


@pytest.mark.parametrize("kinds,descs", [(("float",), (False,)), (("float",), (True,)),
                                         (("float", "int"), (True, False))])
def test_topk_merge_on_card_equals_cpu(card, kinds, descs):
    from tidb_tpu_torch.ops import topk as tk

    rng = np.random.default_rng(len(kinds) + descs[0])
    states = {d: tk.topk_init(64, [k == "float" for k in kinds], [torch.int64], d)
              for d in ("cpu", "cuda")}
    for _ in range(3):
        N = 2048
        keys = []
        for k in kinds:
            d = rng.integers(-3, 3, N).astype(np.float64 if k == "float" else np.int64)
            if k == "float":
                d[rng.random(N) < 0.05] = np.nan
            keys.append((d, rng.random(N) < 0.9))
        pay = (rng.integers(0, 10**9, N), rng.random(N) < 0.9)
        sel = rng.random(N) < 0.8
        for dev in states:
            pairs = [tk.rank_operands(torch.from_numpy(d).to(dev), torch.from_numpy(v).to(dev), ds)
                     for (d, v), ds in zip(keys, descs)]
            payload = [(torch.from_numpy(pay[0]).to(dev), torch.from_numpy(pay[1]).to(dev))]
            states[dev] = tk.merge_topk(states[dev], pairs, payload,
                                        torch.from_numpy(sel).to(dev), descs)
    (gd, gr, gp, gn, gpay), (wd, wr, wp, wn, wpay) = states["cuda"], states["cpu"]
    live = wd == 0
    assert torch.equal(gd.cpu(), wd) and int(gn) == int(wn)
    for g, w in [(gp, wp)] + [x for pair in zip(gr, wr) for x in zip(*pair)] \
            + [x for pair in zip(gpay, wpay) for x in zip(*pair)]:
        g, w = g.cpu()[live], w[live]
        if w.is_floating_point():
            g, w = g.view(torch.int64), w.view(torch.int64)
        assert torch.equal(g, w)


def test_generic_and_topn_queries_on_card_equal_cpu(card):
    """Generic aggregations (classic and fused) and fused top-k roots through
    Session on the card equal the CPU's rows, with the routes counted."""
    from tidb_tpu_torch.executor import aggregate as agg
    from tidb_tpu_torch.executor import pipeline as pl
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage.catalog import Catalog
    from tidb_tpu_torch.storage.tpch import load_tpch
    from tidb_tpu_torch.storage.tpch_queries import Q

    cat = Catalog()
    load_tpch(cat, sf=0.01)
    on_card = Session(cat, chunk_capacity=1 << 12)
    on_cpu = Session(cat, chunk_capacity=1 << 12, device="cpu")
    top = ("select l_orderkey, l_linenumber, l_extendedprice from lineitem "
           "where l_shipdate >= date '1995-01-01' order by l_extendedprice desc")
    cases = {"q3": (Q["q3"][0], "classic"), "q13": (Q["q13"][0], "classic"),
             "q15": (Q["q15"][0], "fused"),
             "q18_low": (Q["q18"][0].replace("> 300", "> 200"), "fused"),
             "topn_single": (top + " limit 10", "topn"),
             "topn_multi": (top + ", l_orderkey, l_linenumber limit 100", "topn")}
    for name, (sql, route) in cases.items():
        want = on_cpu.query(sql)
        agg.reset_counters()
        pl.reset_counters()
        got = on_card.query(sql)
        assert want and got == want, name
        if route == "topn":
            assert pl.PIPELINE_FUSED_TOTAL["topn"] == 1, name
        else:
            assert agg.DEVICE_GENERIC_TOTAL[route] >= 1, (name, agg.DEVICE_GENERIC_TOTAL)


def test_refresh_functions_on_card_equal_cpu(card):
    """TPC-H's RF1 (one explicit transaction of multi-row INSERTs) and RF2
    (multi-table DELETEs through a key table, a hash join that launches
    tidb_probe_count) at SF0.01, on the card and on the CPU, each over its
    own catalog: the five main-path queries give equal rows after each."""
    from tidb_tpu_torch.ops import hash_probe as hp
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage import tpch_refresh as rf
    from tidb_tpu_torch.storage.catalog import Catalog
    from tidb_tpu_torch.storage.tpch import load_tpch
    from tidb_tpu_torch.storage.tpch_queries import Q

    sessions = []
    for dev in ("cuda", "cpu"):
        cat = Catalog()
        load_tpch(cat, sf=0.01)
        sessions.append(Session(cat, device=dev))
    on_card, on_cpu = sessions
    new = rf.rf1(on_cpu.catalog, 0.01, seed=7)
    stmts = (rf.insert_statements(on_cpu.catalog.table("test", "orders"), new["orders"])
             + rf.insert_statements(on_cpu.catalog.table("test", "lineitem"),
                                    new["lineitem"]))
    keys = rf.rf2_keys(on_cpu.catalog, 0.01)
    rf2 = ["create table rf2_keys (k bigint primary key)",
           "insert into rf2_keys values " + ", ".join(f"({k})" for k in keys),
           "delete lineitem from lineitem join rf2_keys on l_orderkey = k",
           "delete orders from orders join rf2_keys on o_orderkey = k"]
    queries = [Q[q][0] for q in ("q1", "q6", "q3", "q5")] + [
        Q["q18"][0].replace("> 300", "> 200")]
    for s in sessions:
        s.execute("begin")
        for sql in stmts:
            s.execute(sql)
    assert on_card.query(queries[0]) == on_cpu.query(queries[0])
    for s in sessions:
        s.execute("commit")
    for sql in queries:
        assert on_card.query(sql) == on_cpu.query(sql)
    for sql in rf2:
        on_cpu.execute(sql)
        hp.reset_launches()
        on_card.execute(sql)
        if sql.startswith("delete"):
            assert hp.LAUNCHES["probe_count"] > 0, sql
    for sql in queries:
        want = on_cpu.query(sql)
        assert want and on_card.query(sql) == want


def test_analyzed_plans_explain_analyze_and_windows_on_card_equal_cpu(card):
    """ANALYZE, EXPLAIN ANALYZE, a window and a view at SF0.01 on the card
    and on the CPU over one catalog: the same plans and rows; on the card
    the operators' dispatches add up to the kernels' launches in the
    statement, and the root's actRows to the query's rows."""
    import re

    from tidb_tpu_torch.ops import hash_probe as hp
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage.catalog import Catalog
    from tidb_tpu_torch.storage.tpch import load_tpch
    from tidb_tpu_torch.storage.tpch_queries import Q

    cat = Catalog()
    load_tpch(cat, sf=0.01)
    on_card, on_cpu = Session(cat), Session(cat, device="cpu")
    on_card.execute("analyze table lineitem, orders, customer, supplier, nation, region")
    for q in ("q1", "q3", "q5", "q18"):
        assert on_card.query("explain " + Q[q][0]) == on_cpu.query("explain " + Q[q][0])
        want = on_cpu.query(Q[q][0])
        port.reset_launches()
        hp.reset_launches()
        rows = on_card.query("explain analyze " + Q[q][0])
        launched = sum(port.LAUNCHES.values()) + sum(hp.LAUNCHES.values())
        text = "\n".join(r[0] for r in rows)
        assert sum(int(n) for n in re.findall(r"dispatches:(\d+)", text)) == launched
        head = rows[0][0]
        act = rows[1][0][head.index("actRows"):head.index("drift")]
        assert int(act) == len(want)
        assert on_card.query(Q[q][0]) == want
    for sql in ("select o_custkey, o_orderkey, rank() over (partition by o_custkey "
                "order by o_totalprice desc) from orders order by 1, 2",
                "create view v as select o_custkey as k, sum(o_totalprice) as t "
                "from orders group by o_custkey",
                "select k, t from v order by t desc, k limit 5"):
        got = on_card.execute(sql)
        if got is not None:
            assert got.rows == on_cpu.query(sql)
        elif sql.startswith("create view"):
            assert cat.view("test", "v") is not None


def _tpch_card_catalog(sf=0.01):
    """TPC-H at `sf` with 1,024-row segments (several staged batches per
    scan) and the device buffer cache off, so every run stages."""
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage.catalog import Catalog
    from tidb_tpu_torch.storage.tpch import load_tpch

    cat = Catalog()
    load_tpch(cat, sf=sf)
    boot = Session(cat, device="cpu")
    for sql in ("set global tidb_tpu_segment_rows = 1024",
                "set global tidb_tpu_device_buffer_cache_bytes = 0",
                "set global tidb_tpu_compaction = 0"):
        boot.execute(sql)
    return cat


def _counted(s, sql):
    """(rows, this thread's launches, staged bytes) of one statement."""
    from tidb_tpu_torch.utils import dispatch

    d0, x0 = dispatch.count(), dispatch.xfer_bytes()
    rows = s.query(sql)
    return rows, dispatch.count() - d0, dispatch.xfer_bytes() - x0


def test_concurrent_statements_count_their_own_launches_and_bytes(card):
    """Four threads run Q1 and Q3 at once on the card, each on its own
    session: rows equal the serial run's, and each statement's launches
    and staged bytes (utils/dispatch, per thread) equal its solo run's."""
    import threading

    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage.tpch_queries import Q

    cat = _tpch_card_catalog()
    solo_s = Session(cat, chunk_capacity=4096)
    for q in ("q1", "q3", "q1", "q3"):  # settle stores, re-sorts, plans
        solo_s.query(Q[q][0])
    solo = {q: _counted(solo_s, Q[q][0]) for q in ("q1", "q3")}
    assert all(n > 0 and x > 0 for _r, n, x in solo.values())
    out, errs = {}, []
    barrier = threading.Barrier(4)

    def run(i):
        s = Session(cat, chunk_capacity=4096)
        order = ("q1", "q3") if i % 2 else ("q3", "q1")
        barrier.wait(30)
        try:
            for rep in range(2):
                for q in order:
                    out[(i, rep, q)] = _counted(s, Q[q][0])
        except Exception as e:  # noqa: BLE001 — asserted below
            errs.append(e)

    ts = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(300)
    assert not any(t.is_alive() for t in ts) and not errs, errs
    assert len(out) == 16
    for (_i, _rep, q), got in out.items():
        assert got == solo[q], q


def test_kill_inside_fused_fragment_on_card_leaves_next_statement_right(card, monkeypatch):
    """A KILL lands mid-fragment while the prefetch thread stages to the
    card (the per-chunk loop never synchronises, so kernels may still be
    queued when the error returns): the typed error, no prefetch thread
    left, no partial cache entry, and the next statements on the card
    equal the CPU's."""
    import threading

    from tidb_tpu_torch.errors import QueryKilledError
    from tidb_tpu_torch.executor import pipeline as pl
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage.tpch_queries import Q

    cat = _tpch_card_catalog()
    s = Session(cat, chunk_capacity=4096)
    s.execute("set global tidb_tpu_device_buffer_cache_bytes = 1073741824")
    on_cpu = Session(cat, device="cpu", chunk_capacity=4096)
    want = {q: on_cpu.query(Q[q][0]) for q in ("q1", "q3")}
    pl.DEVICE_CACHE.clear()
    stage = pl.ChunkPrefetcher._stage
    calls = [0]

    def staging(self, job):
        calls[0] += 1
        if calls[0] == 3:
            s._kill_query = True
        return stage(self, job)

    monkeypatch.setattr(pl.ChunkPrefetcher, "_stage", staging)
    with pytest.raises(QueryKilledError):
        s.query(Q["q1"][0])
    monkeypatch.setattr(pl.ChunkPrefetcher, "_stage", stage)
    assert not [t for t in threading.enumerate()
                if t.name == "tidb-torch-prefetch" and t.is_alive()]
    lineitem = cat.table("test", "lineitem")
    assert all(e["table"] is not lineitem
               for e in pl.DEVICE_CACHE._entries.values())
    for q in ("q1", "q3", "q1"):
        assert s.query(Q[q][0]) == want[q], q


def test_delta_table_through_fused_path_after_buffered_inserts(card):
    """orders as a delta table: single-row INSERTs stay in the memtable,
    and the first fused aggregation and the first join on the card see
    them (equal to the CPU over the same catalog), through tidb_segagg
    and tidb_probe_count."""
    import chip_smoke

    from tidb_tpu_torch.executor import pipeline as pl
    from tidb_tpu_torch.ops import hash_probe as hp
    from tidb_tpu_torch.session import Session

    cat = _tpch_card_catalog()
    s = Session(cat, chunk_capacity=4096)
    on_cpu = Session(cat, device="cpu", chunk_capacity=4096)
    s.execute(chip_smoke.no_key_ddl(s, "orders", "orders_d", "delta"))
    s.execute("insert into orders_d select * from orders")
    agg = ("select o_orderpriority, count(*), sum(o_totalprice) from orders_d "
           "group by o_orderpriority order by o_orderpriority")
    join = ("select o_orderpriority, count(*), sum(l_extendedprice) from orders_d "
            "join lineitem on l_orderkey = o_orderkey where o_orderdate >= '1995-01-01' "
            "group by o_orderpriority order by o_orderpriority")
    s.query(agg)
    t = cat.table("test", "orders_d")
    for round_ in range(2):
        for i in range(20):
            k = 9_000_000 + 100 * round_ + i
            s.execute(f"insert into orders_d values ({k}, 1, 'O', {100 + i}.25, "
                      f"'1996-0{1 + i % 9}-11', '1-URGENT', 'Clerk#1', 0, 'new')")
        assert t.buffered_rows == 20
        port.reset_launches()
        hp.reset_launches()
        fused0 = dict(pl.PIPELINE_FUSED_TOTAL)
        got_agg, got_join = s.query(agg), s.query(join)
        assert t.buffered_rows == 0
        assert port.LAUNCHES["segagg"] > 0 and hp.LAUNCHES["probe_count"] > 0
        assert pl.PIPELINE_FUSED_TOTAL["agg"] > fused0["agg"]
        # the join fuses its probe, or (once the INSERTs' commits have
        # analyzed orders_d) its eager aggregation over lineitem
        assert (pl.PIPELINE_FUSED_TOTAL["probe"] + pl.PIPELINE_FUSED_TOTAL["generic"]
                > fused0["probe"] + fused0["generic"])
        assert got_agg == on_cpu.query(agg)
        assert got_join == on_cpu.query(join)
        assert sum(r[1] for r in got_agg) == 15_000 + 20 * (round_ + 1)


def test_ctas_result_scanned_by_segagg(card):
    """CREATE TABLE ... AS SELECT on the card, then a fused aggregation
    over the result: tidb_segagg launches, and the rows equal the CPU's."""
    from tidb_tpu_torch.session import Session

    cat = _tpch_card_catalog()
    s = Session(cat, chunk_capacity=4096)
    on_cpu = Session(cat, device="cpu", chunk_capacity=4096)
    s.execute("create table rev as select l_orderkey, l_returnflag, "
              "sum(l_extendedprice * (1 - l_discount)) as revenue "
              "from lineitem group by l_orderkey, l_returnflag")
    assert cat.table("test", "rev").n == on_cpu.query("select count(*) from rev")[0][0] > 0
    sql = ("select l_returnflag, count(*), sum(revenue) from rev "
           "group by l_returnflag order by l_returnflag")
    port.reset_launches()
    got = s.query(sql)
    assert port.LAUNCHES["segagg"] > 0
    assert got == on_cpu.query(sql)


def test_temporary_fused_scan_beside_permanent_in_another_session(card):
    """One session's temp `orders` (1,000 rows) shadows the permanent one;
    another session's fused scan of the same SQL reads the permanent
    table. Both run on the card, alternately, and equal the CPU."""
    import chip_smoke

    from tidb_tpu_torch.executor import pipeline as pl
    from tidb_tpu_torch.session import Session

    cat = _tpch_card_catalog()
    a, b = Session(cat, chunk_capacity=4096), Session(cat, chunk_capacity=4096)
    on_cpu = Session(cat, device="cpu", chunk_capacity=4096)
    a.execute(chip_smoke.no_key_ddl(a, "orders", "orders", "columnar")
              .replace("CREATE TABLE", "CREATE TEMPORARY TABLE", 1))
    a.execute("insert into orders values " + ", ".join(
                  f"({k}, {k % 100 + 1}, 'F', {k}.50, '1995-03-0{1 + k % 9}', "
                  f"'{1 + k % 5}-X', 'Clerk', 0, 'tmp')" for k in range(1, 1001)))
    sql = ("select o_orderpriority, count(*), sum(o_totalprice) from orders "
           "group by o_orderpriority order by o_orderpriority")
    want_perm = on_cpu.query(sql)
    for _ in range(2):
        port.reset_launches()
        fused0 = pl.PIPELINE_FUSED_TOTAL["agg"]
        got_a, got_b = a.query(sql), b.query(sql)
        assert port.LAUNCHES["segagg"] >= 2
        assert pl.PIPELINE_FUSED_TOTAL["agg"] >= fused0 + 2
        assert sum(r[1] for r in got_a) == 1000
        assert got_b == want_perm
        assert sum(r[1] for r in got_b) == 15_000
    a.catalog.drop_temp_tables()
    assert a.query(sql) == want_perm


def test_spilled_sort_and_aggregation_on_card_equal_the_plain_path(card):
    """Under a MEMORY_QUOTA that forces a spill, an ORDER BY over lineitem
    and the host generic aggregation on the card equal the CPU session's
    unspilled rows; the statements spill and every tracker ends at 0."""
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.utils import dispatch

    cat = _tpch_card_catalog()
    s = Session(cat, chunk_capacity=4096)
    on_cpu = Session(cat, device="cpu", chunk_capacity=4096)
    sort = ("select {h}l_orderkey, l_linenumber, l_extendedprice from lineitem "
            "order by l_extendedprice desc, l_orderkey, l_linenumber")
    agg = ("select {h}l_orderkey, count(*), sum(l_quantity), max(l_extendedprice) "
           "from lineitem group by l_orderkey order by l_orderkey")
    s.execute("set tidb_device_engine_mode = 'off'")
    for sql in (sort, agg):
        trackers = []
        orig = s._exec_ctx

        def spy(**kw):
            ctx = orig(**kw)
            trackers.append(ctx.mem_tracker)
            return ctx

        s._exec_ctx = spy
        sp0 = dispatch.spill_bytes()
        got = s.query(sql.format(h="/*+ MEMORY_QUOTA(256 KB) */ "))
        del s._exec_ctx
        assert dispatch.spill_bytes() > sp0
        assert got == on_cpu.query(sql.format(h=""))
        assert trackers and all(t.consumed == 0 for t in trackers)


def test_fused_probe_under_raised_join_tiles_equals_plain_probe(card):
    """A many-to-many join whose fused probe overflows its first tile:
    plan feedback records the overflow, the second run's join_tiles is
    raised by the tile hint, and both runs equal the CPU session's rows
    (the plain probe_count path)."""
    from tidb_tpu_torch.ops import hash_probe as hp
    from tidb_tpu_torch.planner import feedback as fb
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage.catalog import Catalog

    fb.STORE.on_schema_change()
    cat = Catalog()
    s = Session(cat, chunk_capacity=4096)
    on_cpu = Session(cat, device="cpu", chunk_capacity=4096)
    s.execute("create table dup (k bigint, v bigint)")
    k = np.arange(20000, dtype=np.int64)
    cat.table("test", "dup").insert_columns({"k": k % 200, "v": k})
    sql = ("select a.k, count(*), sum(b.v) from dup a join dup b on a.k = b.k "
           "group by a.k order by a.k")
    want = on_cpu.query(sql)
    fb.STORE.on_schema_change()  # the CPU run's observations go
    tiles = []
    orig = s._exec_ctx

    def spy(**kw):
        ctx = orig(**kw)
        tiles.append(ctx.join_tiles)
        return ctx

    s._exec_ctx = spy
    for _ in range(2):
        hp.reset_launches()
        assert s.query(sql) == want
        assert hp.LAUNCHES["probe_count"] > 0
    assert tiles[0] == 8 and tiles[-1] > 8, tiles
    fb.STORE.on_schema_change()


def test_four_shard_mesh_on_card_equals_cpu_mesh(card):
    """The mesh tier with four shards on one card (the all_to_all exchange
    and the merges on the card, tidb_segagg and tidb_probe_count launched
    per shard) against the same mesh of four CPU shards: Q1, Q3 and Q18 at
    SF0.01, rows exactly equal (decimals exact, AVG finalized on the host
    from exact sums)."""
    from tidb_tpu_torch.ops import hash_probe as hp
    from tidb_tpu_torch.parallel import make_mesh
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage.catalog import Catalog
    from tidb_tpu_torch.storage.tpch import load_tpch
    from tidb_tpu_torch.storage.tpch_queries import Q

    cat = Catalog()
    load_tpch(cat, sf=0.01)
    on_card = Session(cat, mesh=make_mesh(n_shards=4, devices=[card] * 4))
    on_cpu = Session(cat, mesh=make_mesh(n_shards=4, devices=[torch.device("cpu")] * 4))
    for q in ("q1", "q3", "q18"):
        port.reset_launches()
        hp.reset_launches()
        got = on_card.query(Q[q][0])
        assert port.LAUNCHES["segagg"] + hp.LAUNCHES["probe_count"] > 0, q
        if q != "q1":
            assert hp.LAUNCHES["probe_count"] > 0, q
        assert got == on_cpu.query(Q[q][0]), q


def test_four_shard_mesh_replays_its_fragments_as_eagerly(card, monkeypatch):
    """The mesh's fragments as CUDA graphs (utils/jitcache.py) on four
    shards over the card at SF0.1: Q1's, Q3's and Q18's rows and kernel
    launches by replay (the third graph run: every mesh program a replay)
    equal the eager path's (jitcache.eager()). A capture that fails (a
    host read inside a collective) raises, and the signature warms up
    again afterwards."""
    from tidb_tpu_torch.ops import hash_probe as hp
    from tidb_tpu_torch.parallel import make_mesh
    from tidb_tpu_torch.parallel import mesh as mesh_mod
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage.catalog import Catalog
    from tidb_tpu_torch.storage.tpch import load_tpch
    from tidb_tpu_torch.storage.tpch_queries import Q
    from tidb_tpu_torch.utils import jitcache

    cat = Catalog()
    load_tpch(cat, sf=0.1)
    s = Session(cat, mesh=make_mesh(n_shards=4, devices=[card] * 4))
    jitcache.set_graphs(True)
    jitcache.clear()
    mesh_ns = ("distagg", "distjoinagg", "fragment")
    for q in ("q1", "q3", "q18"):
        with jitcache.eager():
            s.query(Q[q][0])  # cold: shards the tables, proves the capacities
            port.reset_launches()
            hp.reset_launches()
            want = s.query(Q[q][0])
            eager = {**port.LAUNCHES, **hp.LAUNCHES}
        for run in range(3):
            port.reset_launches()
            hp.reset_launches()
            jitcache.reset_runs()
            assert s.query(Q[q][0]) == want, (q, run)
        assert {**port.LAUNCHES, **hp.LAUNCHES} == eager, q
        runs = {ns: r for ns, r in jitcache.runs().items() if ns in mesh_ns}
        assert runs and all(set(r) == {"replay"} for r in runs.values()), (q, runs)

    jitcache.clear()
    real = mesh_mod._reduce

    def host_read(op, parts, mesh):
        float(parts[0].sum())  # a device->host read: illegal inside a capture
        return real(op, parts, mesh)

    monkeypatch.setattr(mesh_mod, "_reduce", host_read)
    sql = Q["q1"][0]
    want = s.query(sql)  # the warm-up (eager)
    with pytest.raises(Exception):
        s.query(sql)  # the capture
    monkeypatch.setattr(mesh_mod, "_reduce", real)
    jitcache.reset_runs()
    assert s.query(sql) == want
    assert jitcache.runs()["distagg"] == {"eager": 1}


def _snapshot_launches(snap):
    """{kernel entry: launches} from one process's metrics snapshot (the
    `metrics_snapshot` RPC's payload)."""
    for m in snap["metrics"]:
        if m["name"] == "tidb_tpu_device_dispatch_total":
            return {labels.get("site"): int(v) for labels, v in m["samples"]}
    return {}


def test_dcn_worker_process_on_card_runs_q1_partial_through_segagg(card):
    """A DCN worker subprocess on cuda (`python -m
    tidb_tpu_torch.parallel.dcn --device cuda`) holds lineitem at SF0.01
    as its partition; the coordinator's Q1 runs the partial there, and
    the worker's own counters (read over the metrics_snapshot RPC) show
    tidb_segagg launches. The rows equal one CPU session's."""
    import os
    import re
    import subprocess
    import sys

    from tidb_tpu_torch.parallel.dcn import Cluster
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.sharding.shuffle import extract_live_columns
    from tidb_tpu_torch.storage.catalog import Catalog
    from tidb_tpu_torch.storage.tpch import load_tpch
    from tidb_tpu_torch.storage.tpch_queries import Q

    cat = Catalog()
    load_tpch(cat, sf=0.01)
    cpu = Session(cat, device="cpu")
    li = cat.table("test", "lineitem")
    ddl = cpu.query("show create table lineitem")[0][1]
    a, v, s, _n = extract_live_columns(li)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = subprocess.Popen([sys.executable, "-m", "tidb_tpu_torch.parallel.dcn",
                          "--device", "cuda"], stdout=subprocess.PIPE,
                         text=True, cwd=repo)
    try:
        m = re.search(r"DCN_WORKER_PORT=(\d+)", p.stdout.readline())
        assert m
        cl = Cluster([("127.0.0.1", int(m.group(1)))], device="cpu")
        try:
            cl.broadcast_exec(ddl)
            cl.load_partition(0, "lineitem", arrays=a, valids=v, strings=s)
            before = _snapshot_launches(cl.metrics_snapshots()[0][1])
            got = cl.query(Q["q1"][0])
            after = _snapshot_launches(cl.metrics_snapshots()[0][1])
            assert after.get("segagg", 0) > before.get("segagg", 0)
            assert got == cpu.query(Q["q1"][0])
        finally:
            cl.shutdown()
        assert p.wait(timeout=60) == 0
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()


def test_sanitized_statements_on_card_count_their_fetches(card):
    """The sanitizer on the card's path: Q1, Q3 and Q18 sanitized give the
    CPU session's rows; each statement's sanctioned device->host fetches
    (dispatch.device_get, what tidb_tpu_sanitize_sync_budget limits) are
    counted, at least one (Q3 two or more), and a budget of one fails Q3; a scan
    whose pins are never closed raises SanitizerError."""
    from tidb_tpu_torch.analysis import sanitizer as san
    from tidb_tpu_torch.columnar import store as st
    from tidb_tpu_torch.errors import SanitizerError
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage.tpch_queries import Q
    from tidb_tpu_torch.utils import dispatch

    cat = _tpch_card_catalog()
    on_card, on_cpu = Session(cat), Session(cat, device="cpu")
    san.disable()
    on_card.execute("set tidb_tpu_sanitize = 1")
    try:
        counts = {}
        for q in ("q1", "q3", "q18"):
            f0 = dispatch.fetch_count()
            assert on_card.query(Q[q][0]) == on_cpu.query(Q[q][0]), q
            counts[q] = dispatch.fetch_count() - f0
            assert counts[q] >= 1, q
        assert not [f for f in san.report()["findings"] if f["fatal"]]
        assert counts["q3"] >= 2, counts
        # the budget's floor: a later run's count can differ from the
        # first's (that one built the segment stores), never below 2
        on_card.execute("set tidb_tpu_sanitize_sync_budget = 1")
        with pytest.raises(SanitizerError, match="host-sync-budget"):
            on_card.query(Q["q3"][0])
        on_card.execute("set tidb_tpu_sanitize_sync_budget = 4096")
        leaked, real = [], st.ScanPin.close
        st.ScanPin.close = lambda self: leaked.append(self)
        try:
            with pytest.raises(SanitizerError, match="pin-leak"):
                on_card.query(Q["q6"][0])
        finally:
            st.ScanPin.close = real
            for pin in leaked:
                pin.close()
        assert leaked
    finally:
        on_card.execute("set tidb_tpu_sanitize = 0")
        san.disable()


def test_bench_segsum_on_card_is_exact(card, tmp_path):
    """The segment kernels' microbenchmark on the card: every exactness
    flag true and every time measured, beside index_add_."""
    from tidb_tpu_torch.ops import bench_segsum

    out = tmp_path / "bench.json"
    assert bench_segsum.main(["--rows", str(1 << 18), "--reps", "5", "--out", str(out)]) == 0
    import json

    res = json.loads(out.read_text())
    assert res["route"] == "cuda" and res["device"]["platform"] == "gpu"
    assert res["all_exact"]
    assert all(c["count_ms"] > 0 and c["i64_index_add_ms"] > 0 for c in res["configs"])


# -- one device program per fused batch (utils/jitcache.py) -------------------

GRAPH_QUERIES = ("q1", "q6", "q3", "q5", "q18", "topn")


def _graph_sql(q):
    from tidb_tpu_torch.storage.tpch_queries import Q

    if q == "topn":
        return ("select l_orderkey, l_linenumber, l_extendedprice from lineitem "
                "where l_shipdate >= date '1995-01-01' order by l_extendedprice desc "
                "limit 10")
    if q == "q18":
        return Q["q18"][0].replace("> 300", "> 200")
    return Q[q][0]


def _graph_session():
    """SF0.01 on the card with 1,024-row segments, the device buffer cache
    off (every run stages), graphs on and the cache empty."""
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.utils import jitcache

    jitcache.set_graphs(True)
    jitcache.clear()
    return Session(_tpch_card_catalog(), chunk_capacity=1 << 12)


def test_graph_replay_equals_eager_bit_for_bit(card):
    """Each query's rows by CUDA-graph replay equal its eager rows (the
    explicit switch) exactly, run after run, with the same kernel launches
    and fetches; by the third run every fused batch replays."""
    from tidb_tpu_torch.ops import hash_probe as hp
    from tidb_tpu_torch.utils import dispatch, jitcache

    s = _graph_session()
    for q in GRAPH_QUERIES:
        sql = _graph_sql(q)
        with jitcache.eager():
            s.query(sql)  # settle plans and stores
            port.reset_launches()
            hp.reset_launches()
            f0 = dispatch.fetch_count()
            want = s.query(sql)
            eager = ({**port.LAUNCHES, **hp.LAUNCHES}, dispatch.fetch_count() - f0)
        assert want, q
        for run in range(3):
            jitcache.reset_runs()
            port.reset_launches()
            hp.reset_launches()
            f0 = dispatch.fetch_count()
            got = s.query(sql)
            assert got == want, (q, run)
            assert ({**port.LAUNCHES, **hp.LAUNCHES},
                    dispatch.fetch_count() - f0) == eager, (q, run)
        runs = jitcache.runs()
        assert runs and all(set(r) == {"replay"} for r in runs.values()), (q, runs)


def test_probe_window_and_generic_stack_keep_results_across_replays(card):
    """A fused probe over more than PROBE_SYNC_CHUNKS batches (its window's
    tokens held across 8 replays) and a fused generic aggregation of many
    partial tables on its stack give the CPU's rows by replay."""
    from tidb_tpu_torch.executor import pipeline as pl
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.utils import jitcache

    s = _graph_session()
    on_cpu = Session(s.catalog.base, chunk_capacity=1 << 12, device="cpu")
    probe = ("select l_orderkey, count(*), sum(l_quantity) from lineitem join orders "
             "on l_orderkey = o_orderkey where o_orderdate < date '1996-01-01' "
             "group by l_orderkey order by l_orderkey limit 50")
    stack = ("select l_partkey, sum(l_quantity), count(*) from lineitem "
             "group by l_partkey order by l_partkey")
    for sql in (probe, stack):
        want = on_cpu.query(sql)
        for _ in range(3):
            pl.reset_counters()
            jitcache.reset_runs()
            assert s.query(sql) == want
        assert sum(r.get("replay", 0) for r in jitcache.runs().values()) > \
            pl.FusedScanProbeExec.PROBE_SYNC_CHUNKS


def test_capture_on_one_thread_while_another_runs_statements(card):
    """One thread captures graphs (an empty cache, Q18's and Q5's
    signatures) while another runs statements eagerly and by replay on
    its own session: both get the CPU's rows."""
    import threading

    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.utils import jitcache

    s = _graph_session()
    other = Session(s.catalog.base, chunk_capacity=1 << 12)
    on_cpu = Session(s.catalog.base, chunk_capacity=1 << 12, device="cpu")
    want = {q: on_cpu.query(_graph_sql(q)) for q in ("q1", "q3", "q5", "q18")}
    for q in ("q1", "q3"):
        other.query(_graph_sql(q))
    errs, stop = [], threading.Event()

    def runner():
        try:
            while not stop.is_set():
                for q in ("q1", "q3"):
                    assert other.query(_graph_sql(q)) == want[q], q
        except Exception as e:  # noqa: BLE001 — asserted below
            errs.append(e)

    t = threading.Thread(target=runner)
    t.start()
    try:
        for _ in range(3):
            jitcache.clear()  # every run of this thread captures again
            for q in ("q5", "q18"):
                for _ in range(3):
                    assert s.query(_graph_sql(q)) == want[q], q
    finally:
        stop.set()
        t.join(300)
    assert not t.is_alive() and not errs, errs


def test_first_calls_on_two_threads_and_an_evicted_lookup_table_capture_cleanly(card):
    """Two threads in a signature's first call at once both warm up (no
    capture of a half-done warm-up), and a lookup table evicted from the
    compiler's cache between the warm-up and the capture is the warm-up's
    tensor in the graph, not an upload inside the capture: the replays
    give the eager results."""
    import threading

    import numpy as np

    from tidb_tpu_torch.expression import compiler
    from tidb_tpu_torch.utils import dispatch, jitcache

    jitcache.set_graphs(True)
    jitcache.clear()
    jitcache.reset_runs()
    values = tuple(range(1000, 1512))
    both_inside = threading.Barrier(2, timeout=60)
    calls = []

    def fn(idx):
        calls.append(dispatch.capturing())
        if len(calls) <= 2:
            both_inside.wait()
        return compiler._device_table(values, np.int64, idx.device)[idx] * 3

    prog = jitcache.cached_jit("t", "card-race", lambda: fn)
    base = torch.arange(0, 504, 7)
    idx = base.to(card)
    want = (base + 1000) * 3
    out, errs = [], []

    def first():
        try:
            out.append(prog(idx).cpu())
        except Exception as e:  # noqa: BLE001 — asserted below
            errs.append(e)

    ts = [threading.Thread(target=first) for _ in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    assert not errs and len(out) == 2 and all(torch.equal(o, want) for o in out)
    assert calls == [False, False] and jitcache.runs()["t"] == {"eager": 2}
    with compiler._TABLES_LOCK:
        compiler._TABLES.clear()
    for i in range(3):  # the capture, then replays on fresh inputs
        got = prog((base + i).to(card)).cpu()
        assert torch.equal(got, (base + i + 1000) * 3)
    assert jitcache.runs()["t"] == {"eager": 2, "capture": 1, "replay": 2}
    jitcache.clear()
