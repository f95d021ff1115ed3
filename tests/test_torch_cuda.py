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
