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
from exact sums). The hash-probe cases are chip_smoke.py's phase-1 cases,
imported from the repository root (run from there)."""

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


def test_joins_on_card_equal_cpu(card):
    """Q3, Q5 and Q18 at SF0.01 on cuda equal the port on the CPU; Q18's
    semi join goes through the table route and launches B3."""
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
        if q == "q18":
            assert hp.LAUNCHES["hash_probe"] > 0 and jk.PROBE_ROUTES["table"] > 0
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
