"""The port's open-addressing hash probe (tidb_tpu_torch/ops/hash_probe.py)
against the JAX package's (tidb_tpu/ops/hash_probe.py) on the same seeded
numpy inputs. The reference's Pallas probe runs in interpret mode on the
CPU, as tests/test_ops_probe.py runs it; the port's probe takes its plain
window scan (the B3 kernel itself needs a card: tests/test_torch_cuda.py).

Tolerance: exact. The mix and the table are bit-equal; probe ranges equal
the reference's counts everywhere and its `lo` wherever the count is
non-zero (the join reads nothing else)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidb_tpu.ops import hash_probe as ref
from tidb_tpu_torch.ops import hash_probe as hp
from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)

I64 = np.iinfo(np.int64)
M64 = (1 << 64) - 1


def _unshift(y: int, s: int) -> int:
    """Inverse of x ^ (x >> s) on 64 bits."""
    x, t = y, y >> s
    while t:
        x ^= t
        t >>= s
    return x


def empty_preimage(salt: int) -> int:
    """The int64 key whose splitmix64 tail (with `salt`) has low 32 bits
    0x7FFFFFFF, the table's EMPTY sentinel: the finalizer is invertible."""
    y = 0x7FFFFFFF
    h = _unshift(y, 31)
    h = (h * pow(0x94D049BB133111EB, -1, 1 << 64)) & M64
    h = _unshift(h, 27)
    h = (h * pow(0xBF58476D1CE4E5B9, -1, 1 << 64)) & M64
    h = _unshift(h, 30) ^ salt
    return h - (1 << 64) if h >= (1 << 63) else h


PREIMAGES = [empty_preimage(0), empty_preimage(ref._FP_SALT)]


def _mix_raw(key: int, salt: int) -> int:
    """Unremapped low 32 bits of the tail, in Python ints."""
    h = (key & M64) ^ salt
    h = ((h ^ (h >> 30)) * 0xBF58476D1CE4E5B9) & M64
    h = ((h ^ (h >> 27)) * 0x94D049BB133111EB) & M64
    return (h ^ (h >> 31)) & 0xFFFFFFFF


def test_preimages_hit_the_sentinel():
    assert _mix_raw(PREIMAGES[0], 0) == 0x7FFFFFFF
    assert _mix_raw(PREIMAGES[1], ref._FP_SALT) == 0x7FFFFFFF


@pytest.mark.parametrize("salt", [0, ref._FP_SALT], ids=["home", "fingerprint"])
def test_mix32_bit_equal(salt):
    rng = np.random.default_rng(11)
    keys = np.concatenate([
        rng.integers(I64.min, I64.max, 100_000, dtype=np.int64, endpoint=True),
        np.array([I64.min, I64.min + 1, -1, 0, 1, I64.max - 1, I64.max,
                  0x7FFFFFFF, *PREIMAGES], dtype=np.int64)])
    want = np.asarray(ref._mix32(jnp.asarray(keys), salt))
    got = hp._mix32(torch.from_numpy(keys), salt)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().astype(np.int32), want)
    assert (got.numpy() == want.astype(np.int64)).all()  # in int32 range
    assert not (want == 0x7FFFFFFF).any()


def test_table_capacity_equal():
    for n in [0, 1, 7, 8, 9, 63, 64, 65, 1000, 1 << 17, hp.MAX_CAPACITY // 2,
              hp.MAX_CAPACITY // 2 + 1, hp.MAX_CAPACITY]:
        assert hp.table_capacity(n) == ref.table_capacity(n), n
    assert hp.MAX_CAPACITY == ref.MAX_CAPACITY
    assert hp.MAX_PROBES == ref.MAX_PROBES


def _grids():
    """The build/probe grids of tests/test_ops_probe.py:31-92."""
    r1 = np.random.default_rng(1)
    r2 = np.random.default_rng(2)
    r3 = np.random.default_rng(3)
    r9 = np.random.default_rng(9)
    out = {
        "random_dups": (r1.integers(-500, 500, 4000) * 7919,
                        r1.integers(-800, 800, 9000) * 7919),
        "unique_dense": (r2.permutation(50_000), r2.integers(-10_000, 60_000, 80_000)),
        "all_absent": (np.arange(0, 1000, 2), np.arange(1, 1001, 2)),
        "all_present": (np.arange(0, 1000, 2), np.arange(0, 1000, 2)),
        "tiny": (np.array([42]), np.array([42, 43])),
        "empty": (np.array([], dtype=np.int64), np.array([1, 2, 3])),
        "same_home_cluster": (np.arange(64) * (1 << 40), np.arange(-8, 72) * (1 << 40)),
        "over_capacity": (r3.integers(0, 1 << 40, hp.MAX_CAPACITY),
                          r3.integers(0, 1 << 40, 1000)),
        "full_int64": (np.array([I64.min, I64.min + 1, -1, 0, 1, I64.max - 1,
                                 I64.max, I64.max]),
                       np.array([I64.min, I64.min + 2, -1, 0, 2, I64.max,
                                 I64.max - 1, 7])),
        "sentinel_values": (np.array([0x7FFFFFFF, 0x7FFFFFFF, 0x7FFFFFFE, 0]),
                            np.array([0x7FFFFFFF, 0x7FFFFFFF, 0x7FFFFFFE, 0])),
        "empty_preimages": (np.array(PREIMAGES + [5]), np.array(PREIMAGES + [5, 6])),
    }
    for n in (7, 8, 9, 255, 256, 257):
        out[f"capacity_{n}"] = (r9.integers(0, 1 << 30, n) * 2654435761,
                                r9.integers(0, 1 << 30, 512) * 2654435761)
    return {k: (np.sort(np.asarray(b, dtype=np.int64)), np.asarray(p, dtype=np.int64))
            for k, (b, p) in out.items()}


GRIDS = _grids()


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_build_table_bit_equal(name):
    sh, _ = GRIDS[name]
    cap = hp.table_capacity(len(sh))
    if cap is None:
        assert ref.table_capacity(len(sh)) is None
        return
    want = ref._build_table(jnp.asarray(sh), cap)
    got = hp.build_table(torch.from_numpy(sh), cap)
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert bool(got[3]) == bool(want[3])


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_probe_ranges_match_reference(name):
    sh, pr = GRIDS[name]
    lo_w, hi_w = (np.asarray(a) for a in ref.probe_ranges(
        jnp.asarray(sh), jnp.asarray(pr), use_pallas=True))
    lo, hi = (a.numpy() for a in hp.probe_ranges(torch.from_numpy(sh), torch.from_numpy(pr)))
    cnt, cnt_w = hi - lo, hi_w - lo_w
    np.testing.assert_array_equal(cnt, cnt_w)
    np.testing.assert_array_equal(lo[cnt > 0], lo_w[cnt_w > 0])


@pytest.mark.parametrize("name", ["random_dups", "same_home_cluster", "full_int64",
                                  "sentinel_values", "empty_preimages", "capacity_257"])
def test_plain_probe_bit_equal_to_window_scan(name):
    """The plain version is the reference's `_probe_xla`, pair for pair,
    misses included (where both give (0, 0))."""
    sh, pr = GRIDS[name]
    cap = hp.table_capacity(len(sh))
    t = ref._build_table(jnp.asarray(sh), cap)
    lo_w, hi_w = ref._probe_xla(*t[:3], jnp.asarray(sh), jnp.asarray(pr), cap)
    tt = hp.build_table(torch.from_numpy(sh), cap)
    lo, hi = hp.probe_table(*tt[:3], torch.from_numpy(sh), torch.from_numpy(pr))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(lo_w))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(hi_w))


def test_resolve_mode_routes():
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert [hp.resolve_mode(m, cpu) for m in ("off", "auto", "xla", "pallas")] == \
        ["sorted", "sorted", "table", "table"]
    assert [hp.resolve_mode(m, cuda) for m in ("off", "auto", "xla", "pallas")] == \
        ["sorted", "table", "table", "table"]
    # the reference's CPU resolution agrees where both run the same route
    assert ref.resolve_mode("off") == "sorted" and ref.resolve_mode("auto") == "sorted"


def test_cpu_probe_counts_no_launch():
    hp.reset_launches()
    sh, pr = GRIDS["random_dups"]
    hp.probe_ranges(torch.from_numpy(sh), torch.from_numpy(pr))
    assert hp.LAUNCHES == {"probe_count": 0, "hash_probe": 0}
