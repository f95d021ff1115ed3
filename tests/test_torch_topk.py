"""The port's bounded top-k state (tidb_tpu_torch/ops/topk.py) against the
reference's (tidb_tpu/ops/topk.py, jitted on the CPU) on identical inputs
made from a seed with numpy: ASC and DESC, NULLs and NaN (and -0.0), heavy
ties resolved in drain order, single-key chunks larger than the state (the
threshold cut) and multi-key chunks (the full merge), and one chunk above
4 x 8,192 rows, where the reference takes its sampled threshold path. Every
live slot of the state (dead flag, rank operands, drain position, payload)
and the drain counter compare exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidb_tpu.ops import topk as jtk
from tidb_tpu_torch.ops import topk as ptk
from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings("ignore:Some donated buffers were not usable")


def _float_key(rng, n, heavy_ties: bool):
    vals = rng.integers(0, 4 if heavy_ties else 1000, n).astype(np.float64) - 2.0
    vals[rng.random(n) < 0.05] = np.nan
    vals[rng.random(n) < 0.03] = -0.0
    return vals, rng.random(n) < 0.9


def _int_key(rng, n, heavy_ties: bool):
    return rng.integers(-3, 3 if heavy_ties else 10**6, n).astype(np.int64), rng.random(n) < 0.9


def _chunks(seed, n_chunks, N, key_kinds, heavy_ties):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_chunks):
        keys = [(_float_key if k == "float" else _int_key)(rng, N, heavy_ties)
                for k in key_kinds]
        payload = [(rng.integers(-10**9, 10**9, N).astype(np.int64), rng.random(N) < 0.9),
                   (rng.standard_normal(N), rng.random(N) < 0.9)]
        out.append((keys, payload, rng.random(N) < 0.8))
    return out


def _run_both(chunks, key_kinds, descs, cap, with_descs=True):
    floats = [k == "float" for k in key_kinds]
    jstate = jtk.topk_init(cap, floats, [np.dtype(np.int64), np.dtype(np.float64)])
    pstate = ptk.topk_init(cap, floats, [torch.int64, torch.float64], "cpu")
    for keys, payload, sel in chunks:
        jpairs = [jtk.rank_operands(jnp.asarray(d), jnp.asarray(v), desc)
                  for (d, v), desc in zip(keys, descs)]
        ppairs = [ptk.rank_operands(torch.from_numpy(d), torch.from_numpy(v), desc)
                  for (d, v), desc in zip(keys, descs)]
        jstate = jtk.merge_topk(jstate, jpairs, [(jnp.asarray(d), jnp.asarray(v))
                                                 for d, v in payload],
                                jnp.asarray(sel), descs if with_descs else None)
        pstate = ptk.merge_topk(pstate, ppairs, [(torch.from_numpy(d), torch.from_numpy(v))
                                                 for d, v in payload],
                                torch.from_numpy(sel), descs if with_descs else None)
    return jstate, pstate


def _flat(state):
    dead, ranks, pos, next_pos, payload = state
    arrays = [dead] + [a for pair in ranks for a in pair] + [pos] + [a for pair in payload
                                                                     for a in pair]
    return [np.asarray(a) for a in arrays], int(np.asarray(next_pos))


def _bits(a):
    return a.view(np.int64) if a.dtype == np.float64 else a


def assert_states_equal(jstate, pstate):
    (jarr, jnext), (parr, pnext) = _flat(jstate), _flat(pstate)
    assert pnext == jnext
    live = jarr[0] == 0
    np.testing.assert_array_equal(parr[0], jarr[0])  # the dead flags, slot for slot
    assert live.any()
    for r, g in zip(jarr, parr):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(_bits(g[live]), _bits(r[live]))


CASES = {
    # name: (key kinds, chunk rows N, chunks, state capacity C, heavy ties)
    "single_float_cut": (["float"], 512, 3, 64, False),
    "single_float_ties_cut": (["float"], 512, 3, 64, True),
    "single_int_cut": (["int"], 512, 3, 64, True),
    "single_float_small_chunks": (["float"], 48, 4, 64, True),
    "multi_key": (["float", "int"], 300, 3, 64, True),
    "multi_key_three": (["int", "float", "int"], 200, 3, 128, True),
}


@pytest.mark.parametrize("desc", [False, True], ids=["asc", "desc"])
@pytest.mark.parametrize("name", list(CASES))
def test_merge_matches_reference(name, desc):
    kinds, N, n_chunks, cap, ties = CASES[name]
    chunks = _chunks(10 * list(CASES).index(name) + desc, n_chunks, N, kinds, ties)
    descs = tuple(desc if i % 2 == 0 else not desc for i in range(len(kinds)))
    jstate, pstate = _run_both(chunks, kinds, descs, cap)
    assert_states_equal(jstate, pstate)


@pytest.mark.parametrize("desc", [False, True], ids=["asc", "desc"])
def test_full_merge_without_descs(desc):
    """No descs: a single-key chunk larger than C takes the full merge."""
    chunks = _chunks(21 + desc, 2, 400, ["float"], True)
    jstate, pstate = _run_both(chunks, ["float"], (desc,), 64, with_descs=False)
    assert_states_equal(jstate, pstate)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "heavy_ties"])
@pytest.mark.parametrize("desc", [False, True], ids=["asc", "desc"])
def test_sampled_threshold_path(desc, ties):
    """One chunk above 4 x 8,192 rows: the reference estimates the threshold
    from a sample (falling back to its full sort when the estimate keeps
    too few or too many rows); the port sorts in full. Exact either way."""
    chunks = _chunks(31 + 2 * desc + ties, 1, 40_000, ["float"], ties)
    jstate, pstate = _run_both(chunks, ["float"], (desc,), 128)
    assert_states_equal(jstate, pstate)


def test_float_order_key_is_xla_order():
    """float_order_key orders -inf < ... < -0.0 == 0.0 < ... < inf < NaN."""
    x = torch.tensor([np.nan, 1.0, -0.0, 0.0, -np.inf, np.inf, -1.5, -np.nan, 2.0],
                     dtype=torch.float64)
    k = ptk.float_order_key(x)
    order = torch.sort(k, stable=True).indices.tolist()
    assert order == [4, 6, 2, 3, 1, 8, 5, 0, 7]
    assert k[2] == k[3] and k[0] == k[7]
