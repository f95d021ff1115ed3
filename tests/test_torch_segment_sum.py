"""The port's segment-aggregation functions (tidb_tpu_torch/ops/segment_sum.py)
against the JAX package's (tidb_tpu/ops/segment_sum.py) on identical
numpy-seeded inputs.

On the CPU the port's wrappers run their plain PyTorch versions; the JAX
functions run their Pallas kernels in interpret mode (forced on, as
tests/test_ops.py does), or the XLA path where the JAX dispatcher takes it
(G above 8192). The CUDA kernels themselves are held against the plain
versions on the card by tests/test_torch_cuda.py and chip_smoke.py.

Tolerances: counts and int64 sums are compared bit for bit; float32 sums
within rel 1e-5 (the two sides add in different orders)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tidb_tpu.ops import segment_count, segment_sum_f32, segment_sum_i64
from tidb_tpu.ops import set_pallas_enabled
from tidb_tpu_torch.ops import segment_sum as port
from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)

_GS = [1, 12, 300, 9000]
_RS = [1024, 4097]  # one tile-aligned, one ragged


@pytest.fixture(autouse=True)
def force_pallas():
    set_pallas_enabled(True)
    yield
    set_pallas_enabled(None)


def _ids(rng, R, G, out_of_range: bool):
    """Ids in [0, G); with out_of_range, a tenth of them at G and above
    (the callers' NULL/overflow slots, dropped by both sides)."""
    seg = rng.integers(0, G, R)
    if out_of_range:
        bad = rng.random(R) < 0.1
        seg[bad] = G + rng.integers(0, 5, int(bad.sum()))
    return seg.astype(np.int64)


@pytest.mark.parametrize("G", _GS)
@pytest.mark.parametrize("R", _RS)
@pytest.mark.parametrize("oor", [False, True])
def test_count_matches_jax(G, R, oor):
    rng = np.random.default_rng(G * 7 + R + oor)
    seg = _ids(rng, R, G, oor)
    mask = rng.random(R) < 0.6
    want = np.asarray(segment_count(jnp.asarray(mask), jnp.asarray(seg.astype(np.int32)), G))
    got = port.segment_count(torch.from_numpy(mask), torch.from_numpy(seg), G)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("G", _GS)
@pytest.mark.parametrize("R", _RS)
@pytest.mark.parametrize("oor", [False, True])
def test_sum_f32_matches_jax(G, R, oor):
    rng = np.random.default_rng(G * 11 + R + oor)
    seg = _ids(rng, R, G, oor)
    vals = rng.standard_normal(R).astype(np.float32)
    want = np.asarray(segment_sum_f32(jnp.asarray(vals), jnp.asarray(seg.astype(np.int32)), G))
    got = port.segment_sum_f32(torch.from_numpy(vals), torch.from_numpy(seg), G)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("G", _GS)
@pytest.mark.parametrize("R", _RS)
@pytest.mark.parametrize("values", ["decimal", "extremes"])
def test_sum_i64_matches_jax(G, R, values):
    rng = np.random.default_rng(G * 13 + R)
    seg = _ids(rng, R, G, out_of_range=True)
    if values == "decimal":
        # scaled DECIMAL(15,2)-like values of both signs
        vals = rng.integers(-10**13, 10**13, R, dtype=np.int64)
    else:
        # int64 extremes: every group sum wraps mod 2^64
        info = np.iinfo(np.int64)
        pool = np.array([info.max, info.min, info.max - 1, info.min + 1, -1, 1, 0],
                        dtype=np.int64)
        vals = pool[rng.integers(0, len(pool), R)]
    want = np.asarray(segment_sum_i64(jnp.asarray(vals), jnp.asarray(seg.astype(np.int32)), G))
    got = port.segment_sum_i64(torch.from_numpy(vals), torch.from_numpy(seg), G)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_negative_ids_are_dropped():
    """Ids below 0 contribute nothing, as in the Pallas kernels (the JAX
    XLA fallback would wrap them, so numpy is the oracle here)."""
    rng = np.random.default_rng(5)
    R, G = 2000, 12
    seg = rng.integers(-3, G, R).astype(np.int64)
    vals = rng.integers(-1000, 1000, R).astype(np.int64)
    keep = seg >= 0
    want = np.zeros(G, np.int64)
    np.add.at(want, seg[keep], vals[keep])
    got = port.segment_sum_i64(torch.from_numpy(vals), torch.from_numpy(seg), G)
    np.testing.assert_array_equal(got.numpy(), want)
    cnt = port.segment_count(torch.ones(R, dtype=torch.bool), torch.from_numpy(seg), G)
    np.testing.assert_array_equal(cnt.numpy(), np.bincount(seg[keep], minlength=G))


def test_cpu_path_counts_no_launch():
    port.reset_launches()
    port.segment_count(torch.ones(8, dtype=torch.bool), torch.zeros(8, dtype=torch.int64), 1)
    port.segment_sum_i64(torch.ones(8, dtype=torch.int64), torch.zeros(8, dtype=torch.int64), 1)
    assert all(v == 0 for v in port.LAUNCHES.values())
