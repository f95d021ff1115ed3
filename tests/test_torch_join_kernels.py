"""The port's join programs (tidb_tpu_torch/ops/join_kernels.py) against
the JAX package's (tidb_tpu/ops/join_kernels.py) on the same seeded numpy
inputs.

Tolerance: exact. The one allowed difference is the order of rows within
one build key: the reference sorts with jax.lax.sort(is_stable=False) and
the port with two stable passes, so build payloads compare as multisets
of (key, payload) over the live prefix and over the dead tail."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidb_tpu.ops import join_kernels as ref
from tidb_tpu_torch.ops import join_kernels as jk
from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)

I64 = np.iinfo(np.int64)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy() if isinstance(got, torch.Tensor) else got,
                                  np.asarray(want))


@pytest.mark.parametrize("n_keys", [1, 2, 3])
def test_hash_combine_bit_equal(n_keys):
    rng = np.random.default_rng(n_keys)
    ext = np.array([I64.min, I64.min + 1, -1, 0, 1, I64.max - 1, I64.max], dtype=np.int64)
    keys = [np.concatenate([rng.integers(I64.min, I64.max, 20_000, dtype=np.int64),
                            rng.permutation(ext)]) for _ in range(n_keys)]
    want = ref.hash_combine_device([jnp.asarray(k) for k in keys])
    _eq(jk.hash_combine_device([_t(k) for k in keys]), want)


def _pack_case(kind, rng, n=4000):
    sel = rng.random(n) < 0.9
    if kind == "single_int":
        return [rng.integers(-50, 50, n)], [rng.random(n) < 0.95], sel, ("int",), False, [(0, 1, 0)]
    if kind == "single_float":
        d = rng.standard_normal(n)
        d[:3] = [0.0, -0.0, np.inf]
        return [d], [np.ones(n, bool)], sel, ("bits",), False, [(0, 1, 0)]
    if kind == "multi_range":
        # build ranges [lo, lo + rng); probes reach past both ends
        a, b = rng.integers(-5, 25, n), rng.integers(95, 140, n)
        return ([a, b], [rng.random(n) < 0.95, np.ones(n, bool)], sel, ("int", "int"),
                False, [(0, 1, 20), (100, 20, 30)])
    if kind == "multi_hash":
        a = rng.integers(I64.min, I64.max, n, dtype=np.int64)
        b = rng.standard_normal(n)
        return ([a, b], [np.ones(n, bool), rng.random(n) < 0.9], sel, ("int", "bits"),
                True, [(0, 0, 0), (0, 0, 0)])
    raise AssertionError(kind)


@pytest.mark.parametrize("kind", ["single_int", "single_float", "multi_range", "multi_hash"])
def test_pack_keys_equal(kind):
    datas, valids, sel, modes, hash_mode, params = _pack_case(kind, np.random.default_rng(5))
    los, strides, rngs = ([p[i] for p in params] for i in range(3))
    want = ref.pack_keys(tuple(jnp.asarray(d) for d in datas),
                         tuple(jnp.asarray(v) for v in valids),
                         jnp.asarray(los, dtype=jnp.int64), jnp.asarray(strides, dtype=jnp.int64),
                         jnp.asarray(rngs, dtype=jnp.int64), jnp.asarray(sel), modes, hash_mode)
    got = jk.pack_keys(tuple(_t(d) for d in datas), tuple(_t(v) for v in valids),
                       los, strides, rngs, _t(sel), modes, hash_mode)
    for g, w in zip(got, want):
        _eq(g, w)


def _build_inputs(kind, B=256):
    rng = np.random.default_rng(len(kind))
    n = B - 37  # live rows, then ok=False padding
    ok = np.zeros(B, bool)
    ok[:n] = rng.random(n) < 0.9  # NULL keys inside the live rows
    if kind == "single":
        keys = [rng.integers(0, 40, B) * (1 << 40)]
        keys[0][:2] = I64.max  # legitimate INT64_MAX keys sort before the dead tail
        modes, hash_mode, params = ("int",), False, [(0, 1, 0)]
    elif kind == "multi_range":
        keys = [rng.integers(3, 9, B), rng.integers(-4, 4, B)]
        modes, hash_mode, params = ("int", "int"), False, [(3, 1, 6), (-4, 6, 8)]
    else:  # multi_hash
        keys = [rng.integers(0, 5, B) * (1 << 50), rng.integers(0, 3, B).astype(np.float64)]
        modes, hash_mode, params = ("int", "bits"), True, [(0, 0, 0), (0, 0, 0)]
    payload = [rng.integers(-1000, 1000, B), rng.standard_normal(B)]
    pvalid = [rng.random(B) < 0.8, np.ones(B, bool)]
    return keys, ok, payload, pvalid, modes, hash_mode, params


def _rows(keys, cols, lo, hi):
    return sorted(zip(*(np.asarray(c)[lo:hi].tolist() for c in (keys, *cols))))


@pytest.mark.parametrize("kind", ["single", "multi_range", "multi_hash"])
def test_build_sort_equal(kind):
    keys, ok, payload, pvalid, modes, hash_mode, params = _build_inputs(kind)
    los, strides, rngs = ([p[i] for p in params] for i in range(3))
    w_sk, w_n, w_d, w_v, w_k = ref.build_sort(
        tuple(jnp.asarray(k) for k in keys), (jnp.asarray(ok),) * len(keys), jnp.asarray(ok),
        tuple(jnp.asarray(p) for p in payload), tuple(jnp.asarray(v) for v in pvalid),
        jnp.asarray(los, dtype=jnp.int64), jnp.asarray(strides, dtype=jnp.int64),
        jnp.asarray(rngs, dtype=jnp.int64), modes, hash_mode)
    g_sk, g_n, g_d, g_v, g_k = jk.build_sort(
        tuple(_t(k) for k in keys), (_t(ok),) * len(keys), _t(ok),
        tuple(_t(p) for p in payload), tuple(_t(v) for v in pvalid),
        los, strides, rngs, modes, hash_mode)
    _eq(g_sk, w_sk)
    n = int(w_n)
    assert int(g_n) == n == int(ok.sum())
    B = len(ok)
    for lo, hi in ((0, n), (n, B)):  # live prefix, dead tail
        assert _rows(g_sk, [*g_d, *g_v, *g_k], lo, hi) == \
            _rows(w_sk, [*w_d, *w_v, *w_k], lo, hi)
    assert len(g_k) == len(w_k) == (len(keys) if hash_mode else 0)


@pytest.mark.parametrize("lo,rng_bucket", [(0, 64), (-10, 128), (5, 1024)])
def test_build_direct_index_equal(lo, rng_bucket):
    r = np.random.default_rng(rng_bucket)
    n = 180
    sk = np.sort(r.integers(lo, lo + rng_bucket // 2, n))
    sk = np.concatenate([sk, np.full(256 - n, I64.max)])
    want = ref.build_direct_index(jnp.asarray(sk), jnp.asarray(n), lo, rng_bucket)
    _eq(jk.build_direct_index(_t(sk), torch.tensor(n), lo, rng_bucket), want)


def _probe_setup(route, left_pad):
    r = np.random.default_rng(7 + left_pad)
    # one build size per case: the reference's jitted table build
    # misbehaves when re-run at an equal shape in one process
    B = 256 << left_pad
    n, R = B - 56, 512
    mul = 1 if route == "direct" else (1 << 40)
    sk = np.concatenate([np.sort(r.integers(0, 120, n)) * mul, np.full(B - n, I64.max)])
    pk = r.integers(-10, 140, R) * mul
    pk[:3] = I64.max  # probes of the sentinel value match nothing
    pv = r.random(R) < 0.9
    sel = r.random(R) < 0.85
    return sk, n, pk, pv, sel


@pytest.mark.parametrize("left_pad", [False, True])
@pytest.mark.parametrize("route", ["direct", "table", "sorted"])
def test_probe_count_equal(route, left_pad):
    sk, n, pk, pv, sel = _probe_setup(route, left_pad)
    z = jnp.zeros(1, dtype=jnp.int64)
    common = dict(modes=("int",), hash_mode=False, left_pad=left_pad,
                  direct=route == "direct")
    firsts_w = jnp.zeros(2, dtype=jnp.int64)
    lo_p = rng_p = 0
    if route == "direct":
        lo_p, rng_p = 0, 120
        firsts_w = ref.build_direct_index(jnp.asarray(sk), jnp.asarray(n), 0, 128)
    table_w = ref.build_hash_table(jnp.asarray(sk)) if route == "table" else None
    want = ref.probe_count(jnp.asarray(sk), jnp.asarray(n), (jnp.asarray(pk),),
                           (jnp.asarray(pv),), jnp.asarray(sel), z, z + 1, z,
                           firsts_w, lo_p, rng_p, table=table_w,
                           probe="xla" if route == "table" else "sorted", **common)
    if route == "direct":
        firsts_g = jk.build_direct_index(_t(sk), torch.tensor(n), 0, 128)
    else:
        firsts_g = torch.zeros(2, dtype=torch.int64)
    table_g = jk.build_hash_table(_t(sk)) if route == "table" else None
    jk.reset_routes()
    got = jk.probe_count(_t(sk), torch.tensor(n), (_t(pk),), (_t(pv),), _t(sel),
                         [0], [1], [0], firsts_g, lo_p, rng_p, table=table_g, **common)
    assert jk.PROBE_ROUTES[route] == 1 and sum(jk.PROBE_ROUTES.values()) == 1
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("w0,n_slots", [(0, 64), (100, 128), (700, 64), (0, 2048)])
def test_tile_positions_equal(w0, n_slots):
    r = np.random.default_rng(w0 + n_slots)
    R = 256
    count = np.where(r.random(R) < 0.3, 0, r.integers(1, 9, R))
    start = r.integers(0, 300, R)
    cum = np.cumsum(count)
    want = ref.tile_positions(jnp.asarray(start), jnp.asarray(count), jnp.asarray(cum),
                              w0, n_slots, R, 512)
    got = jk.tile_positions(_t(start), _t(count), _t(cum), w0, n_slots, R, 512)
    for g, w in zip(got, want):
        _eq(g, w)


@pytest.mark.parametrize("left", [False, True])
def test_expand_tiles_equal(left):
    r = np.random.default_rng(int(left))
    R, B = 128, 256
    real = np.where(r.random(R) < 0.4, 0, r.integers(1, 6, R))
    count = np.maximum(real, 1) if left else real
    start = r.integers(0, B - 6, R)
    cum = np.cumsum(count)
    # probe columns of a chunk capacity below the padded probe length
    pd, pv = [r.integers(0, 99, 100)], [r.random(100) < 0.9]
    bd, bv = [r.integers(0, 99, B), r.standard_normal(B)], [r.random(B) < 0.9, np.ones(B, bool)]
    for w0 in (0, 256):
        kw = dict(n_tiles=2, tile_cap=128, build_cap=B, left=left,
                  with_probe_row=True, with_build_pos=True)
        want = ref.expand_tiles(
            jnp.asarray(start), jnp.asarray(count), jnp.asarray(real), jnp.asarray(cum), w0,
            [jnp.asarray(a) for a in pd], [jnp.asarray(a) for a in pv],
            [jnp.asarray(a) for a in bd], [jnp.asarray(a) for a in bv], **kw)
        got = jk.expand_tiles(_t(start), _t(count), _t(real), _t(cum), w0,
                              [_t(a) for a in pd], [_t(a) for a in pv],
                              [_t(a) for a in bd], [_t(a) for a in bv], **kw)
        for gp, wp in zip(got[0] + got[1], want[0] + want[1]):
            _eq(gp[0], wp[0])
            _eq(gp[1], wp[1])
        for g, w in zip(got[2:], want[2:]):
            _eq(g, w)


def test_shape_bucket_equal():
    for n, floor in [(0, 64), (1, 1), (63, 64), (65, 64), (1000, 1), (1 << 20, 64)]:
        assert jk.shape_bucket(n, floor) == ref.shape_bucket(n, floor)
