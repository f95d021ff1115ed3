"""The port's per-chunk probe program (tidb_tpu_torch/ops/join_kernels.py
probe_count, which on a CPU tensor runs ops/hash_probe.py's
plain_probe_chunk, the plain version of the tidb_probe_count kernel)
against the JAX package's (tidb_tpu/ops/join_kernels.py probe_count) on the
same seeded numpy inputs: the direct index, the table (the reference's
'xla' window scan) and searchsorted; without and with the LEFT pad; the
full and the flags-only output mode; single keys, two-key range packing
(keys out of range) and hash packing; NULL keys, sel holes, absent keys,
INT64 extremes and the EMPTY-preimage keys. The inputs are chip_smoke.py's
phase-1 cases, at a smaller row count and with a build length of their own
per case (the reference's jitted table build failed when called twice at
one shape in one process).

Tolerance: exact, all seven outputs (in the flags-only mode the five scan
outputs are None and ok and matched compare)."""

import ctypes
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tidb_tpu.ops import join_kernels as ref
from tidb_tpu_torch.ops import hash_probe as hp
from tidb_tpu_torch.ops import join_kernels as jk
from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)

R = 1500  # not a multiple of the kernel's 512-row tile

# name -> (route, options); each case gets build length 300 + 40 * index
CASES = {
    "direct": {"route": "direct"},
    "direct_left": {"route": "direct", "left_pad": True},
    "direct_flags": {"route": "direct", "flags_only": True},
    "table": {"route": "table"},
    "table_left": {"route": "table", "left_pad": True},
    "table_flags": {"route": "table", "flags_only": True},
    "sorted": {"route": "sorted"},
    "sorted_left": {"route": "sorted", "left_pad": True},
    "sorted_flags": {"route": "sorted", "flags_only": True},
    "table_empty_preimage": {"route": "table", "preimage": True, "left_pad": True},
    "two_key_direct": {"route": "direct", "keys": 2, "left_pad": True},
    "two_key_sorted": {"route": "sorted", "keys": 2},
    "two_key_table": {"route": "table", "keys": 2, "flags_only": True},
    "hash_table": {"route": "table", "hash": True},
    "hash_sorted": {"route": "sorted", "hash": True, "left_pad": True},
}
BUILD_LEN = {name: 300 + 40 * i for i, name in enumerate(CASES)}


def _np(t):
    return t.numpy()


def _reference(case):
    """The reference's probe_count on the case's inputs, with its own
    direct index and table."""
    sk = jnp.asarray(_np(case["sorted_keys"]))
    n_build = jnp.asarray(_np(case["n_build"]))
    firsts = jnp.zeros(2, dtype=jnp.int64)
    if case["direct"]:
        firsts = ref.build_direct_index(sk, n_build, case["lo_packed"],
                                        jk.shape_bucket(case["rng_packed"]))
    table = ref.build_hash_table(sk) if case["table"] is not None else None
    return ref.probe_count(
        sk, n_build, tuple(jnp.asarray(_np(d)) for d in case["key_datas"]),
        tuple(jnp.asarray(_np(v)) for v in case["key_valids"]), jnp.asarray(_np(case["sel"])),
        jnp.asarray(case["los"], dtype=jnp.int64), jnp.asarray(case["strides"], dtype=jnp.int64),
        jnp.asarray(case["rngs"], dtype=jnp.int64), firsts, case["lo_packed"],
        case["rng_packed"], modes=case["modes"], hash_mode=case["hash_mode"],
        left_pad=case["left_pad"], direct=case["direct"], table=table,
        probe="xla" if table is not None else "sorted")


def _case(name, seed=0):
    return chip_smoke.make_probe_count_case(torch, np, jk, hp, R, BUILD_LEN[name],
                                            CASES[name], 5000 + seed, "cpu")


@pytest.mark.parametrize("name", list(CASES))
def test_probe_count_equals_reference(name):
    case = _case(name, BUILD_LEN[name])
    route = CASES[name]["route"]
    jk.reset_routes()
    got = jk.probe_count(**case)
    assert jk.PROBE_ROUTES[route] == 1 and sum(jk.PROBE_ROUTES.values()) == 1
    want = _reference(case)
    for out, g, w in zip(chip_smoke.CHUNK_OUTPUTS, got, want):
        if case["flags_only"] and out not in ("ok", "matched"):
            assert g is None, out
            continue
        np.testing.assert_array_equal(_np(g), np.asarray(w), err_msg=out)
    assert int(got[6].sum()) > 0, "the case matches nothing"


def test_full_and_flags_modes_agree():
    """The flags-only mode's ok and matched are the full mode's."""
    case = _case("table_left")
    full = jk.probe_count(**dict(case, flags_only=False))
    flags = jk.probe_count(**dict(case, flags_only=True))
    assert flags[:5] == (None,) * 5
    for g, w in zip(flags[5:], full[5:]):
        assert torch.equal(g, w)


def test_cpu_path_counts_no_launch():
    hp.reset_launches()
    for name in ("direct", "table", "sorted_flags"):
        jk.probe_count(**_case(name))
    assert hp.LAUNCHES == {"probe_count": 0, "hash_probe": 0}


_C_SIZES = {"long long": 8, "int": 4}


def test_param_struct_matches_the_kernel_source():
    """The ctypes ProbeParams is the C struct of csrc/hash_probe.cu, field
    for field: the same names in the same order, pointers where the C has
    pointers, and the 216 bytes the source states (no nvcc here)."""
    src = open(os.path.join(os.path.dirname(hp.__file__), "csrc", hp.SOURCE)).read()
    body = src[src.index("struct ProbeParams {"):]
    body = body[:body.index("};")]
    fields = re.findall(r"^\s+(?:const )?([a-z ]+?)(\*?)\s*(\w+);", body, re.M)
    py = hp._ProbeParams._fields_
    assert [n.rstrip("_") for _, _, n in fields] == [n for n, _ in py]
    for (ctype, star, name), (_, pytype) in zip(fields, py):
        if star:
            assert pytype is ctypes.c_void_p, name
        else:
            assert ctypes.sizeof(pytype) == _C_SIZES[ctype], name
    assert ctypes.sizeof(hp._ProbeParams) == 216
