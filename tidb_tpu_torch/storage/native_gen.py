"""ctypes loader for the native TPC-H generator (native/tpch_gen.cpp).

Builds the shared library on demand (g++ is part of the toolchain; no
pybind11 in this image, so the boundary is a plain C ABI over int64
buffers). Returns None when the toolchain or build is unavailable — the
numpy generator in tpch.py is the fallback and the oracle.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

__all__ = ["load_native", "native_orders_lineitem"]

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_SRC = os.path.join(_NATIVE_DIR, "tpch_gen.cpp")
_LIB = os.path.join(_NATIVE_DIR, "libtpchgen.so")

_lib = None
_load_failed = False


def load_native() -> Optional[ctypes.CDLL]:
    """Build (if stale) and load the generator library; None on failure."""
    global _lib, _load_failed
    if _lib is not None:
        return _lib
    if _load_failed:
        return None
    try:
        if not os.path.exists(_SRC):
            raise FileNotFoundError(_SRC)
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            try:  # one build recipe: the Makefile (honors CXX/CXXFLAGS)
                subprocess.run(
                    ["make", "-C", _NATIVE_DIR, "libtpchgen.so"],
                    check=True, capture_output=True, timeout=120,
                )
            except (FileNotFoundError, subprocess.CalledProcessError):
                subprocess.run(  # make absent: the Makefile's default recipe
                    ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-Wall",
                     "-o", _LIB, _SRC],
                    check=True, capture_output=True, timeout=120,
                )
        # lint: disable=jit-hygiene -- the host TPC-H generator (g++,
        # no kernel): loaded once per process behind the _lib cache above
        lib = ctypes.CDLL(_LIB)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.tpch_sizes.argtypes = [ctypes.c_double, ctypes.c_uint64, i64p, i64p]
        lib.tpch_sizes.restype = None
        lib.tpch_gen.argtypes = (
            [ctypes.c_double, ctypes.c_uint64]
            + [ctypes.c_int64] * 4
            + [i64p] * 25
        )
        lib.tpch_gen.restype = None
        _lib = lib
        return _lib
    except Exception:  # noqa: BLE001 — fall back to the numpy generator
        _load_failed = True
        return None


def native_orders_lineitem(sf: float, seed: int, npart: int, nsupp: int,
                           ncust: int, nclerk: int):
    """Generate orders+lineitem columns natively. Returns (orders dict,
    lineitem dict) of int64 numpy arrays, or None if unavailable."""
    import numpy as np

    lib = load_native()
    if lib is None:
        return None
    no = ctypes.c_int64()
    nl = ctypes.c_int64()
    lib.tpch_sizes(sf, seed, ctypes.byref(no), ctypes.byref(nl))
    no, nl = no.value, nl.value

    def buf(n):
        return np.zeros(n, dtype=np.int64)

    o = {k: buf(no) for k in (
        "o_orderkey", "o_custkey", "o_totalprice", "o_orderdate",
        "o_shippriority", "o_status_code", "o_priority_code",
        "o_clerk_code", "o_comment_code")}
    l = {k: buf(nl) for k in (
        "l_orderkey", "l_partkey", "l_suppkey", "l_linenumber",
        "l_quantity", "l_extendedprice", "l_discount", "l_tax",
        "l_returnflag_code", "l_linestatus_code", "l_shipdate",
        "l_commitdate", "l_receiptdate", "l_instruct_code",
        "l_shipmode_code", "l_comment_code")}

    def p(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    lib.tpch_gen(
        sf, seed, npart, nsupp, ncust, nclerk,
        p(o["o_orderkey"]), p(o["o_custkey"]), p(o["o_totalprice"]),
        p(o["o_orderdate"]), p(o["o_shippriority"]), p(o["o_status_code"]),
        p(o["o_priority_code"]), p(o["o_clerk_code"]), p(o["o_comment_code"]),
        p(l["l_orderkey"]), p(l["l_partkey"]), p(l["l_suppkey"]),
        p(l["l_linenumber"]), p(l["l_quantity"]), p(l["l_extendedprice"]),
        p(l["l_discount"]), p(l["l_tax"]), p(l["l_returnflag_code"]),
        p(l["l_linestatus_code"]), p(l["l_shipdate"]), p(l["l_commitdate"]),
        p(l["l_receiptdate"]), p(l["l_instruct_code"]), p(l["l_shipmode_code"]),
        p(l["l_comment_code"]),
    )
    return o, l
