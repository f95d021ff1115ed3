"""The eight TPC-H tables, made from a seed (a frozen copy of the
generator that tidb_tpu_torch/storage/tpch.py drives).

orders and lineitem come from benchmark/native/tpch_gen.cpp (native/
tpch_gen.cpp's generator with TPC-H clause 4.2.3's keys), built once with
g++ into a fixed directory inside the checkout; the six small tables come
from numpy, with the same draws in the same order as the program's own
loader. One seed gives the program's data but for the keys of clause
4.2.3: sparse O_ORDERKEY (the first 8 of every 32), O_CUSTKEY never a
multiple of 3, and PS_SUPPKEY/L_SUPPKEY by the spec's formula. Nothing
here imports torch or the program.

Every table is returned in device representation: int64 columns, money
as scale-2 integers, dates as days since 1970-01-01, and each string
column as int codes into a list of strings (its pool). The same arrays
go to the plain reference and, through the program's bulk load, to the
server's catalog.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "native", "tpch_gen.cpp")
BUILD_DIR = os.path.join(HERE, "..", ".cache", "tpchgen")

# (column, type, not null) per table; types: int64, string, decimal(15,2), date
SCHEMAS = {
    "region": [("r_regionkey", "int64", True), ("r_name", "string", True),
               ("r_comment", "string", False)],
    "nation": [("n_nationkey", "int64", True), ("n_name", "string", True),
               ("n_regionkey", "int64", True), ("n_comment", "string", False)],
    "supplier": [("s_suppkey", "int64", True), ("s_name", "string", True),
                 ("s_address", "string", True), ("s_nationkey", "int64", True),
                 ("s_phone", "string", True), ("s_acctbal", "decimal(15,2)", True),
                 ("s_comment", "string", False)],
    "customer": [("c_custkey", "int64", True), ("c_name", "string", True),
                 ("c_address", "string", True), ("c_nationkey", "int64", True),
                 ("c_phone", "string", True), ("c_acctbal", "decimal(15,2)", True),
                 ("c_mktsegment", "string", True), ("c_comment", "string", False)],
    "part": [("p_partkey", "int64", True), ("p_name", "string", True),
             ("p_mfgr", "string", True), ("p_brand", "string", True),
             ("p_type", "string", True), ("p_size", "int64", True),
             ("p_container", "string", True), ("p_retailprice", "decimal(15,2)", True),
             ("p_comment", "string", False)],
    "partsupp": [("ps_partkey", "int64", True), ("ps_suppkey", "int64", True),
                 ("ps_availqty", "int64", True), ("ps_supplycost", "decimal(15,2)", True),
                 ("ps_comment", "string", False)],
    "orders": [("o_orderkey", "int64", True), ("o_custkey", "int64", True),
               ("o_orderstatus", "string", True), ("o_totalprice", "decimal(15,2)", True),
               ("o_orderdate", "date", True), ("o_orderpriority", "string", True),
               ("o_clerk", "string", True), ("o_shippriority", "int64", True),
               ("o_comment", "string", False)],
    "lineitem": [("l_orderkey", "int64", True), ("l_partkey", "int64", True),
                 ("l_suppkey", "int64", True), ("l_linenumber", "int64", True),
                 ("l_quantity", "decimal(15,2)", True),
                 ("l_extendedprice", "decimal(15,2)", True),
                 ("l_discount", "decimal(15,2)", True), ("l_tax", "decimal(15,2)", True),
                 ("l_returnflag", "string", True), ("l_linestatus", "string", True),
                 ("l_shipdate", "date", True), ("l_commitdate", "date", True),
                 ("l_receiptdate", "date", True), ("l_shipinstruct", "string", True),
                 ("l_shipmode", "string", True), ("l_comment", "string", False)],
}
PRIMARY_KEYS = {
    "region": ["r_regionkey"], "nation": ["n_nationkey"], "supplier": ["s_suppkey"],
    "customer": ["c_custkey"], "part": ["p_partkey"],
    "partsupp": ["ps_partkey", "ps_suppkey"], "orders": ["o_orderkey"],
    "lineitem": ["l_orderkey", "l_linenumber"],
}
CLUSTER_BY = {"lineitem": "l_shipdate"}
# the order the program's loader creates the tables in
LOAD_ORDER = ("region", "nation", "supplier", "customer", "part", "partsupp",
              "lineitem", "orders")

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
SHIPMODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
INSTRUCT = ["COLLECT COD", "DELIVER IN PERSON", "NONE", "TAKE BACK RETURN"]
CONTAINERS = [f"{a} {b}" for a in ["SM", "MED", "LG", "JUMBO", "WRAP"]
              for b in ["BAG", "BOX", "CAN", "CASE", "DRUM", "JAR", "PACK", "PKG"]]
TYPES = [f"{a} {b} {c}"
         for a in ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
         for b in ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
         for c in ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]]
BRANDS = [f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)]
COMMENTS = [f"final deps c{i} haggle" for i in range(64)]
P_NAME_WORDS = ["almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
                "blanched", "blue", "blush", "brown", "burlywood", "burnished"]


@dataclass
class Table:
    arrays: Dict[str, np.ndarray] = field(default_factory=dict)
    pools: Dict[str, List[str]] = field(default_factory=dict)

    @property
    def rows(self) -> int:
        return len(next(iter(self.arrays.values())))

    def strings(self, col: str) -> np.ndarray:
        """The column's strings (object array), for a reference that wants them."""
        return np.asarray(self.pools[col], dtype=object)[self.arrays[col]]


def _money(x: np.ndarray) -> np.ndarray:
    return np.round(x * 100).astype(np.int64)


def _codes(rng, pool, n) -> np.ndarray:
    # the program's loader picks pool[i] for i in rng.integers(0, len(pool), n)
    return rng.integers(0, len(pool), n)


def _per_key(fmt, keys) -> tuple:
    return np.arange(len(keys)), [fmt(int(k)) for k in keys]


def _phone(k: int) -> str:
    return f"{10 + k % 25}-{k % 1000:03d}-{(k * 7) % 1000:03d}-{(k * 13) % 10000:04d}"


def library_path() -> str:
    with open(SRC, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.abspath(os.path.join(BUILD_DIR, f"libtpchgen-{tag}.so"))


def build_library() -> str:
    """Build the generator once into its fixed directory; a build under a
    temporary name is renamed into place, so a cut build leaves nothing."""
    path = library_path()
    if not os.path.exists(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.part{os.getpid()}"
        subprocess.run(["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-Wall",
                        "-o", tmp, os.path.abspath(SRC)],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, path)
    return path


def _native(sf: float, seed: int, npart: int, nsupp: int, ncust: int, nclerk: int):
    lib = ctypes.CDLL(build_library())
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.tpch_sizes.argtypes = [ctypes.c_double, ctypes.c_uint64, i64p, i64p]
    lib.tpch_sizes.restype = None
    lib.tpch_gen.argtypes = ([ctypes.c_double, ctypes.c_uint64] + [ctypes.c_int64] * 4
                             + [i64p] * 25)
    lib.tpch_gen.restype = None
    no, nl = ctypes.c_int64(), ctypes.c_int64()
    lib.tpch_sizes(sf, seed, ctypes.byref(no), ctypes.byref(nl))
    ocols = ("o_orderkey", "o_custkey", "o_totalprice", "o_orderdate", "o_shippriority",
             "o_orderstatus", "o_orderpriority", "o_clerk", "o_comment")
    lcols = ("l_orderkey", "l_partkey", "l_suppkey", "l_linenumber", "l_quantity",
             "l_extendedprice", "l_discount", "l_tax", "l_returnflag", "l_linestatus",
             "l_shipdate", "l_commitdate", "l_receiptdate", "l_shipinstruct",
             "l_shipmode", "l_comment")
    o = {c: np.zeros(no.value, dtype=np.int64) for c in ocols}
    li = {c: np.zeros(nl.value, dtype=np.int64) for c in lcols}
    ptrs = [a.ctypes.data_as(i64p) for a in (*o.values(), *li.values())]
    lib.tpch_gen(sf, seed, npart, nsupp, ncust, nclerk, *ptrs)
    return o, li


def generate(sf: float, seed: int) -> Dict[str, Table]:
    """All eight tables at scale factor `sf` from `seed` (any integer
    from 0 to 2**64 - 1)."""
    rng = np.random.default_rng(seed)
    out: Dict[str, Table] = {}
    out["region"] = Table({"r_regionkey": np.arange(5), "r_name": np.arange(5),
                           "r_comment": np.arange(5)},
                          {"r_name": REGIONS, "r_comment": COMMENTS[:5]})
    out["nation"] = Table({"n_nationkey": np.arange(25), "n_name": np.arange(25),
                           "n_regionkey": np.array([r for _, r in NATIONS]),
                           "n_comment": np.arange(25)},
                          {"n_name": [n for n, _ in NATIONS], "n_comment": COMMENTS[:25]})

    ns = max(1, int(10_000 * sf))
    keys = np.arange(1, ns + 1)
    t = Table({"s_suppkey": keys, "s_nationkey": rng.integers(0, 25, ns),
               "s_acctbal": _money(rng.uniform(-999.99, 9999.99, ns))})
    t.arrays["s_name"], t.pools["s_name"] = _per_key(lambda k: f"Supplier#{k:09d}", keys)
    t.arrays["s_address"], t.pools["s_address"] = _codes(rng, COMMENTS, ns), COMMENTS
    t.arrays["s_phone"], t.pools["s_phone"] = _per_key(_phone, keys)
    t.arrays["s_comment"], t.pools["s_comment"] = _codes(rng, COMMENTS, ns), COMMENTS
    out["supplier"] = t

    nc = max(1, int(150_000 * sf))
    keys = np.arange(1, nc + 1)
    t = Table({"c_custkey": keys, "c_nationkey": rng.integers(0, 25, nc),
               "c_acctbal": _money(rng.uniform(-999.99, 9999.99, nc))})
    t.arrays["c_name"], t.pools["c_name"] = _per_key(lambda k: f"Customer#{k:09d}", keys)
    t.arrays["c_address"], t.pools["c_address"] = _codes(rng, COMMENTS, nc), COMMENTS
    t.arrays["c_phone"], t.pools["c_phone"] = _per_key(_phone, keys)
    t.arrays["c_mktsegment"], t.pools["c_mktsegment"] = _codes(rng, SEGMENTS, nc), SEGMENTS
    t.arrays["c_comment"], t.pools["c_comment"] = _codes(rng, COMMENTS, nc), COMMENTS
    out["customer"] = t

    npart = max(1, int(200_000 * sf))
    keys = np.arange(1, npart + 1)
    t = Table({"p_partkey": keys, "p_size": rng.integers(1, 51, npart),
               # the spec's retailprice formula, in cents
               "p_retailprice": 90000 + (keys // 10) % 20001 + 100 * (keys % 1000)})
    t.arrays["p_name"] = (keys % 13) * 13 + (keys // 13) % 13
    t.pools["p_name"] = [f"{a} {b}" for a in P_NAME_WORDS for b in P_NAME_WORDS]
    t.arrays["p_mfgr"] = keys % 5
    t.pools["p_mfgr"] = [f"Manufacturer#{1 + i}" for i in range(5)]
    for col, pool in (("p_brand", BRANDS), ("p_type", TYPES),
                      ("p_container", CONTAINERS), ("p_comment", COMMENTS)):
        t.arrays[col], t.pools[col] = _codes(rng, pool, npart), pool
    out["part"] = t

    ps_part = np.repeat(keys, 4)
    nps = len(ps_part)
    # TPC-H clause 4.2.3's PS_SUPPKEY: part k's i-th supplier (i = 0..3)
    ps_supp = (ps_part + np.tile(np.arange(4), npart) * (ns // 4 + (ps_part - 1) // ns)) % ns + 1
    t = Table({"ps_partkey": ps_part, "ps_suppkey": ps_supp,
               "ps_availqty": rng.integers(1, 10_000, nps),
               "ps_supplycost": _money(rng.uniform(1.0, 1000.0, nps))})
    t.arrays["ps_comment"], t.pools["ps_comment"] = _codes(rng, COMMENTS, nps), COMMENTS
    out["partsupp"] = t

    nclerk = max(1, int(1000 * sf))
    o, li = _native(sf, seed, npart, ns, nc, nclerk)
    out["lineitem"] = Table(li, {
        "l_returnflag": ["A", "N", "R"], "l_linestatus": ["F", "O"],
        "l_shipinstruct": sorted(INSTRUCT), "l_shipmode": sorted(SHIPMODES),
        "l_comment": sorted(COMMENTS)})
    out["orders"] = Table(o, {
        "o_orderstatus": ["F", "O", "P"], "o_orderpriority": sorted(PRIORITIES),
        "o_clerk": [f"Clerk#{k + 1:09d}" for k in range(nclerk)],
        "o_comment": sorted(COMMENTS)})
    return out
