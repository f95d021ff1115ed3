"""TPC-H data generator (the dbgen stand-in for benchmarks/tests).

Deterministic numpy generation following the TPC-H schema and the spec's
key relationships (retailprice formula, lineitem date/flag derivation,
1-7 lines per order) at any scale factor. Text columns draw from small
pools instead of spec grammar — irrelevant for the target queries
(BASELINE.json configs: Q1/Q5/Q6/Q18, SSB, TPC-DS-style joins) and keeps
dictionaries compact.

Dates are stored as days-since-epoch ints, money as scale-2 ints — i.e.
already in device representation for bulk ingest.
"""

from __future__ import annotations

import datetime
import time
from typing import Dict, List, Optional

import numpy as np

from tidb_tpu_torch.chunk.dictionary import Dictionary
from tidb_tpu_torch.errors import ExecutionError
from tidb_tpu_torch.storage.catalog import Catalog
from tidb_tpu_torch.storage.table import ColumnInfo, TableSchema
from tidb_tpu_torch.types import DATE, FLOAT64, INT64, STRING, date_to_days, decimal_type

__all__ = ["load_tpch", "load_arrays", "TPCH_SCHEMAS"]

D152 = decimal_type(15, 2)

TPCH_SCHEMAS = {
    "region": [
        ("r_regionkey", INT64, True),
        ("r_name", STRING, True),
        ("r_comment", STRING, False),
    ],
    "nation": [
        ("n_nationkey", INT64, True),
        ("n_name", STRING, True),
        ("n_regionkey", INT64, True),
        ("n_comment", STRING, False),
    ],
    "supplier": [
        ("s_suppkey", INT64, True),
        ("s_name", STRING, True),
        ("s_address", STRING, True),
        ("s_nationkey", INT64, True),
        ("s_phone", STRING, True),
        ("s_acctbal", D152, True),
        ("s_comment", STRING, False),
    ],
    "customer": [
        ("c_custkey", INT64, True),
        ("c_name", STRING, True),
        ("c_address", STRING, True),
        ("c_nationkey", INT64, True),
        ("c_phone", STRING, True),
        ("c_acctbal", D152, True),
        ("c_mktsegment", STRING, True),
        ("c_comment", STRING, False),
    ],
    "part": [
        ("p_partkey", INT64, True),
        ("p_name", STRING, True),
        ("p_mfgr", STRING, True),
        ("p_brand", STRING, True),
        ("p_type", STRING, True),
        ("p_size", INT64, True),
        ("p_container", STRING, True),
        ("p_retailprice", D152, True),
        ("p_comment", STRING, False),
    ],
    "partsupp": [
        ("ps_partkey", INT64, True),
        ("ps_suppkey", INT64, True),
        ("ps_availqty", INT64, True),
        ("ps_supplycost", D152, True),
        ("ps_comment", STRING, False),
    ],
    "orders": [
        ("o_orderkey", INT64, True),
        ("o_custkey", INT64, True),
        ("o_orderstatus", STRING, True),
        ("o_totalprice", D152, True),
        ("o_orderdate", DATE, True),
        ("o_orderpriority", STRING, True),
        ("o_clerk", STRING, True),
        ("o_shippriority", INT64, True),
        ("o_comment", STRING, False),
    ],
    "lineitem": [
        ("l_orderkey", INT64, True),
        ("l_partkey", INT64, True),
        ("l_suppkey", INT64, True),
        ("l_linenumber", INT64, True),
        ("l_quantity", D152, True),
        ("l_extendedprice", D152, True),
        ("l_discount", D152, True),
        ("l_tax", D152, True),
        ("l_returnflag", STRING, True),
        ("l_linestatus", STRING, True),
        ("l_shipdate", DATE, True),
        ("l_commitdate", DATE, True),
        ("l_receiptdate", DATE, True),
        ("l_shipinstruct", STRING, True),
        ("l_shipmode", STRING, True),
        ("l_comment", STRING, False),
    ],
}

_REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
_NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
_PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
_SHIPMODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
_INSTRUCT = ["COLLECT COD", "DELIVER IN PERSON", "NONE", "TAKE BACK RETURN"]
_CONTAINERS = [
    f"{a} {b}"
    for a in ["SM", "MED", "LG", "JUMBO", "WRAP"]
    for b in ["BAG", "BOX", "CAN", "CASE", "DRUM", "JAR", "PACK", "PKG"]
]
_TYPES = [
    f"{a} {b} {c}"
    for a in ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
    for b in ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
    for c in ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
]
_BRANDS = [f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)]
_COMMENT_POOL = [f"final deps c{i} haggle" for i in range(64)]
_P_NAME_WORDS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished",
]

_START = date_to_days(datetime.date(1992, 1, 1))
_END = date_to_days(datetime.date(1998, 8, 2))
_CURRENT = date_to_days(datetime.date(1995, 6, 17))


def _money(x: np.ndarray) -> np.ndarray:
    """float dollars -> scale-2 int cents."""
    return np.round(x * 100).astype(np.int64)


def _pool_pick(rng, pool, n):
    return [pool[i] for i in rng.integers(0, len(pool), n)]


def _load_orders_lineitem_native(make_table, counts, sf, seed,
                                 npart, nsupp, ncust, clock) -> bool:
    """Fill orders+lineitem via the C++ generator; False if unavailable.
    Each generated column is handed to its table and dropped once copied
    (Table.ingest_encoded), so the two never hold a whole table twice."""
    from tidb_tpu_torch.storage.native_gen import native_orders_lineitem

    nclerk = max(1, int(1000 * sf))
    out = native_orders_lineitem(sf, seed, npart, nsupp, ncust, nclerk)
    if out is None:
        return False
    o, l = out
    del out
    # one generator call makes both tables: its seconds are lineitem's
    clock("lineitem", "gen_s")

    def take(cols: dict, names: dict) -> dict:
        return {name: cols.pop(src) for name, src in names.items()}

    li = take(l, {
        "l_orderkey": "l_orderkey", "l_partkey": "l_partkey",
        "l_suppkey": "l_suppkey", "l_linenumber": "l_linenumber",
        "l_quantity": "l_quantity", "l_extendedprice": "l_extendedprice",
        "l_discount": "l_discount", "l_tax": "l_tax",
        "l_returnflag": "l_returnflag_code", "l_linestatus": "l_linestatus_code",
        "l_shipdate": "l_shipdate", "l_commitdate": "l_commitdate",
        "l_receiptdate": "l_receiptdate", "l_shipinstruct": "l_instruct_code",
        "l_shipmode": "l_shipmode_code", "l_comment": "l_comment_code"})
    del l
    t = make_table("lineitem")
    counts["lineitem"] = t.ingest_encoded(
        li,
        pools={
            "l_returnflag": ["A", "N", "R"],
            "l_linestatus": ["F", "O"],
            "l_shipinstruct": sorted(_INSTRUCT),
            "l_shipmode": sorted(_SHIPMODES),
            "l_comment": sorted(_COMMENT_POOL),
        },
    )
    clock("lineitem", "ingest_s")
    od = take(o, {
        "o_orderkey": "o_orderkey", "o_custkey": "o_custkey",
        "o_totalprice": "o_totalprice", "o_orderdate": "o_orderdate",
        "o_shippriority": "o_shippriority", "o_orderstatus": "o_status_code",
        "o_orderpriority": "o_priority_code", "o_clerk": "o_clerk_code",
        "o_comment": "o_comment_code"})
    del o
    t = make_table("orders")
    counts["orders"] = t.ingest_encoded(
        od,
        pools={
            "o_orderstatus": ["F", "O", "P"],
            "o_orderpriority": sorted(_PRIORITIES),
            "o_clerk": [f"Clerk#{k + 1:09d}" for k in range(nclerk)],
            "o_comment": sorted(_COMMENT_POOL),
        },
    )
    clock("orders", "ingest_s")
    return True


def load_tpch(catalog: Catalog, sf: float = 0.01, db: str = "test", seed: int = 7,
              native: Optional[bool] = None,
              cluster_lineitem: bool = False,
              cluster: bool = True,
              timings: Optional[dict] = None) -> Dict[str, int]:
    """Generate and ingest all eight TPC-H tables at scale factor `sf`.
    Returns table -> row count; `timings`, when given, receives each
    table's {"gen_s", "ingest_s"} (the native generator makes orders and
    lineitem in one call, counted as lineitem's).

    `native` selects the C++ generator (native/tpch_gen.cpp) for the two
    big tables — orders and lineitem fill as int64 columns + dictionary
    codes with no per-row Python objects. None = auto (native when the
    library builds/loads); False forces the numpy oracle generator.

    `cluster` (default) declares ``CLUSTER BY (l_shipdate)`` on
    lineitem: ordered compaction (ISSUE 18) physically sorts the fact
    table at the first delta->segment fold, so the columnar store's
    date zone maps prune (ISSUE 8's Q6 floor) regardless of ingest
    order — no hand-ordered load needed. Row order is not observable
    through SQL, so query results are unaffected.

    `cluster_lineitem` (DEPRECATED — `cluster` supersedes it) ingests
    lineitem pre-sorted in l_shipdate order. Implies the numpy
    generator for orders/lineitem."""
    if cluster_lineitem:
        import warnings

        warnings.warn(
            "load_tpch(cluster_lineitem=True) is deprecated: lineitem "
            "now carries CLUSTER BY (l_shipdate) by default "
            "(cluster=True) and ordered compaction sorts it at the "
            "first delta->segment fold", DeprecationWarning,
            stacklevel=2)
    rng = np.random.default_rng(seed)
    counts = {}
    last = [time.perf_counter()]

    def clock(name: str, phase: str) -> None:
        now = time.perf_counter()
        if timings is not None:
            timings.setdefault(name, {})[phase] = now - last[0]
        last[0] = now

    def make_table(name):
        cols = [ColumnInfo(n, t, not_null=nn) for n, t, nn in TPCH_SCHEMAS[name]]
        pk = {
            "region": ["r_regionkey"], "nation": ["n_nationkey"],
            "supplier": ["s_suppkey"], "customer": ["c_custkey"],
            "part": ["p_partkey"], "partsupp": ["ps_partkey", "ps_suppkey"],
            "orders": ["o_orderkey"], "lineitem": ["l_orderkey", "l_linenumber"],
        }[name]
        cb = "l_shipdate" if cluster and name == "lineitem" else None
        return catalog.create_table(
            db, TableSchema(name, cols, primary_key=pk, cluster_by=cb))

    def ingest(name: str, columns: dict, strings: dict) -> None:
        clock(name, "gen_s")
        counts[name] = make_table(name).insert_columns(columns, strings=strings)
        clock(name, "ingest_s")

    # region / nation -------------------------------------------------------
    ingest("region", {"r_regionkey": np.arange(5)},
           {"r_name": _REGIONS, "r_comment": _COMMENT_POOL[:5]})
    ingest("nation",
           {"n_nationkey": np.arange(25), "n_regionkey": np.array([r for _, r in _NATIONS])},
           {"n_name": [n for n, _ in _NATIONS], "n_comment": _COMMENT_POOL[:25]})

    # supplier ---------------------------------------------------------------
    ns = max(1, int(10_000 * sf))
    keys = np.arange(1, ns + 1)
    ingest(
        "supplier",
        {
            "s_suppkey": keys,
            "s_nationkey": rng.integers(0, 25, ns),
            "s_acctbal": _money(rng.uniform(-999.99, 9999.99, ns)),
        },
        {
            "s_name": [f"Supplier#{k:09d}" for k in keys],
            "s_address": _pool_pick(rng, _COMMENT_POOL, ns),
            "s_phone": [f"{10+k%25}-{k%1000:03d}-{(k*7)%1000:03d}-{(k*13)%10000:04d}" for k in keys],
            "s_comment": _pool_pick(rng, _COMMENT_POOL, ns),
        },
    )

    # customer ---------------------------------------------------------------
    nc = max(1, int(150_000 * sf))
    keys = np.arange(1, nc + 1)
    ingest(
        "customer",
        {
            "c_custkey": keys,
            "c_nationkey": rng.integers(0, 25, nc),
            "c_acctbal": _money(rng.uniform(-999.99, 9999.99, nc)),
        },
        {
            "c_name": [f"Customer#{k:09d}" for k in keys],
            "c_address": _pool_pick(rng, _COMMENT_POOL, nc),
            "c_phone": [f"{10+k%25}-{k%1000:03d}-{(k*7)%1000:03d}-{(k*13)%10000:04d}" for k in keys],
            "c_mktsegment": _pool_pick(rng, _SEGMENTS, nc),
            "c_comment": _pool_pick(rng, _COMMENT_POOL, nc),
        },
    )

    # part -------------------------------------------------------------------
    npart = max(1, int(200_000 * sf))
    keys = np.arange(1, npart + 1)
    # spec retailprice formula: ties part price to key so lineitem prices join up
    retail = (90000 + (keys // 10) % 20001 + 100 * (keys % 1000))  # cents
    ingest(
        "part",
        {
            "p_partkey": keys,
            "p_size": rng.integers(1, 51, npart),
            "p_retailprice": retail,
        },
        {
            "p_name": [
                f"{_P_NAME_WORDS[k % 13]} {_P_NAME_WORDS[(k // 13) % 13]}" for k in keys
            ],
            "p_mfgr": [f"Manufacturer#{1 + k % 5}" for k in keys],
            "p_brand": _pool_pick(rng, _BRANDS, npart),
            "p_type": _pool_pick(rng, _TYPES, npart),
            "p_container": _pool_pick(rng, _CONTAINERS, npart),
            "p_comment": _pool_pick(rng, _COMMENT_POOL, npart),
        },
    )

    # partsupp ---------------------------------------------------------------
    ps_part = np.repeat(keys, 4)
    nps = len(ps_part)
    ps_supp = ((ps_part + (np.tile(np.arange(4), npart) * (ns // 4 + 1))) % ns) + 1
    ingest(
        "partsupp",
        {
            "ps_partkey": ps_part,
            "ps_suppkey": ps_supp,
            "ps_availqty": rng.integers(1, 10_000, nps),
            "ps_supplycost": _money(rng.uniform(1.0, 1000.0, nps)),
        },
        {"ps_comment": _pool_pick(rng, _COMMENT_POOL, nps)},
    )

    # orders + lineitem ------------------------------------------------------
    if native is not False and not cluster_lineitem:
        done = _load_orders_lineitem_native(
            make_table, counts, sf, seed, npart, ns, nc, clock)
        if done:
            return counts
        if native is True:
            raise RuntimeError("native TPC-H generator unavailable")

    no = max(1, int(1_500_000 * sf))
    okeys = np.arange(1, no + 1)
    odate = rng.integers(_START, _END - 151, no)
    ocust = rng.integers(1, nc + 1, no)
    lines_per = rng.integers(1, 8, no)  # 1..7
    nl = int(lines_per.sum())

    l_orderkey = np.repeat(okeys, lines_per)
    l_linenumber = np.concatenate([np.arange(1, c + 1) for c in lines_per])
    l_odate = np.repeat(odate, lines_per)
    l_partkey = rng.integers(1, npart + 1, nl)
    l_suppkey = ((l_partkey + rng.integers(0, 4, nl) * (ns // 4 + 1)) % ns) + 1
    l_qty = rng.integers(1, 51, nl)
    l_retail = 90000 + (l_partkey // 10) % 20001 + 100 * (l_partkey % 1000)
    l_extended = l_qty * l_retail  # cents, scale 2
    l_discount = rng.integers(0, 11, nl)  # 0.00..0.10 at scale 2
    l_tax = rng.integers(0, 9, nl)
    l_ship = l_odate + rng.integers(1, 122, nl)
    l_commit = l_odate + rng.integers(30, 91, nl)
    l_receipt = l_ship + rng.integers(1, 31, nl)
    returned = l_receipt <= _CURRENT
    rflag = np.where(returned, np.where(rng.random(nl) < 0.5, "R", "A"), "N")
    lstatus = np.where(l_ship > _CURRENT, "O", "F")
    l_instruct = _pool_pick(rng, _INSTRUCT, nl)
    l_shipmode = _pool_pick(rng, _SHIPMODES, nl)
    l_comment = _pool_pick(rng, _COMMENT_POOL, nl)

    if cluster_lineitem:
        # time-ordered ingest: every per-row array permutes together
        # (aggregate derivations below key on l_orderkey, so the
        # permutation is invisible to them)
        order = np.argsort(l_ship, kind="stable")
        l_orderkey, l_linenumber = l_orderkey[order], l_linenumber[order]
        l_partkey, l_suppkey = l_partkey[order], l_suppkey[order]
        l_qty, l_extended = l_qty[order], l_extended[order]
        l_discount, l_tax = l_discount[order], l_tax[order]
        l_ship, l_commit = l_ship[order], l_commit[order]
        l_receipt = l_receipt[order]
        rflag, lstatus = rflag[order], lstatus[order]
        l_instruct = [l_instruct[i] for i in order]
        l_shipmode = [l_shipmode[i] for i in order]
        l_comment = [l_comment[i] for i in order]

    clock("lineitem", "gen_s")
    t = make_table("lineitem")
    counts["lineitem"] = t.insert_columns(
        {
            "l_orderkey": l_orderkey,
            "l_partkey": l_partkey,
            "l_suppkey": l_suppkey,
            "l_linenumber": l_linenumber,
            "l_quantity": l_qty * 100,  # scale-2
            "l_extendedprice": l_extended,
            "l_discount": l_discount,
            "l_tax": l_tax,
            "l_shipdate": l_ship,
            "l_commitdate": l_commit,
            "l_receiptdate": l_receipt,
        },
        strings={
            "l_returnflag": rflag.tolist(),
            "l_linestatus": lstatus.tolist(),
            "l_shipinstruct": l_instruct,
            "l_shipmode": l_shipmode,
            "l_comment": l_comment,
        },
    )

    clock("lineitem", "ingest_s")
    # o_totalprice = sum(l_extendedprice*(1+tax)*(1-discount)) per order;
    # o_orderstatus from line statuses (F/O/P)
    disc_price = l_extended * (100 - l_discount) * (100 + l_tax)  # scale 6
    totals = np.zeros(no + 1, dtype=np.int64)
    np.add.at(totals, l_orderkey, disc_price // 10_000)  # back to scale 2
    n_f = np.zeros(no + 1, dtype=np.int64)
    np.add.at(n_f, l_orderkey, (lstatus == "F").astype(np.int64))
    n_lines = np.zeros(no + 1, dtype=np.int64)
    np.add.at(n_lines, l_orderkey, 1)
    status = np.where(n_f[1:] == n_lines[1:], "F", np.where(n_f[1:] == 0, "O", "P"))

    clock("orders", "gen_s")
    t = make_table("orders")
    counts["orders"] = t.insert_columns(
        {
            "o_orderkey": okeys,
            "o_custkey": ocust,
            "o_totalprice": totals[1:],
            "o_orderdate": odate,
            "o_shippriority": np.zeros(no, dtype=np.int64),
        },
        strings={
            "o_orderstatus": status.tolist(),
            "o_orderpriority": _pool_pick(rng, _PRIORITIES, no),
            "o_clerk": [f"Clerk#{1 + k % max(1, int(1000 * sf)):09d}" for k in okeys],
            "o_comment": _pool_pick(rng, _COMMENT_POOL, no),
        },
    )
    clock("orders", "ingest_s")
    return counts


def load_arrays(catalog: Catalog, name: str, columns, arrays: Dict[str, np.ndarray],
                valids: Optional[Dict[str, np.ndarray]] = None,
                dicts: Optional[Dict[str, list]] = None,
                db: str = "test", primary_key: Optional[List[str]] = None,
                indexes=(), cluster_by: Optional[str] = None,
                clustered_rows: int = 0, partition=None, checks=(),
                generated=(), foreign_keys=()):
    """Create table `name` and ingest it from numpy arrays already in
    device representation — the tables another engine generated (the
    parity tests load the JAX package's TPC-H tables through here, so
    both engines query identical rows).

    The other engine's schema comes across with the rows, so both plan
    the same access paths and refuse the same writes:
      * `primary_key` (column names) and `indexes` ((name, columns,
        unique) per secondary index);
      * `cluster_by` (the CLUSTER BY column) and `clustered_rows` (its
        watermark: the leading rows already in cluster order, which the
        arrays keep in the other engine's physical order);
      * `partition`, a `storage.table.PartitionInfo`;
      * `checks` ((name, expression SQL) per CHECK constraint) and
        `generated` ((column, expression SQL, stored) per generated
        column), bound and compiled here from their SQL text;
      * `foreign_keys` ((columns, parent table, parent columns,
        on_delete, on_update) per constraint; the parent is loaded
        first).
    The rows are checked against every unique key, foreign key, CHECK
    and partition bound (and the generated columns recomputed) before
    they become visible.

    `columns` are ColumnInfo; `arrays[col]` holds every physical row;
    `valids[col]` (default all True) the validity; for a dictionary-
    encoded column `dicts[col]` lists the strings in code order (code i
    means dicts[col][i]). Codes are remapped onto this table's own
    sorted dictionary, so a dictionary in another order carries across
    with its rows' strings unchanged."""
    from tidb_tpu_torch.parser import ast as A
    from tidb_tpu_torch.parser.parser import Parser
    from tidb_tpu_torch.session.session import wire_check, wire_generated

    fks = [(list(cols), A.TableName(parent), list(pcols), on_delete, on_update)
           for cols, parent, pcols, on_delete, on_update in foreign_keys]
    t = catalog.create_table(
        db, TableSchema(name, list(columns), primary_key=primary_key,
                        partition=partition, cluster_by=cluster_by),
        foreign_keys=fks)
    for iname, icols, unique in indexes:
        t.create_index(iname, list(icols), unique=unique)
    for cname, sql in checks:
        wire_check(t, cname, Parser(sql).parse_expr(), sql)
    for gcol, sql, stored in generated:
        wire_generated(t, gcol, Parser(sql).parse_expr(), sql, stored)
    sizes = {len(np.asarray(a)) for a in arrays.values()}
    if len(sizes) != 1:
        raise ExecutionError(f"load_arrays length mismatch: {sizes}")
    m = sizes.pop()
    t._ensure(m)
    for c in columns:
        data = np.asarray(arrays[c.name])
        if c.type_.is_dict_encoded:
            values = list((dicts or {})[c.name])
            d = Dictionary(values, c.coll)
            remap = np.array([d.code_of(v) for v in values] or [0],
                             dtype=np.int32)
            data = remap[np.clip(data.astype(np.int64), 0, max(len(values) - 1, 0))]
            t.dicts[c.name] = d
        t.data[c.name][:m] = data.astype(c.type_.np_dtype, copy=False)
        v = (valids or {}).get(c.name)
        t.valid[c.name][:m] = True if v is None else np.asarray(v, dtype=np.bool_)
    t._apply_generated(0, m)
    t._enforce_unique_new(0, m)
    t._check_fk_parents(0, m)
    t._check_row_constraints(0, m)
    t._check_partition(0, m)
    t.begin_ts[:m] = 0  # bulk loads are committed "at origin"
    t.n = m
    t.clustered_rows = min(int(clustered_rows), m)
    t.version += 1
    t._uniq_commit()
    return t
