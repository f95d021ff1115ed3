"""The system under test: tidb_tpu_torch's MySQL server, set up in this
process as `python -m tidb_tpu_torch` sets it up (the configuration's mesh
over every visible card, every sysvar at its default), over tables
bulk-loaded from the benchmark's own arrays. The one module of the
harness that imports the program; what it reads back is the program's
counters."""

from __future__ import annotations

import sys
from typing import Dict

from harness import spec, tpchgen

DB = "test"
if spec.ROOT not in sys.path:  # the program sits at the root of the checkout
    sys.path.insert(0, spec.ROOT)


def _types():
    from tidb_tpu_torch.types import DATE, INT64, STRING, decimal_type

    return {"int64": INT64, "string": STRING, "date": DATE,
            "decimal(15,2)": decimal_type(15, 2)}


def load(tables: Dict[str, tpchgen.Table]):
    """A Catalog holding the eight tables, loaded through the program's
    bulk-load entry with their primary keys and lineitem's
    CLUSTER BY (l_shipdate), as its own TPC-H loader declares them."""
    from tidb_tpu_torch.storage.catalog import Catalog
    from tidb_tpu_torch.storage.table import ColumnInfo
    from tidb_tpu_torch.storage.tpch import load_arrays

    types = _types()
    catalog = Catalog()
    for name in tpchgen.LOAD_ORDER:
        t = tables[name]
        cols = [ColumnInfo(c, types[ty], not_null=nn) for c, ty, nn in tpchgen.SCHEMAS[name]]
        load_arrays(catalog, name, cols, t.arrays, dicts=t.pools, db=DB,
                    primary_key=tpchgen.PRIMARY_KEYS[name],
                    cluster_by=tpchgen.CLUSTER_BY.get(name))
    return catalog


def start_server(catalog, device: str, mesh_mode: str = "auto"):
    """The server on 127.0.0.1 at a free port, its status port off;
    `mesh_mode` as `python -m tidb_tpu_torch --mesh` takes it."""
    import torch

    from tidb_tpu_torch.parallel import make_mesh
    from tidb_tpu_torch.server.server import Server
    from tidb_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    mesh = None
    if mesh_mode == "auto":
        mesh = make_mesh(devices=[dev]) if dev.type == "cpu" else make_mesh()
    server = Server(catalog=catalog, host="127.0.0.1", port=0, status_port=None,
                    device=dev, mesh=mesh)
    server.start()
    return server, torch.device(dev)


def _hist(h):
    total, count = 0.0, 0
    for _labels, counts, s, _ex in h.samples():
        total += s
        count += sum(counts)
    return total, count


def counters() -> dict:
    """The program's own clocks and counters, process-wide."""
    from tidb_tpu_torch.ops import join_kernels
    from tidb_tpu_torch.utils import jitcache
    from tidb_tpu_torch.utils import metrics as M

    q_s, q_n = _hist(M.QUERY_DURATION)
    return {"query_s": q_s, "query_n": q_n,
            "parse_s": _hist(M.PARSE_SECONDS)[0], "plan_s": _hist(M.PLAN_SECONDS)[0],
            "h2d_bytes": M.XFER_BYTES.value(dir="h2d"),
            "routes": dict(join_kernels.PROBE_ROUTES),  # probes by route, replays too
            "runs": jitcache.runs()}


def delta(after: dict, before: dict) -> dict:
    out = {k: after[k] - before[k] for k in after if k not in ("runs", "routes")}
    out["routes"] = {k: n - before["routes"].get(k, 0) for k, n in after["routes"].items()}
    runs: Dict[str, int] = {}
    for ns, per in after["runs"].items():
        for how, n in per.items():
            d = n - before["runs"].get(ns, {}).get(how, 0)
            if d:
                runs[how] = runs.get(how, 0) + d
    out["runs"] = runs
    return out
