"""What the harness finds by name: BENCHMARK.json at the root of the
checkout, and under benchmark/ a configuration (configs/<name>.json), a
traffic mix (traffic/<name>.json), a query (queries/<name>.sql and
queries/<name>.py) and a metric's reader (metrics/<name>.py). A new cell,
mix, query or metric is new files and entries; nothing here changes."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
from dataclasses import dataclass
from types import ModuleType
from typing import Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH_DIR)


class SpecError(Exception):
    pass


def _json(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise SpecError(f"missing {os.path.relpath(path, ROOT)}") from None


def _module(kind: str, name: str) -> ModuleType:
    key = f"bench_{kind}_{name}".replace(".", "_").replace("-", "_")
    if key in sys.modules:
        return sys.modules[key]
    path = os.path.join(BENCH_DIR, kind, f"{name}.py")
    if not os.path.exists(path):
        raise SpecError(f"missing {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Query:
    name: str
    sql: str          # a template: str.format(**params)
    mod: ModuleType   # COLUMNS, ORDER_BY, LIMIT, draw(rng), reference(data, p, exact)

    def text(self, params: dict) -> str:
        return self.sql.format(**params).strip()


def query(name: str) -> Query:
    path = os.path.join(BENCH_DIR, "queries", f"{name}.sql")
    try:
        with open(path) as f:
            sql = f.read()
    except FileNotFoundError:
        raise SpecError(f"missing {os.path.relpath(path, ROOT)}") from None
    return Query(name, sql, _module("queries", name))


def metric_reader(name: str) -> ModuleType:
    """metrics/<name>.py; its read(ctx) gives the value or None."""
    return _module("metrics", name)


@dataclass
class Metric:
    name: str
    unit: str
    better: str
    source: str
    workloads: Optional[List[str]]
    per_layer: bool

    def applies(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict


class Benchmark:
    def __init__(self, root: str = ROOT):
        self.doc = _json(os.path.join(root, "BENCHMARK.json"))
        self.metrics: List[Metric] = []
        for key, per_layer in (("end_to_end", False), ("per_layer", True)):
            for m in self.doc.get(key, []):
                self.metrics.append(Metric(m["name"], m["unit"], m["better"], m["source"],
                                           m.get("workloads"), per_layer))

    def cell(self, name: str) -> Cell:
        for w in self.doc.get("workloads", []):
            if w["name"] == name:
                return Cell(name, w["config"], w["traffic"], int(w["chips"]),
                            config(w["config"]), traffic(w["traffic"]))
        raise SpecError(f"no workload {name!r} in BENCHMARK.json")

    def metrics_of(self, cell: str, per_layer: bool) -> List[Metric]:
        return [m for m in self.metrics if m.per_layer == per_layer and m.applies(cell)]


def config(name: str) -> dict:
    return _json(os.path.join(BENCH_DIR, "configs", f"{name}.json"))


def traffic(name: str) -> dict:
    return _json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))

