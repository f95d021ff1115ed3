"""The statements of one run, from a traffic mix, a configuration and the
seed (one generator for every mix: a mix is a data file).

A mix names its queries, how many parameter sets each query draws
(`param_sets`, inside the spec's substitution domains, by the query's
own draw()), and its number of streams: an integer, or the name of the
configuration's key that holds it (`query_streams`, the spec's minimum).
Each stream is a closed loop over rounds; a round is every query of the
mix once, in an order drawn from the seed, and each execution takes one
of its query's parameter sets, drawn from the seed. So every seed gives
the same kinds of work in another order."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

from harness import spec

ROUNDS = 400  # rounds per stream: more than any window completes


@dataclass
class Plan:
    queries: Dict[str, spec.Query]
    params: Dict[str, List[dict]]      # query -> its parameter sets
    streams: List[List[str]]           # per stream, its statements' tags
    sql: Dict[str, str]                # tag ("q3#1") -> statement text

    def tags(self) -> List[str]:
        return sorted(self.sql)


def tag(q: str, i: int) -> str:
    return f"{q}#{i}"


def untag(t: str) -> Tuple[str, int]:
    q, i = t.split("#")
    return q, int(i)


def n_streams(mix: dict, config: dict) -> int:
    s = mix["streams"]
    return int(config[s]) if isinstance(s, str) else int(s)


def plan(cell: spec.Cell, seed: int, rounds: int = ROUNDS) -> Plan:
    mix = cell.traffic
    if mix.get("loop", "closed") != "closed" or mix.get("order", "rounds") != "rounds":
        raise spec.SpecError(f"traffic {cell.traffic_name}: only closed loops over rounds")
    names = list(mix["queries"])
    queries = {q: spec.query(q) for q in names}
    k = int(mix["param_sets"])
    params, sql = {}, {}
    for qi, q in enumerate(names):
        rng = np.random.default_rng([seed, 1, qi])
        sets: List[dict] = []
        for _ in range(1000):
            p = queries[q].mod.draw(rng)
            if p not in sets:
                sets.append(p)
            if len(sets) == k:
                break
        params[q] = sets
        for i, p in enumerate(sets):
            sql[tag(q, i)] = queries[q].text(p)
    streams = []
    for s in range(n_streams(mix, cell.config)):
        rng = np.random.default_rng([seed, 2, s])
        tags = []
        for _ in range(rounds):
            for qi in rng.permutation(len(names)):
                q = names[qi]
                tags.append(tag(q, int(rng.integers(0, len(params[q])))))
        streams.append(tags)
    return Plan(queries, params, streams, sql)
