#!/usr/bin/env python3
"""Host-side A/B of the port (tidb_tpu_torch) on one card: the five SF1
TPC-H queries' warm medians, the 22 SF0.1 queries' warm medians, the
16-connection point-select rate, and what the built-program cache
(utils/jitcache.py: one CUDA graph per fused batch's signature) costs and
saves against the eager path.

    python3 host_ab.py [--root DIR] [--label NAME] [--out PATH] [--sf SF]
                       [--device cuda|cpu] [--no-cache-probe] [--host-profile]
                       [--mesh SHARDS[,SHARDS...]] [--pairs N] [--mix ROUNDS]

`--root` is a checkout of the repository whose tidb_tpu_torch is measured
(by default the one this file is in); the helpers (the numpy evaluations,
the point-select client fleet) come from the chip_smoke.py beside this
file, so two checkouts are measured by the same code. To compare two
commits, unpack the older into a directory that .gitignore lists and run
older, newer, newer, older in one call, each in a process of its own.

Steps, on one Session each (seed 7):
1. TPC-H at `--sf` (1.0): Q1, Q6, Q3, Q5, Q18, one cold run and three
   warm runs each; the rows equal across runs and equal to chip_smoke's
   numpy evaluation.
2. The port's server over that catalog: 16 connections of 500 prepared
   point-selects on orders (chip_smoke.point_fleet: rows equal numpy's);
   statements/s, p50 and p99 client latency.
3. TPC-H at SF0.1 (chunk capacity 8,192): the 22 queries, one cold and
   three warm runs each (rows equal across runs).
4. Unless --no-cache-probe is given, where the checkout's
   utils/jitcache.py captures CUDA graphs (it has `set_graphs`): steps 1,
   3 and 2 again on the eager path (`jitcache.eager()`, the explicit
   switch), against the graph replay of steps 1-3 in the same process,
   with the bytes the graphs hold; then step 3 once more with each key's
   repr and each build timed, by site. Where the checkout's jitcache has
   no graphs: steps 3 and 2 with the cache bypassed (every cached_jit
   call builds), then both with each key and build timed. The eager or
   bypassed runs' rows must equal the others'.

With `--host-profile` it runs instead: TPC-H at `--sf`, then for Q1, Q6,
Q3 and Q5 in that order, on the eager path (`jitcache.eager()`) and by graph replay, four
warm runs, one timed run and one run under cProfile: the wall time and
the functions that took the most host time (tottime), in the report's
"host_profile".

With `--mesh SHARDS[,SHARDS...]` it runs instead the mesh tier: TPC-H at
`--sf`, the five queries' warm medians on the single-card session, then
on each mesh over the one card (1: `make_mesh()`, the one-card mesh; n:
n shards on it) one cold run of each query, graph runs until one captures
nothing (at most four), and `--pairs` rounds of (eager, replay, replay,
eager) in that process, the rows equal across
runs and to numpy's. Per query and mode it reports the warm median, the
programs' runs by namespace (`jitcache.runs()`), the fragments
dispatched, the device->host fetches and the kernels' launches of the
last run, one profiled replayed run (chip_smoke.profile_query: device
busy and idle), the bytes the graphs hold after it (its statement's
memory pool the most recent unit), and per mesh the bytes the graphs
hold. With `--host-profile` as well, the cProfile step above runs on
each mesh session instead of the single card's. With `--mix ROUNDS` as
well, a mixed client on the one-card mesh follows, from an empty
program cache: Q1, Q5 and Q18 in turn, two rounds to warm up and
capture, then `--pairs` groups of (graphs, eager, eager, graphs) rounds
of ROUNDS rounds each (a round is the three queries once), rows equal
to the mesh's; per query and mode the warm median, and per graphs round
the programs' runs (replays, or captures when one statement's graphs
pushed out another's) and the units the cache holds.

Prints one JSON line last and writes the report to `--out`
(chiprun_out/host_ab_<label>.json by default). Exits non-zero without a
card unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import builtins
import importlib.util
import json
import os
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
FIVE = ("q1", "q6", "q3", "q5", "q18")
# the modules whose cached_jit call sites build their keys with repr, and
# the segment scan's key (its own cache's, and the fused bodies')
KEY_MODULES = ("executor.scan", "executor.sort", "executor.aggregate",
               "executor.agg_device", "executor.join", "executor.pipeline",
               "ops.segment_scan")


def load_smoke():
    """chip_smoke.py beside this file, whatever the measured root holds."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_for_ab", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def median(xs):
    xs = sorted(xs)
    return xs[len(xs) // 2]


def pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def timed_runs(s, sql, warm: int = 3):
    """One cold and `warm` warm runs; (rows, cold s, warm s list)."""
    t0 = time.perf_counter()
    rows = s.query(sql)
    cold = time.perf_counter() - t0
    runs = []
    for _ in range(warm):
        t0 = time.perf_counter()
        again = s.query(sql)
        runs.append(time.perf_counter() - t0)
        if again != rows:
            raise AssertionError(f"a warm run's rows differ: {sql[:60]}")
    return rows, cold, runs


def five_queries(np, cs, s) -> dict:
    from tidb_tpu_torch.storage.tpch_queries import Q

    out, res = {}, {}
    for q in FIVE:
        res[q], cold, runs = timed_runs(s, Q[q][0])
        out[q] = {"cold_ms": cold * 1e3, "warm_ms": [r * 1e3 for r in runs],
                  "median_ms": median(runs) * 1e3}
    li = s.catalog.table("test", "lineitem")
    cs.check_q1(np, res["q1"], cs.numpy_q1(np, li))
    if len(res["q6"]) != 1 or cs._scaled(res["q6"][0][0]) != cs.numpy_q6(np, li):
        raise AssertionError(f"Q6 {res['q6']} vs numpy")
    cs.check_join_rows("q3", res["q3"], cs.numpy_q3(np, s.catalog), {1})
    cs.check_join_rows("q5", res["q5"], cs.numpy_q5(np, s.catalog), {1})
    cs.check_join_rows("q18", res["q18"], cs.numpy_q18(np, s.catalog)[0], {4, 5})
    return out


def point_selects(np, cs, cat, device) -> dict:
    from tidb_tpu_torch.server import Server

    srv = Server(catalog=cat, host="127.0.0.1", port=0, status_port=0, device=device)
    srv.start()
    try:
        r = cs.point_fleet(np, cat, srv.port, cs.POINT_CONNS, cs.POINT_STMTS)
    finally:
        srv.shutdown(drain=True)
    lat = r["latency_s"]
    return {"statements": r["statements"], "wall_s": r["wall_s"],
            "stmt_per_s": r["statements"] / r["wall_s"],
            "p50_ms": pct(lat, 0.5) * 1e3, "p99_ms": pct(lat, 0.99) * 1e3}


def grid(s) -> tuple:
    """The 22 queries, one cold and three warm runs: (report, rows)."""
    from tidb_tpu_torch.storage.tpch_queries import Q

    out, rows = {}, {}
    for name, (sql, _osql) in Q.items():
        rows[name], cold, runs = timed_runs(s, sql)
        out[name] = {"cold_ms": cold * 1e3, "median_ms": median(runs) * 1e3}
    out["sum_median_ms"] = sum(v["median_ms"] for v in out.values())
    return out, rows


class CacheProbe:
    """Wraps jitcache.get_or_build (bypassing the cache with `bypass`,
    timing every build otherwise) and each KEY_MODULES module's `repr`
    (the key's cost, by module and calling function)."""

    def __init__(self, jitcache, bypass: bool, time_keys: bool):
        import importlib

        self.jc, self.real = jitcache, jitcache.get_or_build
        self.lock = threading.Lock()
        self.keys, self.builds = {}, {}
        self.mods = [importlib.import_module("tidb_tpu_torch." + m) for m in KEY_MODULES]
        if time_keys:
            for m in self.mods:
                m.repr = self._timed_repr(m.__name__.split(".", 1)[1])
        jitcache.get_or_build = self._get_or_build_bypass if bypass else self._get_or_build

    def _timed_repr(self, modname):
        def timed(obj):
            t0 = time.perf_counter()
            r = builtins.repr(obj)
            dt = time.perf_counter() - t0
            f = sys._getframe(1)
            k = f"{modname}.{f.f_code.co_name} (from {f.f_back.f_code.co_name})"
            with self.lock:
                e = self.keys.setdefault(k, [0, 0.0, 0])
                e[0] += 1
                e[1] += dt
                e[2] = max(e[2], len(r))
            return r
        return timed

    def _note(self, ns, built, build_s, total_s):
        with self.lock:
            e = self.builds.setdefault(ns, [0, 0, 0.0, 0.0])
            e[0] += 1
            e[1] += built
            e[2] += build_s
            e[3] += total_s

    def _get_or_build(self, cache, key, build, n):
        t0 = time.perf_counter()
        spent = []

        def timed_build():
            t1 = time.perf_counter()
            v = build()
            spent.append(time.perf_counter() - t1)
            return v

        v = self.real(cache, key, timed_build, n)
        self._note(key[0], len(spent), sum(spent), time.perf_counter() - t0)
        return v

    def _get_or_build_bypass(self, cache, key, build, n):
        t0 = time.perf_counter()
        v = build()
        dt = time.perf_counter() - t0
        self._note(key[0], 1, dt, dt)
        return v

    def restore(self):
        self.jc.get_or_build = self.real
        for m in self.mods:
            m.__dict__.pop("repr", None)

    def report(self) -> dict:
        keys = {k: {"calls": c, "ms": s * 1e3, "us_per_call": s * 1e6 / c, "max_chars": n}
                for k, (c, s, n) in sorted(self.keys.items())}
        builds = {ns: {"calls": c, "builds": b, "build_ms": bs * 1e3,
                       "us_per_build": bs * 1e6 / b if b else None,
                       "lookup_us_per_call": (t - bs) * 1e6 / c}
                  for ns, (c, b, bs, t) in sorted(self.builds.items())}
        return {"keys": keys, "builds": builds}


def host_profile(s, device: str, top: int = 12) -> dict:
    """Q1, Q6, Q3 and Q5 on the eager path and by replay: a timed warm run and
    the top host functions of a profiled one (cProfile, by tottime)."""
    import cProfile
    import pstats

    import torch

    from tidb_tpu_torch.storage.tpch_queries import Q
    from tidb_tpu_torch.utils import jitcache

    def sync():
        if device == "cuda":
            torch.cuda.synchronize()

    out = {}
    try:
        for q in ("q1", "q6", "q3", "q5"):
            for mode in ("eager", "graphs"):
                jitcache.set_graphs(mode == "graphs")
                for _ in range(4):
                    s.query(Q[q][0])
                sync()
                t0 = time.perf_counter()
                s.query(Q[q][0])
                sync()
                wall = time.perf_counter() - t0
                prof = cProfile.Profile()
                prof.enable()
                s.query(Q[q][0])
                sync()
                prof.disable()
                stats = pstats.Stats(prof).stats
                rows = sorted(((tt, ct, n, f"{fn[0]}:{fn[1]}({fn[2]})")
                               for fn, (_cc, n, tt, ct, _callers) in stats.items()),
                              reverse=True)[:top]
                out[f"{q}_{mode}"] = {
                    "wall_ms": wall * 1e3,
                    "top": [{"fn": f, "calls": n, "tottime_ms": tt * 1e3, "cumtime_ms": ct * 1e3}
                            for tt, ct, n, f in rows]}
    finally:
        jitcache.set_graphs(True)
    return out


def mesh_counts(cs, s, sql: str) -> tuple:
    """One run of `sql` with its counts: (rows, seconds, counts), the
    counts the programs' runs by namespace, the fragments dispatched, the
    device->host fetches and the kernels' launches."""
    from tidb_tpu_torch.ops import hash_probe as hp
    from tidb_tpu_torch.ops import segment_sum as seg_mod
    from tidb_tpu_torch.utils import dispatch, jitcache

    seg_mod.reset_launches()
    hp.reset_launches()
    jitcache.reset_runs()
    f0, d0 = dispatch.fetch_count(), dispatch.fragment_count()
    t0 = time.perf_counter()
    rows = s.query(sql)
    dt = time.perf_counter() - t0
    launches = {k: v for k, v in {**seg_mod.LAUNCHES, **hp.LAUNCHES}.items() if v}
    return rows, dt, {"programs": jitcache.runs(), "fragments": dispatch.fragment_count() - d0,
                      "device_get": dispatch.fetch_count() - f0, "launches": launches}


def mesh_ab(np, cs, s, shards: list, pairs: int, device: str, profile: bool,
            mix: int = 0) -> dict:
    """The mesh step (the module docstring's --mesh) over the catalog of the
    single-card session `s`."""
    import torch

    from tidb_tpu_torch.parallel import make_mesh
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage.tpch_queries import Q
    from tidb_tpu_torch.utils import jitcache

    out = {"single_card": five_queries(np, cs, s)}
    cat = s.catalog.base
    dev = torch.device(device, 0) if device == "cuda" else torch.device("cpu")
    for n in shards:
        mesh = make_mesh() if n == 1 and device == "cuda" else \
            make_mesh(n_shards=n, devices=[dev] * n)
        sm = Session(cat, mesh=mesh)
        per = out[f"mesh{n}"] = {"mesh": repr(mesh)}
        rows = {}
        for q in FIVE:
            sql = Q[q][0]
            rows[q] = sm.query(sql)  # cold: shards the tables, proves capacities
            settle = []
            for _ in range(4):  # warm-ups and captures, until a run captures nothing
                got, _dt, cnt = mesh_counts(cs, sm, sql)
                if got != rows[q]:
                    raise AssertionError(f"mesh{n} {q}: a graph run's rows differ")
                settle.append(cnt["programs"])
                if not any(r.get("capture") or r.get("eager") for r in cnt["programs"].values()):
                    break
            times = {"eager": [], "graphs": []}
            last = {}
            for _ in range(pairs):
                for mode in ("eager", "graphs", "graphs", "eager"):
                    jitcache.set_graphs(mode == "graphs")
                    got, dt, cnt = mesh_counts(cs, sm, sql)
                    if got != rows[q]:
                        raise AssertionError(f"mesh{n} {q} {mode}: rows differ")
                    times[mode].append(dt * 1e3)
                    last[mode] = cnt
            jitcache.set_graphs(True)
            per[q] = {m: {"warm_ms": t, "median_ms": median(t), "last_run": last[m]}
                      for m, t in times.items()}
            per[q]["settle"] = settle
            if device == "cuda":
                # right after its pairs, while its graphs are cached
                jitcache.reset_runs()
                per[q]["profile"] = cs.profile_query(torch, sm, sql)
                per[q]["profile"]["programs"] = jitcache.runs()
            per[q]["graph_units"] = jitcache.held_units()
        # numpy's answers, as the single-card step checks them
        li = cat.table("test", "lineitem")
        cs.check_q1(np, rows["q1"], cs.numpy_q1(np, li))
        if len(rows["q6"]) != 1 or cs._scaled(rows["q6"][0][0]) != cs.numpy_q6(np, li):
            raise AssertionError(f"mesh{n} Q6 {rows['q6']} vs numpy")
        cs.check_join_rows("q3", rows["q3"], cs.numpy_q3(np, s.catalog), {1})
        cs.check_join_rows("q5", rows["q5"], cs.numpy_q5(np, s.catalog), {1})
        cs.check_join_rows("q18", rows["q18"], cs.numpy_q18(np, s.catalog)[0], {4, 5})
        per["graph_bytes"] = {ns: sum(v) for ns, v in jitcache.graph_bytes().items()}
        per["graph_resident_bytes"] = jitcache.resident_bytes()
        if profile:
            per["host_profile"] = host_profile(sm, device)
        jitcache.clear()
        if mix and n == 1:
            per["mix"] = mesh_mix(cs, sm, rows, mix, pairs)
        sm._shard_cache.clear_tables()
        del sm
        jitcache.clear()
        if device == "cuda":
            torch.cuda.empty_cache()
    return out


MIX = ("q1", "q5", "q18")


def mesh_mix(cs, sm, rows: dict, rounds: int, pairs: int) -> dict:
    """The --mix step on the mesh session `sm`, from an empty program
    cache: two rounds of MIX to warm up and capture, then `pairs` groups
    of (graphs, eager, eager, graphs) blocks of `rounds` rounds."""
    from tidb_tpu_torch.storage.tpch_queries import Q
    from tidb_tpu_torch.utils import jitcache

    def one_round(mode: str, out: list) -> None:
        jitcache.set_graphs(mode == "graphs")
        try:
            for q in MIX:
                got, dt, cnt = mesh_counts(cs, sm, Q[q][0])
                if got != rows[q]:
                    raise AssertionError(f"mix {q} {mode}: rows differ")
                out.append({"q": q, "mode": mode, "ms": dt * 1e3,
                            "programs": cnt["programs"], "units": jitcache.held_units()})
        finally:
            jitcache.set_graphs(True)

    settle: list = []
    for _ in range(2):
        one_round("graphs", settle)
    timed: list = []
    for _ in range(pairs):
        for mode in ("graphs", "eager", "eager", "graphs"):
            for _ in range(rounds):
                one_round(mode, timed)
    per = {q: {m: median([r["ms"] for r in timed if r["q"] == q and r["mode"] == m])
               for m in ("eager", "graphs")} for q in MIX}
    graph_runs = [r for r in timed if r["mode"] == "graphs"]
    hows: dict = {}
    for r in graph_runs:
        for ns, v in r["programs"].items():
            for how, k in v.items():
                hows[how] = hows.get(how, 0) + k
    return {"median_ms": per, "settle": settle, "timed": timed,
            "graph_runs_by_outcome": hows,
            "units_last": graph_runs[-1]["units"] if graph_runs else []}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--label", default="tree")
    ap.add_argument("--out", default=None)
    ap.add_argument("--sf", type=float, default=1.0)
    ap.add_argument("--grid-sf", type=float, default=0.1)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-cache-probe", action="store_true")
    ap.add_argument("--host-profile", action="store_true")
    ap.add_argument("--mesh", default=None,
                    help="comma-separated shard counts of meshes over the one card")
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--mix", type=int, default=0,
                    help="rounds per block of the mixed Q1/Q5/Q18 step on the one-card mesh")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import tidb_tpu_torch

    if not os.path.abspath(tidb_tpu_torch.__file__).startswith(root + os.sep):
        print(f"tidb_tpu_torch came from {tidb_tpu_torch.__file__}, not {root}",
              file=sys.stderr)
        return 1
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device: host_ab.py measures the port on a card", file=sys.stderr)
        return 1
    from tidb_tpu_torch.session import Session

    cs = load_smoke()
    rep = {"label": args.label, "root": root, "device": args.device,
           "card": cs.card_line() if args.device == "cuda" else "cpu"}
    t_all = time.perf_counter()
    s = Session(device=args.device)
    t0 = time.perf_counter()
    s.load_tpch(args.sf)
    rep["load_s"] = time.perf_counter() - t0
    if args.mesh:
        shards = [int(x) for x in args.mesh.split(",")]
        rep["mesh"] = mesh_ab(np, cs, s, shards, args.pairs, args.device, args.host_profile,
                              args.mix)
        summary = {"label": args.label, "card": rep["card"],
                   "single_card_median_ms": {q: round(v["median_ms"], 3) for q, v in
                                             rep["mesh"]["single_card"].items()}}
        for n in shards:
            m = rep["mesh"][f"mesh{n}"]
            summary[f"mesh{n}_median_ms"] = {
                q: {mode: round(m[q][mode]["median_ms"], 3) for mode in ("eager", "graphs")}
                for q in FIVE}
            summary[f"mesh{n}_graph_resident_bytes"] = m["graph_resident_bytes"]
            summary[f"mesh{n}_pool_bytes"] = {q: m[q]["graph_units"][-1:] for q in FIVE}
            if "mix" in m:
                summary[f"mesh{n}_mix"] = {
                    "median_ms": {q: {k: round(v, 3) for k, v in d.items()}
                                  for q, d in m["mix"]["median_ms"].items()},
                    "graph_runs_by_outcome": m["mix"]["graph_runs_by_outcome"],
                    "units_last": m["mix"]["units_last"]}
        return _write(args, rep, summary)
    if args.host_profile:
        rep["host_profile"] = host_profile(s, args.device)
        return _write(args, rep, {"label": args.label, "card": rep["card"], "host_profile": {
            k: {"wall_ms": round(v["wall_ms"], 3), "top": v["top"][0]}
            for k, v in rep["host_profile"].items()}})
    rep["five"] = five_queries(np, cs, s)
    rep["points"] = point_selects(np, cs, s.catalog, args.device)
    g = Session(device=args.device, chunk_capacity=8192)
    g.load_tpch(args.grid_sf)
    rep["grid"], grid_rows = grid(g)
    try:
        from tidb_tpu_torch.utils import jitcache
    except ImportError:
        jitcache = None
    if args.no_cache_probe:
        jitcache = None
    if jitcache is not None and hasattr(jitcache, "set_graphs"):
        rep["graph_bytes"] = jitcache.graph_bytes()
        rep["graph_resident_bytes"] = jitcache.resident_bytes()
        with jitcache.eager():
            rep["five_eager"] = five_queries(np, cs, s)
            rep["grid_eager"], rows = grid(g)
            rep["points_eager"] = point_selects(np, cs, s.catalog, args.device)
        if rows != grid_rows:
            raise AssertionError("the grid's rows differ on the eager path")
        probe = CacheProbe(jitcache, bypass=False, time_keys=True)
        try:
            rep["grid_probed"], rows = grid(g)
            rep["grid_costs"] = probe.report()
        finally:
            probe.restore()
        if rows != grid_rows:
            raise AssertionError("the grid's rows differ under the probe")
    elif jitcache is not None:
        jitcache.clear()
        probe = CacheProbe(jitcache, bypass=True, time_keys=False)
        try:
            rep["grid_bypassed"], rows = grid(g)
            rep["points_bypassed"] = point_selects(np, cs, s.catalog, args.device)
        finally:
            probe.restore()
        if rows != grid_rows:
            raise AssertionError("the grid's rows differ with the cache bypassed")
        jitcache.clear()
        probe = CacheProbe(jitcache, bypass=False, time_keys=True)
        try:
            rep["grid_probed"], rows = grid(g)
            rep["grid_costs"] = probe.report()
        finally:
            probe.restore()
        if rows != grid_rows:
            raise AssertionError("the grid's rows differ under the probe")
        probe = CacheProbe(jitcache, bypass=False, time_keys=True)
        try:
            rep["points_probed"] = point_selects(np, cs, s.catalog, args.device)
            rep["points_costs"] = probe.report()
        finally:
            probe.restore()
    rep["seconds"] = time.perf_counter() - t_all
    summary = {"label": args.label, "card": rep["card"],
               "five_median_ms": {q: round(v["median_ms"], 3) for q, v in rep["five"].items()},
               "grid_sum_median_ms": round(rep["grid"]["sum_median_ms"], 3),
               "point_stmt_per_s": round(rep["points"]["stmt_per_s"], 1),
               "point_p50_p99_ms": [round(rep["points"]["p50_ms"], 3),
                                    round(rep["points"]["p99_ms"], 3)]}
    if "five_eager" in rep:
        summary["five_eager_median_ms"] = {q: round(v["median_ms"], 3)
                                           for q, v in rep["five_eager"].items()}
        summary["grid_eager_sum_median_ms"] = round(rep["grid_eager"]["sum_median_ms"], 3)
        summary["point_eager_stmt_per_s"] = round(rep["points_eager"]["stmt_per_s"], 1)
        summary["graph_resident_bytes"] = rep["graph_resident_bytes"]
    elif jitcache is not None:
        summary["grid_bypassed_sum_median_ms"] = round(rep["grid_bypassed"]["sum_median_ms"], 3)
        summary["point_bypassed_stmt_per_s"] = round(rep["points_bypassed"]["stmt_per_s"], 1)
    return _write(args, rep, summary)


def _write(args, rep: dict, summary: dict) -> int:
    """The report to --out (chiprun_out/host_ab_<label>.json by default),
    the summary as the last line."""
    out = args.out or os.path.join(HERE, "chiprun_out", f"host_ab_{args.label}.json")
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(rep, f, indent=1)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
