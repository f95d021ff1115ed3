#!/usr/bin/env python3
"""Diagnostics of the port at scale on one card (not a benchmark).

    python3 sf10_diag.py q5-order [--sf10]
    python3 sf10_diag.py profile

q5-order: TPC-H Q1, Q6 and Q5 on a fresh SF1 Session, then Q1, Q6, Q3 and
Q5 on another; Q5's plan is printed before it runs. For every fused
probe (executor/pipeline.py FusedScanProbeExec) it records, per window of
batches, the batches' match totals, tile_overflows, tile_max_need,
ctx.join_tiles, the bytes of the output chunks waiting in `_pending`
(expansions that wait lazily count nothing) and torch.cuda's allocated
bytes; per query its rows, seconds, error and max_memory_allocated. A
torch.OutOfMemoryError is recorded, not raised. With --sf10 it then loads
SF10 and runs Q6, Q6, Q1, Q1, Q3, Q3 and Q18 the same way (no Q5). JSON
to chiprun_out/q5_order.json.

profile: loads SF10 on a Session on the card, times one
Table.live_rows of lineitem and 96 segment builds serially and on the
host's threads, then cProfiles Q1 cold, Q6 cold, planning Q5, Q5 cold,
planning Q18 and Q1 warm; the reports go to chiprun_out/sf10_profile.txt.

Both build the kernels first and exit non-zero without a card.
"""

import cProfile
import io
import json
import os
import pstats
import resource
import sys
import time

OUT_DIR = "chiprun_out"
_T0 = time.perf_counter()


def log(*a):
    print(f"[{time.perf_counter() - _T0:8.1f} s]", *a, flush=True)


def setup():
    import torch

    if not torch.cuda.is_available():
        print("sf10_diag: no CUDA device is available", file=sys.stderr)
        sys.exit(2)
    import logging

    import chip_smoke as cs
    from tidb_tpu_torch.ops import hash_probe as hp
    from tidb_tpu_torch.ops import nvcc_build
    from tidb_tpu_torch.ops import segment_sum as seg_mod

    logging.getLogger("tidb_tpu_torch.slowlog").setLevel(logging.ERROR)
    log(cs.card_line())
    nvcc_build.build_libraries([os.path.join(nvcc_build.CSRC, m.SOURCE) for m in (seg_mod, hp)])
    seg_mod.load_kernels()
    hp.load_kernels()
    os.makedirs(OUT_DIR, exist_ok=True)
    return torch


def q5_order(sf10: bool) -> None:
    import gc

    torch = setup()
    from tidb_tpu_torch.chunk.chunk import Chunk
    from tidb_tpu_torch.executor import pipeline as pl
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage.tpch_queries import Q

    rec = []
    real_finish = pl.FusedScanProbeExec._finish_fused_batch

    def nbytes(ch):
        return ch.sel.nbytes + sum(c.data.nbytes + c.valid.nbytes for c in ch.columns.values())

    def finish(self, tokens):
        totals = [int(t["total_dev"]) for t in tokens]
        before = len(self._pending)
        real_finish(self, tokens)
        pend = sum(nbytes(c) for c in self._pending if isinstance(c, Chunk))
        r = rec[-1]["probes"].setdefault(id(self), {
            "table": self.table.schema.name, "windows": 0, "batches": 0, "match_total": 0,
            "max_batch_total": 0, "cap": tokens[0]["cap"], "join_tiles": self.ctx.join_tiles,
            "max_pending_bytes": 0, "max_pending_items": 0, "max_alloc_after_window": 0})
        r["windows"] += 1
        r["batches"] += len(tokens)
        r["match_total"] += sum(totals)
        r["max_batch_total"] = max(r["max_batch_total"], max(totals))
        r["max_pending_bytes"] = max(r["max_pending_bytes"], pend)
        r["max_pending_items"] = max(r["max_pending_items"], len(self._pending) - before)
        r["max_alloc_after_window"] = max(r["max_alloc_after_window"],
                                          torch.cuda.memory_allocated())
        r["tile_overflows"] = self.stats.tile_overflows
        r["tile_max_need"] = self.stats.tile_max_need

    pl.FusedScanProbeExec._finish_fused_batch = finish

    def run(s, q):
        rec.append({"query": q, "probes": {}})
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        err, n = None, None
        try:
            n = len(s.query(Q[q][0]))
        except torch.OutOfMemoryError as e:
            err = f"torch.OutOfMemoryError: {str(e)[:160]}"
        except Exception as e:  # noqa: BLE001 — the class is the result
            err = f"{type(e).__name__}: {str(e)[:300]}"
        rec[-1].update(rows=n, s=time.perf_counter() - t0, err=err,
                       max_alloc=torch.cuda.max_memory_allocated(),
                       rss_gb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20)
        rec[-1]["probes"] = list(rec[-1]["probes"].values())
        log(json.dumps(rec[-1]))

    for order in (("q1", "q6", "q5"), ("q1", "q6", "q3", "q5")):
        s = Session()
        log("SF1 load", s.load_tpch(1.0))
        for q in order:
            if q == "q5":
                log("\n".join(r[0] for r in s.execute("explain " + Q["q5"][0]).rows))
            run(s, q)
        del s
        gc.collect()
        torch.cuda.empty_cache()
        log("after close: allocated", torch.cuda.memory_allocated())
    if sf10:
        s = Session()
        t0 = time.perf_counter()
        counts = s.load_tpch(10.0)
        log(f"SF10 load {time.perf_counter() - t0:.1f} s {counts} rss "
            f"{resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20:.1f} GB")
        for q in ("q6", "q6", "q1", "q1", "q3", "q3", "q18"):
            run(s, q)
    with open(os.path.join(OUT_DIR, "q5_order.json"), "w") as f:
        json.dump(rec, f, indent=1)


def profile() -> None:
    torch = setup()
    import chip_smoke as cs
    from tidb_tpu_torch.columnar import store as st
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage.tpch import load_tpch
    from tidb_tpu_torch.storage.tpch_queries import Q
    from tidb_tpu_torch.utils import host_map

    out = open(os.path.join(OUT_DIR, "sf10_profile.txt"), "w")

    def say(*a):
        log(*a)
        print(*a, file=out, flush=True)

    say(f"host cpus {os.cpu_count()}, usable {len(os.sched_getaffinity(0))}")
    s = Session()
    s.execute(f"set tidb_mem_quota_query = {cs.SF10_QUOTA}")
    t0 = time.perf_counter()
    load_tpch(s.catalog, sf=10.0)
    say("load", time.perf_counter() - t0)
    li = s.catalog.table("test", "lineitem")
    t0 = time.perf_counter()
    li.live_rows
    say("live_rows", time.perf_counter() - t0)
    R = 65536
    bounds = [(a, min(a + R, li.n)) for a in range(0, 96 * R, R)]
    t0 = time.perf_counter()
    for b in bounds:
        st._build_segment(li, *b)
    t1 = time.perf_counter()
    host_map(lambda b: st._build_segment(li, *b), bounds)
    say("96 segments serial", t1 - t0, "threaded", time.perf_counter() - t1)

    def prof(label, fn):
        pr = cProfile.Profile()
        t0 = time.perf_counter()
        pr.enable()
        fn()
        pr.disable()
        say(f"== {label}: {time.perf_counter() - t0:.2f} s")
        buf = io.StringIO()
        pstats.Stats(pr, stream=buf).sort_stats("cumulative").print_stats(30)
        pstats.Stats(pr, stream=buf).sort_stats("tottime").print_stats(25)
        say(buf.getvalue())

    prof("q1 cold", lambda: s.query(Q["q1"][0]))
    prof("q6 cold", lambda: s.query(Q["q6"][0]))
    prof("plan q5", lambda: cs.planned(s, Q["q5"][0]))
    prof("q5 cold", lambda: s.query(Q["q5"][0]))
    prof("plan q18", lambda: cs.planned(s, Q["q18"][0]))
    prof("q1 warm", lambda: s.query(Q["q1"][0]))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "q5-order":
        q5_order("--sf10" in sys.argv[2:])
    elif len(sys.argv) > 1 and sys.argv[1] == "profile":
        profile()
    else:
        print(__doc__, file=sys.stderr)
        sys.exit(2)
