"""One run of one cell: set-up, the measured window, the check, the
metrics, and the result's line (see benchmark/README.md)."""

from __future__ import annotations

import argparse
import gc
import json
import multiprocessing
import os
import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from harness import check, spec, streams, tpchgen, traffic

FORBIDDEN = {"jax", "jaxlib", "flax", "tidb_tpu"}  # whole top-level names
PROGRAM = "tidb_tpu_torch"
WARM_MAX = 6       # runs of one statement until one builds and captures nothing
DRAIN_S = 60.0     # a statement in flight at the close gets this long
CACHE_DIR = os.path.join(spec.BENCH_DIR, ".cache")


def log(t_start: float, msg: str) -> None:
    print(f"# {time.monotonic() - t_start:8.2f}s {msg}", file=sys.stderr, flush=True)


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program builds its nvcc libraries into build/ by itself)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


@dataclass
class Statement:
    stream: int
    tag: str
    t_send: float
    t_done: float
    failed: bool
    wrong: bool = False
    gap: float = 0.0
    why: str = ""

    @property
    def query(self) -> str:
        return traffic.untag(self.tag)[0]

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_send


@dataclass
class Context:
    """What a metric's reader reads (metrics/<name>.py: read(ctx))."""
    cell: str
    kind: str                 # the card's name
    seconds: float            # --seconds: no statement is sent from t0 + seconds on
    t0: float                 # the window's first send
    t_close: float            # its close: the first completion from t0 + seconds on
    setup_s: float
    statements: List[Statement]
    counters: dict            # the program's counters over the window and its drain
    work: Dict[str, dict]     # tag -> the reference's work counts
    trace: Optional[dict]     # the reduced trace (--trace 1)
    peak_window_bytes: Optional[int]


def _runs(d: dict) -> Dict[str, int]:
    out: Dict[str, int] = {}
    for per in d.values():
        for how, n in per.items():
            out[how] = out.get(how, 0) + n
    return out


def _run_delta(after: dict, before: dict) -> Dict[str, int]:
    a, b = _runs(after), _runs(before)
    return {k: a[k] - b.get(k, 0) for k in a if a[k] != b.get(k, 0)}


class Streams:
    """The client process's connections, driven one statement at a time
    during set-up (see harness/streams.py)."""

    def __init__(self, pipe, n: int):
        self.pipe, self.n = pipe, n

    def run(self, k: int, sql: str) -> None:
        self.pipe.send(("run", k, sql))
        if not self.pipe.poll(1200):
            raise RuntimeError("the client process did not answer")
        _, err = self.pipe.recv()
        if err is not None:
            raise RuntimeError(f"set-up statement failed on stream {k}: {err}")


def warm_up(conns: Streams, plan: traffic.Plan, t_start: float) -> dict:
    """On each stream's own connection (each has its own session: its
    sharding cache and programs), each statement of the cell until a run
    of it builds and captures nothing. What the window still builds is the
    program's own cache at work (its quota): `replay_share_pct` reads it."""
    from harness import sut

    runs_of = {}
    for k in range(conns.n):
        for tag in plan.tags():
            for i in range(1, WARM_MAX + 1):
                before = sut.counters()["runs"]
                conns.run(k, plan.sql[tag])
                d = _run_delta(sut.counters()["runs"], before)
                if not any(h in d for h in ("eager", "capture", "eager_multi_device")):
                    break
            runs_of[f"{k}:{tag}"] = i
        log(t_start, f"warm stream {k}: {[runs_of[f'{k}:{t}'] for t in plan.tags()]} runs")
    return runs_of


def run_cell(bench: spec.Benchmark, cell: spec.Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device: str = "cuda", scale: Optional[float] = None,
             before_window: Optional[Callable[[], None]] = None) -> dict:
    """Set up, measure, check. `device` and `scale` other than the cell's
    are for the harness's own tests on the CPU; `before_window` plants a
    fault for them."""
    mp = multiprocessing.get_context("spawn")
    parent, child_end = mp.Pipe()
    proc = mp.Process(target=streams.child_main, args=(child_end,), name="benchmark-clients")
    proc.start()
    try:
        return _run(bench, cell, seed, seconds, trace, t_start, device, scale, before_window,
                    parent, proc)
    finally:
        if proc.is_alive():
            proc.terminate()
        proc.join(30)


def _run(bench, cell, seed, seconds, trace, t_start, device, scale, before_window,
         parent, proc) -> dict:
    import torch

    from harness import sut
    from harness import trace as tr

    sf = float(scale if scale is not None else cell.config["scale_factor"])
    plan = traffic.plan(cell, seed)
    log(t_start, f"cell {cell.name}: sf {sf}, {len(plan.streams)} streams, "
                 f"{len(plan.sql)} statements")
    tables = tpchgen.generate(sf, seed)
    log(t_start, f"generated lineitem {tables['lineitem'].rows} rows")
    catalog = sut.load(tables)
    log(t_start, "loaded")
    server, dev = sut.start_server(catalog, device, cell.config.get("mesh", "auto"))
    on_card = dev.type == "cuda"
    parent.send(("127.0.0.1", server.port, sut.DB, plan.streams, plan.sql))
    if not parent.poll(120):
        raise RuntimeError("the client process did not connect")
    conns = Streams(parent, parent.recv()[1])
    for name in tpchgen.LOAD_ORDER:  # as a deployment runs after a bulk load
        t = time.monotonic()
        conns.run(0, f"analyze table {name}")
        log(t_start, f"analyze table {name}: {time.monotonic() - t:.2f}s")
    warmed = warm_up(conns, plan, t_start)
    log(t_start, "warmed")
    if before_window is not None:
        before_window()

    c0 = sut.counters()
    peak_setup = torch.cuda.max_memory_reserved() if on_card else None
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    window = tr.Window(os.path.join(CACHE_DIR, "trace", "window.json")) if trace else None
    if window is not None:
        window.start()
    t0 = time.monotonic() + 0.02
    t_end = t0 + seconds
    parent.send(("go", t0, t_end, DRAIN_S))
    if not parent.poll(seconds + DRAIN_S + 60):
        raise RuntimeError("the client process did not report")
    _, records, child_modules = parent.recv()
    if on_card:
        torch.cuda.synchronize()
    if window is not None:
        window.stop()
    peak_window = torch.cuda.max_memory_reserved() if on_card else None
    c1 = sut.counters()
    proc.join(30)
    found = forbidden_modules()
    log(t_start, f"window closed: {len(records)} statements")
    log(t_start, f"probe routes in the window: {sut.delta(c1, c0)['routes']}")

    kind = torch.cuda.get_device_name(dev) if on_card else "cpu"
    server.shutdown(drain=True, timeout=60)
    del server, catalog
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    log(t_start, "server down")

    pairs = [(Statement(k, tag, ts, td, rows is None or err is not None), rows)
             for k, _i, tag, ts, td, rows, err in records if ts < t_end]
    stmts = [s for s, _ in pairs]
    # the statements run one at a time (a worker holds the catalog lock
    # for a whole statement): closing at a completion leaves no work half done
    t_close = min([s.t_done for s in stmts if s.t_done >= t_end] or [t_end])
    errors = [r[6] for r in records if r[6]]
    reduced = tr.reduce(window, [(s.tag, s.t_send, s.t_done) for s in stmts]) if window else None

    # the reference, once the window has closed and the program's state is freed
    want, work = {}, {}
    for tag in sorted({s.tag for s in stmts}):
        q, i = traffic.untag(tag)
        want[tag], work[tag] = plan.queries[q].mod.reference(tables, plan.params[q][i])
    verdicts = []
    for s, rows in pairs:
        if not s.failed:
            mod = plan.queries[s.query].mod
            s.wrong, s.gap, s.why = check.judge(rows, want[s.tag], mod.COLUMNS, mod.ORDER_BY)
        verdicts.append((s.failed, s.wrong, s.gap))
    readings = check.readings(verdicts)
    has_floats = any("float" in q.mod.COLUMNS for q in plan.queries.values())
    names = check.compared(has_floats)
    log(t_start, "checked")

    ctx = Context(cell.name, kind, float(seconds), t0, t_close, t0 - t_start, stmts,
                  sut.delta(c1, c0), work, reduced, peak_window)
    metrics = {}
    for m in bench.metrics_of(cell.name, per_layer=trace):
        v = spec.metric_reader(m.name).read(ctx)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    peaks = [p for p in (peak_setup, peak_window) if p is not None]
    result = {
        "correct": check.passes(readings, names) and not found and bool(stmts),
        "attempted": len(stmts),
        "failed": readings["failed"],
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu", "kind": kind,
                   "count": cell.chips, "memory_peak_bytes": max(peaks) if peaks else 0},
    }
    if reduced is not None:
        result["device"].update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
        result["breakdown"] = {"device_ops": reduced["device_ops"],
                               "idle_gaps": reduced["idle_gaps"]}
    result["checks"] = check.as_json(readings, names)
    return {"result": result, "found": found, "child_modules": child_modules,
            "check_lines": check.lines(readings, names), "warm": warmed,
            "statements": stmts, "errors": errors[:5],
            "wrong": [(s.tag, s.why) for s in stmts if s.wrong][:5]}


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse_args(argv)
    try:
        bench = spec.Benchmark()
        cell = bench.cell(args.workload)
    except spec.SpecError as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(spec.ROOT, PROGRAM)):
        print(f"benchmark: the program ({PROGRAM}/) is not in this checkout", file=sys.stderr)
        return 2
    set_cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    out = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), t_start)
    if out["found"]:
        print(f"benchmark: the run's process holds {out['found']} after the window",
              file=sys.stderr)
        return 3
    bad = sorted(set(out["child_modules"]) & (FORBIDDEN | {"torch", PROGRAM}))
    if bad:
        print(f"benchmark: the client process loaded {bad}", file=sys.stderr)
        return 3
    for e in out["errors"]:
        print(f"# error: {e}", file=sys.stderr)
    for tag, why in out["wrong"]:
        print(f"# wrong: {tag}: {why}", file=sys.stderr)
    print(json.dumps(out["result"]), flush=True)
    for line in out["check_lines"]:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    return 0
