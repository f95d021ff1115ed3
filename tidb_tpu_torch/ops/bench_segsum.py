#!/usr/bin/env python
"""Microbenchmark: the port's segment kernels against one library call
of the same function (``index_add_``), the reference's experiment
(tidb_tpu/ops/bench_segsum.py) on the port.

For R rows (default 2^20) and G in {16, 256, 2048} groups it times, with
CUDA events after a warm-up: ``segment_count`` (the masked count,
``tidb_segsum_count``), ``segment_sum_f32`` (``tidb_segsum_f32``) and
``segment_sum_i64`` (``tidb_segsum_i64``), each beside
``torch.zeros(G).index_add_(0, ids, vals)`` on the same inputs, and
checks each result against a float64/int64 numpy evaluation: the f32
sum's relative error (at most F32_REL_TOL), the count exact, the i64
sum exact. Writes the
JSON to ``--out`` (default: SEGSUM_BENCH.json beside this module).

    python -m tidb_tpu_torch.ops.bench_segsum [--out PATH] [--rows R] [--device D]

It needs a card; ``--device cpu`` times the plain versions instead (the
wrappers take them for CPU tensors), on the host clock.
"""

# lint: module-disable=host-sync -- offline microbench: the correctness
# cross-checks fetch every result on purpose, and the timing loop
# synchronizes the card; nothing here runs under a query

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

GROUPS = (16, 256, 2048)
# the f32 sum accumulates in float32 in an order that changes from run to
# run (atomics): its error against a float64 sum, relative to the largest
# group, is held to this
F32_REL_TOL = 1e-4
DEFAULT_OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "SEGSUM_BENCH.json")


def _card_info(torch, dev) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "name": "cpu", "power_limit": None}
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        smi = []
    idx = dev.index or 0
    return {"platform": "gpu", "name": torch.cuda.get_device_name(idx),
            "nvidia_smi": smi[idx] if idx < len(smi) else None}


def _timer(torch, dev, reps: int):
    """ms per call of fn(), after one warm-up call."""
    def run(fn) -> float:
        fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / reps
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    return run


def run(rows: int = 1 << 20, device: str = "cuda", reps: int = 20,
        groups=GROUPS) -> dict:
    import torch

    from tidb_tpu_torch.ops import segment_sum as ss

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("bench_segsum: no CUDA card (pass --device cpu "
                           "to time the plain versions)")
    rng = np.random.default_rng(0)
    vals_h = rng.standard_normal(rows).astype(np.float32)
    # i64: scaled-decimal magnitudes (Q1 extendedprice ~ 1e7 at scale 2);
    # exactness matters, not just speed
    ivals_h = rng.integers(-(10 ** 7), 10 ** 7, rows, dtype=np.int64)
    mask_h = rng.random(rows) < 0.7
    vals = torch.from_numpy(vals_h).to(dev)
    ivals = torch.from_numpy(ivals_h).to(dev)
    mask = torch.from_numpy(mask_h).to(dev)
    ones = torch.ones(rows, dtype=torch.int64, device=dev)
    time_ms = _timer(torch, dev, reps)
    out = {"rows": rows, "device": _card_info(torch, dev), "reps": reps,
           "timer": "cuda events" if dev.type == "cuda" else "host clock",
           "route": "cuda" if dev.type == "cuda" else "plain",
           "configs": []}
    for g in groups:
        seg_h = rng.integers(0, g, rows).astype(np.int64)
        seg = torch.from_numpy(seg_h).to(dev)
        mseg = seg[mask]  # the library count adds ones over masked ids
        want = np.zeros(g, np.float64)
        np.add.at(want, seg_h, vals_h.astype(np.float64))
        got = ss.segment_sum_f32(vals, seg, g).cpu().numpy()
        err = float(np.abs(got - want).max() / max(np.abs(want).max(), 1.0))
        wc = np.zeros(g, np.int64)
        np.add.at(wc, seg_h[mask_h], 1)
        count_exact = bool((ss.segment_count(mask, seg, g).cpu().numpy() == wc).all())
        wi = np.zeros(g, np.int64)
        np.add.at(wi, seg_h, ivals_h)
        i64_exact = bool((ss.segment_sum_i64(ivals, seg, g).cpu().numpy() == wi).all())
        lib_i64 = torch.zeros(g, dtype=torch.int64, device=dev).index_add_(0, seg, ivals)
        lib_exact = bool((lib_i64.cpu().numpy() == wi).all())
        row = {
            "G": g, "sum_rel_err": err, "sum_f32_ok": err <= F32_REL_TOL,
            "count_exact": count_exact,
            "i64_exact": i64_exact, "index_add_i64_exact": lib_exact,
            "count_ms": time_ms(lambda: ss.segment_count(mask, seg, g)),
            "count_index_add_ms": time_ms(lambda: torch.zeros(
                g, dtype=torch.int64, device=dev).index_add_(
                    0, mseg, ones[:mseg.shape[0]])),
            "sum_f32_ms": time_ms(lambda: ss.segment_sum_f32(vals, seg, g)),
            "sum_f32_index_add_ms": time_ms(lambda: torch.zeros(
                g, dtype=torch.float32, device=dev).index_add_(0, seg, vals)),
            "i64_ms": time_ms(lambda: ss.segment_sum_i64(ivals, seg, g)),
            "i64_index_add_ms": time_ms(lambda: torch.zeros(
                g, dtype=torch.int64, device=dev).index_add_(0, seg, ivals)),
        }
        out["configs"].append(row)
    out["f32_rel_tol"] = F32_REL_TOL
    out["all_exact"] = all(c["count_exact"] and c["i64_exact"]
                           and c["sum_f32_ok"] for c in out["configs"])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tidb_tpu_torch.ops.bench_segsum")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    res = run(rows=args.rows, device=args.device, reps=args.reps)
    for c in res["configs"]:
        print(json.dumps(c))
    d = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(d, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print("wrote", args.out)
    return 0 if res["all_exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
