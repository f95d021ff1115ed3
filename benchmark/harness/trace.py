"""The traced window (`--trace 1`): torch.profiler over the card for the
whole window, reduced to the device's busy time, kernel time by name,
the longest idle gaps and the device operations that took most time.

The method is a frozen copy of chip_smoke.py's profile_query and
trace_summary (device time = the sum over kernels, copies and sets on
the card), with busy time taken as the union of their intervals so that
overlapping streams count once. Two marks on this thread, taken with
time.monotonic() beside them, tie the trace's clock to the clients'.
"""

from __future__ import annotations

import json
import os
import time
from typing import List, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
START, END = "benchmark.window.start", "benchmark.window.end"


class Window:
    def __init__(self, path: str):
        self.path = path
        self.prof = None

    @staticmethod
    def _mark(name: str) -> float:
        from torch.profiler import record_function

        t = time.monotonic()
        with record_function(name):
            pass
        return t

    def start(self) -> float:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t_start = self._mark(START)
        return self.t_start

    def stop(self) -> None:
        self._mark(END)
        self.prof.__exit__(None, None, None)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self.prof.export_chrome_trace(self.path)
        self.prof = None


def _union(iv: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def reduce(window: Window, statements: List[tuple]) -> Optional[dict]:
    """statements: (tag, t_send, t_done) in time.monotonic() seconds.
    Returns busy_s, window_s, kernel seconds by name, device_ops and
    idle_gaps; None when the trace holds no mark."""
    with open(window.path) as f:
        events = json.load(f).get("traceEvents", [])
    os.remove(window.path)
    marks = {e["name"]: float(e["ts"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") in (START, END)}
    if START not in marks or END not in marks:
        return None
    # trace microseconds -> monotonic seconds
    off = window.t_start - marks[START] / 1e6
    lo, hi = marks[START], marks[END]
    iv, by_name = [], {}
    for e in events:
        if e.get("cat") not in DEVICE_CATS or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        iv.append((a, b))
        if e.get("cat") == "kernel":
            name = str(e.get("name", ""))
            by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e6
    busy = _union(iv)
    busy_s = sum(b - a for a, b in busy) / 1e6
    gaps, prev = [], lo
    for a, b in busy + [(hi, hi)]:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    gaps.sort(key=lambda g: g[0] - g[1])

    def doing(mid_us: float) -> str:
        t = mid_us / 1e6 + off
        live = sorted({tag for tag, t0, t1 in statements if t0 <= t <= t1})
        return "host, in flight: " + ("+".join(live) if live else "no statement")

    idle = [[doing((a + b) / 2), (b - a) / 1e6] for a, b in gaps[:10]]
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_s, "window_s": (hi - lo) / 1e6, "kernel_s": by_name,
            "device_ops": [[n[:160], s] for n, s in ops], "idle_gaps": idle}


def kernel_seconds(reduced: Optional[dict], patterns) -> Optional[float]:
    """Device seconds of the kernels whose names hold one of `patterns`."""
    if not reduced:
        return None
    s = sum(v for n, v in reduced["kernel_s"].items() if any(p in n for p in patterns))
    return s or None

