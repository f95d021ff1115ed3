"""The per-layer metrics read from the program's statement records
(harness/spans.py): a traced run of the cell at SF0.01 on the CPU
reports all five, with one record per statement sent in the window, and
the program's spans agree with the program's own counters.

Run as a script it drives one traced cell on the CPU and prints one JSON
line (the test runs it so, in a process of its own):

    python3 benchmark/tests/test_bench_spans.py <workload> <seed> <seconds> <scale>
"""

import json
import os
import subprocess
import sys
import time

T_START = time.monotonic()
BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)

NEW = ("lock_wait_ms", "live_rows_ms", "execute_ms", "sync_wait_ms", "untraced_ms")


def cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


def _run(name: str, seed: int) -> dict:
    p = subprocess.run([sys.executable, os.path.abspath(__file__), name, str(seed), "2",
                        "0.01"], capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


def test_a_traced_cpu_run_reports_the_span_metrics():
    for name in cells():
        out = _run(name, 2 ** 31 + 11)
        res, m = out["result"], out["result"]["metrics"]
        assert res["correct"] is True
        for k in NEW:
            assert k in m, k
        assert out["records"] == res["attempted"] > 0
        v = {k: m[k]["value"] for k in m}
        assert v["live_rows_ms"] <= v["plan_ms"]
        assert v["lock_wait_ms"] <= v["server_wait_ms"]
        assert v["sync_wait_ms"] <= v["execute_ms"]
        assert 0 < v["execute_ms"] < out["latency_ms"]
        # the spans lie inside the client's send-to-rows and do not
        # overlap: what is left is the wire, and what no span covers
        assert -0.1 < v["untraced_ms"] < 0.5 * out["latency_ms"]


def main() -> int:
    from harness import runner, spec, spans

    name, seed, seconds, scale = sys.argv[1], int(sys.argv[2]), float(sys.argv[3]), \
        float(sys.argv[4])
    bench = spec.Benchmark()
    seen = {}
    real = spans.records

    def records(ctx):
        recs = real(ctx)
        seen["n"] = None if recs is None else len(recs)
        seen["latency_ms"] = (sum(s.latency_s for s in ctx.statements)
                              / max(len(ctx.statements), 1) * 1000.0)
        return recs

    spans.records = records
    out = runner.run_cell(bench, bench.cell(name), seed, seconds, True, T_START,
                          device="cpu", scale=scale)
    print(json.dumps({"result": out["result"], "records": seen.get("n"),
                      "latency_ms": seen.get("latency_ms")}))
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    os._exit(code)
