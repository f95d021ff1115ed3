"""Drive one cell of the harness on the CPU at a small scale, past its
look for a card, optionally with a fault planted under the timed path;
print one JSON line. For benchmark/tests only:

    python3 benchmark/tests/cpu_cell.py <workload> <seed> <seconds> <scale> [fault]

faults: altered (one value of each result altered as the session
produces it), half (half of each result's rows left out).
"""

import json
import os
import sys
import time

T_START = time.monotonic()
BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, BENCH)


def plant(fault: str):
    def altered(self, sql):
        rs = real(self, sql)
        if rs is not None and rs.rows:
            row = list(rs.rows[0])
            row[-1] = -1 if row[-1] != -1 else -2
            rs.rows = [tuple(row)] + list(rs.rows[1:])
        return rs

    def half(self, sql):
        rs = real(self, sql)
        if rs is not None and rs.rows is not None:
            rs.rows = list(rs.rows)[: len(rs.rows) // 2]
        return rs

    def install():
        nonlocal real
        from tidb_tpu_torch.session import session as S

        real = S.Session.execute
        S.Session.execute = {"altered": altered, "half": half}[fault]

    real = None
    return install


def main() -> int:
    from harness import runner, spec

    workload, seed, seconds, scale = sys.argv[1], int(sys.argv[2]), float(sys.argv[3]), \
        float(sys.argv[4])
    fault = sys.argv[5] if len(sys.argv) > 5 else None
    bench = spec.Benchmark()
    out = runner.run_cell(bench, bench.cell(workload), seed, seconds, False, T_START,
                          device="cpu", scale=scale,
                          before_window=plant(fault) if fault else None)
    print(json.dumps({"result": out["result"], "found": out["found"],
                      "child_modules": out["child_modules"],
                      "modules": sorted({m.split(".")[0] for m in sys.modules})}))
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    os._exit(code)
