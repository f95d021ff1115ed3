"""The control of the comparison that decides `correct`: the plain
reference, computed in float32 (the precision below the configuration's
exact decimals and float64 averages) and put in the program's place.
Its rows go through the same judge as the program's; a sound comparison
finds them wrong. Not run by the benchmark's own runs.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 [--scale SF]

prints one JSON line per seed: the readings of every statement of the
cell's mix (all its parameter sets), as the check would read them.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seed: int, scale=None) -> dict:
    from harness import check, tpchgen, traffic

    plan = traffic.plan(cell, seed, rounds=1)
    tables = tpchgen.generate(float(scale or cell.config["scale_factor"]), seed)
    verdicts, why = [], {}
    for tag in plan.tags():
        q, i = traffic.untag(tag)
        mod, p = plan.queries[q].mod, plan.params[q][i]
        want, _ = mod.reference(tables, p, exact=True)
        low, _ = mod.reference(tables, p, exact=False)
        wrong, gap, reason = check.judge(check.as_wire(low, mod.COLUMNS), want,
                                         mod.COLUMNS, mod.ORDER_BY)
        verdicts.append((False, wrong, gap))
        why[tag] = reason
    out = check.readings(verdicts)
    has_floats = any("float" in q.mod.COLUMNS for q in plan.queries.values())
    out["correct"] = check.passes(out, check.compared(has_floats))
    out["why"] = why
    return out


def main(argv=None) -> int:
    from harness import spec

    ap = argparse.ArgumentParser(prog="benchmark/control.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--scale", type=float, default=None)
    args = ap.parse_args(argv)
    cell = spec.Benchmark().cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.monotonic()
        r = readings(cell, seed, args.scale)
        r.update(workload=args.workload, seed=seed, seconds=time.monotonic() - t)
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
