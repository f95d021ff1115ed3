"""The comparison that decides `correct` has been shown to fail: the
float32 control (the reference in the program's place) and faults
planted under the timed path both come out not correct. At SF0.01 on
the CPU; benchmark/control.py reads the control at the cells' own size."""

import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT
from harness import spec

sys.path.insert(0, BENCH)
import control  # noqa: E402

SEEDS = (3, 2 ** 31 + 7, 4_000_000_001)
CELL_SCRIPT = os.path.join(BENCH, "tests", "cpu_cell.py")


def cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.parametrize("name", cells())
@pytest.mark.parametrize("seed", SEEDS)
def test_the_float32_control_is_not_correct(name, seed):
    r = control.readings(spec.Benchmark(ROOT).cell(name), seed, scale=0.01)
    assert not r["correct"]
    assert r["wrong"] >= 1


def test_the_control_fails_the_average_gap_on_its_own():
    """avg_gap separates too: the control's averages alone exceed its
    limit (at SF0.05; SF0.01's 60,000 lines give float32 sums too few
    roundings to read clearly)."""
    from harness import check

    # the scan mix's Q1 has the averages; no cell of BENCHMARK.json runs it yet
    scan = spec.Cell("tpch_sf1_single.scan_reports", "tpch_sf1_single", "scan_reports", 1,
                     spec.config("tpch_sf1_single"), spec.traffic("scan_reports"))
    for seed in SEEDS:
        r = control.readings(scan, seed, scale=0.05)
        assert r["avg_gap"] > check.AVG_GAP_LIMIT


@pytest.mark.parametrize("fault", ["altered", "half"])
@pytest.mark.parametrize("name", cells())
def test_a_fault_under_the_timed_path_is_not_correct(name, fault):
    p = subprocess.run([sys.executable, CELL_SCRIPT, name, "11", "2", "0.01", fault],
                       capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    res = json.loads(p.stdout.strip().splitlines()[-1])["result"]
    assert res["correct"] is False
    assert res["checks"]["wrong"]["value"] >= 1
