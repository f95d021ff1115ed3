"""`python -m tidb_tpu_torch.ops.bench_segsum` on the CPU: with
`--device cpu` it times the plain versions and writes its JSON with every
exactness flag true; without a card and without `--device cpu` it
refuses (its numbers are the card's or none)."""

import json
import subprocess
import sys

import pytest
import torch

from tidb_tpu_torch.ops import bench_segsum


def test_cpu_run_writes_exact_results(tmp_path):
    out = tmp_path / "bench.json"
    assert bench_segsum.main(["--device", "cpu", "--rows", "4096", "--reps", "2",
                              "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert res["rows"] == 4096 and res["route"] == "plain"
    assert res["device"]["platform"] == "cpu" and res["all_exact"]
    assert [c["G"] for c in res["configs"]] == list(bench_segsum.GROUPS)
    for c in res["configs"]:
        assert c["count_exact"] and c["i64_exact"] and c["index_add_i64_exact"]
        assert c["sum_f32_ok"] and c["sum_rel_err"] <= res["f32_rel_tol"]
        for k in ("count_ms", "count_index_add_ms", "sum_f32_ms", "sum_f32_index_add_ms",
                  "i64_ms", "i64_index_add_ms"):
            assert c[k] > 0, k


def test_module_entry_point(tmp_path):
    out = tmp_path / "b.json"
    proc = subprocess.run([sys.executable, "-m", "tidb_tpu_torch.ops.bench_segsum",
                           "--device", "cpu", "--rows", "1024", "--reps", "1",
                           "--out", str(out)], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(out.read_text())["all_exact"]
    assert sum(1 for ln in proc.stdout.splitlines() if ln.startswith('{"G"')) == 3


def test_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        bench_segsum.main(["--rows", "1024", "--out", str(tmp_path / "x.json")])
