"""Port tests leave the reference's runtime sanitizer as they found it.

The reference's lock-order witness (tidb_tpu/analysis/sanitizer.py) is
sticky: the first sanitized statement turns it on for the process, and
it records the tracked-lock orders of every later statement, from every
thread, into one graph. `tests/test_write_path.py::TestCompactionChaos::
test_sanitized_compaction_run_is_clean` fails on any cycle in that graph.
In one xdist worker, `tests/test_plan_feedback.py`'s sanitized test
turned the witness on; then a port test's locking read through a
reference session recorded Catalog.lock -> Catalog.readers, and a port
test's TPC-H Q18 through a reference session Catalog.readers ->
Catalog.lock: a cycle that was none of the compaction test's doing.
Every port test that imports the reference now runs with the witness off
(`test_torch_session.reference_witness_off`, an autouse fixture).
"""

import os
import subprocess
import sys

from tidb_tpu.analysis import sanitizer as san
from tidb_tpu.session import Session as JaxSession
from test_torch_session import reference_witness_off, reference_witness_paused  # noqa: F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the order of the xdist worker where the compaction test failed, cut to
# the four tests that made the cycle and read it
_SEQUENCE = [
    "tests/test_plan_feedback.py::TestEndToEndSurfaces::"
    "test_concurrent_statements_under_sanitizer",
    "tests/test_torch_plan_cache.py::test_hits_and_misses_match_reference[locking_read]",
    "tests/test_torch_join_fused.py::test_tpch_fused_unfused_and_jax_agree[q18]",
    "tests/test_write_path.py::TestCompactionChaos::test_sanitized_compaction_run_is_clean",
]


def test_sanitized_compaction_test_passes_after_port_tests():
    """The worker's sequence in one process: every test passes."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:xdist", "-p", "no:randomly", *_SEQUENCE],
        cwd=_REPO, env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-4000:] + r.stderr[-2000:]
    assert "4 passed" in r.stdout


def test_witness_off_records_nothing_and_comes_back_on():
    """With the witness on when the block starts: off inside it (a
    reference locking read and a join record no lock order), on after it
    with the graph as it was."""
    san.enable()
    try:
        before = san.lock_edges()
        with reference_witness_off():
            assert not san.enabled()
            js = JaxSession()
            js.execute("set tidb_tpu_compaction = 0")
            js.execute("create table w (a bigint primary key, b bigint)")
            js.execute("insert into w values (1, 2), (3, 4)")
            js.execute("begin")
            assert js.query("select b from w where a = 1 for update") == [(2,)]
            js.execute("commit")
            assert js.query("select count(*) from w x join w y on x.a = y.a") == [(2,)]
        assert san.enabled()
        assert san.lock_edges() == before
        assert san.check_lock_cycle() is None
    finally:
        san.disable(reset_state=False)  # the autouse fixture restores the rest


def test_witness_off_leaves_an_off_witness_off():
    assert not san.enabled()  # the autouse fixture turned it off
    with reference_witness_off():
        assert not san.enabled()
    assert not san.enabled()
