"""Per-statement dispatch accounting under concurrency (utils/dispatch.py).

The server runs statements on concurrent worker threads, so each
statement's `dispatches` and `xfer_bytes` (EXPLAIN ANALYZE, the
statements summary, the slow log) must count its own thread's work only,
as the reference's per-thread counters do. On the CPU no kernel launches
and nothing is staged to a card, so these tests drive the counters
themselves: the wrappers' launch counting (`dispatch.count_launch`) and
`record_xfer`, from two threads at once. Staging done for a statement by
a helper thread (the pipeline's prefetch thread) is charged to the
statement's account. The card-side test, statements in flight together
with their launches equal to solo runs, is in tests/test_torch_cuda.py."""

import threading

import torch

from tidb_tpu_torch.ops import hash_probe, segment_sum
from tidb_tpu_torch.utils import dispatch

torch.set_num_threads(1)


def _snapshot():
    return dispatch.count(), dispatch.by_site(), dispatch.xfer_bytes()


def test_one_threads_counts_never_show_in_anothers():
    staged, go_launch, launched, done = (threading.Event() for _ in range(4))
    seen = {}

    def worker():
        dispatch.record_xfer(4096)
        staged.set()
        go_launch.wait(10)
        for _ in range(3):
            dispatch.count_launch(segment_sum.LAUNCHES, "segagg")
        dispatch.count_launch(hash_probe.LAUNCHES, "probe_count")
        seen["worker"] = _snapshot()
        launched.set()
        done.wait(10)

    x0 = dispatch.xfer_bytes()
    t = threading.Thread(target=worker)
    t.start()
    try:
        assert staged.wait(10)
        # the other thread's staged bytes are not this thread's
        assert dispatch.xfer_bytes() == x0
        before = _snapshot()
        totals = (dict(segment_sum.LAUNCHES), dict(hash_probe.LAUNCHES))
        go_launch.set()
        assert launched.wait(10)
        # ...nor are its kernel launches
        assert _snapshot() == before
    finally:
        go_launch.set()
        done.set()
        t.join(10)
    assert not t.is_alive()
    # the worker saw exactly its own work
    count, by_site, xfer = seen["worker"]
    assert count == 4 and xfer == 4096
    assert by_site == {"segagg": 3, "probe_count": 1}
    # the process totals (chip_smoke reads them) still count everything
    assert segment_sum.LAUNCHES["segagg"] == totals[0]["segagg"] + 3
    assert hash_probe.LAUNCHES["probe_count"] == totals[1]["probe_count"] + 1
    # ...and render as the reference's dispatch family
    from tidb_tpu_torch.utils.metrics import DISPATCH_TOTAL

    assert DISPATCH_TOTAL.value(site="segagg") == segment_sum.LAUNCHES["segagg"]
    assert (DISPATCH_TOTAL.value(site="probe_count")
            == hash_probe.LAUNCHES["probe_count"])


def test_helper_thread_charges_the_statements_account():
    """A prefetch thread staging for a statement charges the statement's
    thread (its Account), not itself."""
    acct = dispatch.account()
    x0 = dispatch.xfer_bytes()
    helper_own = {}

    def helper():
        dispatch.record_xfer(1 << 20, into=acct)
        helper_own["xfer"] = dispatch.xfer_bytes()

    t = threading.Thread(target=helper)
    t.start()
    t.join(10)
    assert dispatch.xfer_bytes() - x0 == 1 << 20
    assert helper_own["xfer"] == 0


def test_prefetcher_takes_its_statements_account():
    from tidb_tpu_torch.executor.base import ExecContext
    from tidb_tpu_torch.executor.pipeline import ChunkPrefetcher
    from tidb_tpu_torch.utils.memory import MemTracker

    ctx = ExecContext(mem_tracker=MemTracker("query"), prefetch_depth=0)
    pf = ChunkPrefetcher([], ctx)
    try:
        assert pf._account is dispatch.account()
    finally:
        pf.close()
