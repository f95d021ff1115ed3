"""The port's built-program cache (tidb_tpu_torch/utils/jitcache.py) on
the CPU: the reference's API and LRU bound. The executors' four fused
sites go through it (one CUDA graph per signature on the card, eager
here): a repeated statement finds its entries and adds none, answering
the same, and each string literal answers its own. The graph path itself
is tested in tests/test_torch_fused_programs.py (CPU) and
tests/test_torch_cuda.py (the card).
"""

import threading

import numpy as np
import pytest

from tidb_tpu_torch.session import Session
from tidb_tpu_torch.utils import jitcache


@pytest.fixture(autouse=True)
def empty_cache():
    jitcache.clear()
    yield
    jitcache.clear()


class TestCache:
    def test_builds_once_per_key(self):
        calls = []

        def build():
            calls.append(1)
            return lambda x: x + 1

        f = jitcache.cached_jit("ns", "k", build)
        g = jitcache.cached_jit("ns", "k", build)
        assert f is g and f(1) == 2 and len(calls) == 1
        jitcache.cached_jit("other", "k", build)  # the namespace is part of the key
        assert len(calls) == 2 and jitcache.size() == 2

    def test_lru_bound_evicts_the_oldest(self, monkeypatch):
        monkeypatch.setattr(jitcache, "MAX_ENTRIES", 3)
        for i in range(3):
            jitcache.cached_jit("ns", str(i), lambda i=i: i)
        jitcache.cached_jit("ns", "0", lambda: -1)  # touch 0: 1 is now oldest
        jitcache.cached_jit("ns", "3", lambda: 3)
        assert jitcache.size() == 3
        assert jitcache.cached_jit("ns", "0", lambda: -1).fn == 0  # kept
        assert jitcache.cached_jit("ns", "1", lambda: -1).fn == -1  # rebuilt
        assert jitcache.MAX_ENTRIES == 3

    def test_reference_bound(self):
        from tidb_tpu.utils import jitcache as ref

        assert jitcache.MAX_ENTRIES == ref.MAX_ENTRIES == 512

    def test_concurrent_lookups_agree(self):
        got, barrier = [], threading.Barrier(8)

        def worker():
            barrier.wait(30)
            for i in range(200):
                got.append(jitcache.cached_jit("ns", str(i % 16), lambda i=i: i % 16))

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert jitcache.size() == 16 and len(got) == 1600


def _session():
    s = Session(device="cpu", chunk_capacity=1024)
    s.execute("create table t (a bigint, b varchar(8), c bigint)")
    t = s.catalog.table("test", "t")
    rng = np.random.default_rng(3)
    n = 5000
    t.insert_columns({"a": np.arange(n, dtype=np.int64),
                      "c": rng.integers(0, 100, n).astype(np.int64)},
                     strings={"b": [f"s{i % 7}" for i in range(n)]})
    s.execute("create table d (k bigint primary key, w bigint)")
    s.execute("insert into d values " + ",".join(f"({i},{i * 2})" for i in range(100)))
    return s


QUERIES = [
    "select b, count(*), sum(c) from t where a > 10 group by b order by b",
    "select a, b, c from t where b <> 's3' order by c desc, a limit 5",
    "select sum(t.c + d.w) from t join d on t.c = d.k where t.b <> 's1'",
    "select a * 2 as x from t where c < 3 order by x limit 4",
]


class TestExecutorsBuildPerOpen:
    @pytest.mark.parametrize("sql", QUERIES)
    def test_repeated_statement_caches_nothing(self, sql):
        """Nothing new: the second run finds the first run's entries."""
        s = _session()
        first = s.query(sql)
        assert first
        n = jitcache.size()
        assert s.query(sql) == first
        assert jitcache.size() == n

    def test_each_literal_answers_its_own(self):
        """The literal's dictionary code is baked into the scan's
        program, which is built anew for every statement."""
        s = _session()
        sql = "select a, b = '{}' as m from t where a < 20"
        a = s.query(sql.format("s3"))
        b = s.query(sql.format("s4"))
        assert [m for _a, m in a] == [int(i % 7 == 3) for i in range(20)]
        assert [m for _a, m in b] == [int(i % 7 == 4) for i in range(20)]
        assert s.query(sql.format("s3")) == a
        assert jitcache.size() == 0
