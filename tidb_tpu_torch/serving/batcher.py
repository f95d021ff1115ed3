"""Cross-session micro-batching (a copy of tidb_tpu/serving/batcher.py).

The OLTP hot case of the plan cache — plan-cache-hit statements
differing only in bound parameters — is exactly the shape inference
servers coalesce: many same-shaped requests, one batched entry. Here,
concurrent prepared point-selects whose plan-cache keys match (same
digest + param-type fingerprint + planner sysvars) gather for a short
window (``tidb_tpu_batch_window_us``) and execute as ONE pass:

  1. per member: the O(log n) unique-index probe resolves its key to
     visible row ids (the members' params, stacked along the batch axis,
     drive N probes against one shared index cache);
  2. one gather over the UNION of every member's rows builds one chunk;
  3. the (parameter-free, shared) projection pipeline runs ONCE, on
     CPU tensors (host work, as in the reference);
  4. one host materialization, then a positional split hands each
     member exactly the rows its singleton execution would have built.

Per-statement semantics stay exact because each member still passes
through ``Session._execute_timed`` — with the executor swapped for a
runner returning its pre-demuxed slice — so warnings reset, deadlines,
KILL, tracing (``sched.batch[n=N]`` spans), the statements summary and
the slow log all behave as if the statement ran alone. A member killed
or expired while gathering leaves the batch with its typed error; the
batch itself is never aborted. Any failure of the shared pass falls
back to full singleton execution for every member — a correctness
gate, not best-effort.
"""

from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, List, Optional

__all__ = ["Batcher", "BatchGroup", "Member"]


class _DmlFallback(Exception):
    """Raised inside a group-commit pass to abort the (not yet
    committed) group transaction and send every member to singleton
    execution — the same correctness gate the read batcher's
    shared-pass fallback provides."""


class Member:
    """One admitted, coalescible statement waiting for its result."""

    __slots__ = ("session", "stmt_id", "params", "info", "t0", "deadline",
                 "group", "done", "result", "exc", "timed_out", "drop",
                 "sql")

    def __init__(self, session, stmt_id: int, params: list, info,
                 deadline: Optional[float], sql: Optional[str] = None):
        self.session = session
        self.stmt_id = stmt_id
        self.params = params
        self.info = info                  # StmtInfo / DML spec from the probe
        self.sql = sql                    # text-protocol member (DML window)
        self.t0 = time.perf_counter()     # for the sched.queue span
        self.deadline = deadline          # monotonic; None = unbounded
        self.group: Optional["BatchGroup"] = None
        self.done = threading.Event()
        self.result = None
        self.exc: Optional[BaseException] = None
        self.timed_out = False
        # typed error captured at finalize time for a member killed or
        # deadline-expired during the gather (raised by its runner so
        # the statement still flows through _execute_timed's error path)
        self.drop: Optional[BaseException] = None

    def finish(self, result=None, exc: Optional[BaseException] = None):
        self.result = result
        self.exc = exc
        self.done.set()


class BatchGroup:
    """Members sharing one plan-cache key, gathering toward one
    dispatch. ``cv`` guards the fill signal and wakes the gathering
    worker early when the group fills; the gather wait holds NO other
    lock (the lock-discipline pass enforces this for serving/)."""

    def __init__(self, key, entry, window_s: float, max_size: int):
        self.key = key
        self.entry = entry
        self.window_s = window_s
        self.max_size = max_size
        self.created = time.monotonic()
        from tidb_tpu_torch.analysis import sanitizer as _san

        self.cv = threading.Condition(
            _san.tracked_lock("BatchGroup.cv", threading.RLock))
        self.members: List[Member] = []
        self.sealed = False
        # group-commit DML window: the opening member's spec
        # (shape fields — kind/table/SET columns — are digest-identical
        # across members); None = a read batch
        self.dml = None


class Batcher:
    def __init__(self, scheduler):
        from tidb_tpu_torch.analysis import sanitizer as _san

        self.scheduler = scheduler
        self._lock = _san.tracked_lock("Batcher._lock")
        self._open: Dict[object, BatchGroup] = {}
        self._seq = itertools.count(1)
        # per-digest coalesce counts for information_schema.scheduler_stats
        self._coalesced_by_digest: Dict[str, int] = {}
        self.batches = 0            # groups executed (any size)
        self.coalesced_stmts = 0    # members of n>=2 groups
        # internal session owning group-commit DML transactions (lazy:
        # read-only deployments never create it)
        self._writer = None

    # -- submit side ----------------------------------------------------

    def try_join(self, session, stmt_id: int, params: list,
                 deadline: Optional[float]) -> Optional[Member]:
        """Coalesce this prepared execution into an open group (or open
        a group and enqueue its gather task). None = not coalescible;
        the caller runs the singleton path."""
        sched = self.scheduler
        window_us = int(sched.sysvars.get("tidb_tpu_batch_window_us"))
        if window_us <= 0:
            return None
        probe = session.batch_probe(stmt_id, params)
        if probe is None:
            return None
        key, entry, info = probe
        member = Member(session, stmt_id, params, info, deadline)
        return self._join(key, member, window_us, entry=entry)

    def try_join_dml(self, session, sql: str,
                     deadline: Optional[float]) -> Optional[Member]:
        """Coalesce an autocommit text-protocol point write into an
        open group-commit window. Same gather/seal machinery
        as reads — the keys carry a "dml" marker so a write window can
        never mix with a read batch. None = not coalescible."""
        sched = self.scheduler
        window_us = int(sched.sysvars.get("tidb_tpu_batch_window_us"))
        if window_us <= 0:
            return None
        probe = session.dml_batch_probe(sql)
        if probe is None:
            return None
        key, spec = probe
        member = Member(session, -1, [], spec, deadline, sql=sql)
        return self._join(key, member, window_us, dml=spec)

    def _join(self, key, member: Member, window_us: int, entry=None,
              dml=None) -> Member:
        """Append `member` to the open group for `key`, or open a fresh
        group and enqueue its gather task."""
        sched = self.scheduler
        max_size = int(sched.sysvars.get("tidb_tpu_max_batch_size"))
        with self._lock:
            g = self._open.get(key)
            if g is not None and not g.sealed and len(g.members) < max_size:
                g.members.append(member)
                member.group = g
                full = len(g.members) >= max_size
                enqueue = False
            else:
                g = BatchGroup(key, entry, window_us / 1e6, max_size)
                g.dml = dml
                g.members.append(member)
                member.group = g
                self._open[key] = g
                enqueue = True
                full = max_size <= 1
        if enqueue:
            sched.enqueue_group(g)
        if full:
            with g.cv:
                g.cv.notify_all()
        return member

    def try_evict(self, member: Member) -> bool:
        """Queue-timeout eviction: remove `member` from a still-open
        group. False once the group sealed — execution owns it now and
        the caller must keep waiting for the result."""
        with self._lock:
            g = member.group
            if g is None or g.sealed:
                return False
            try:
                g.members.remove(member)
            except ValueError:
                return False
            member.timed_out = True
            return True

    def seal_for_shutdown(self, group: BatchGroup) -> List[Member]:
        """Scheduler shutdown(drain=False): seal `group` without
        executing it and hand back its members for typed rejection.
        Same seal sequence as run_group so `_open` never retains a
        sealed group."""
        with self._lock:
            group.sealed = True
            if self._open.get(group.key) is group:
                del self._open[group.key]
            return list(group.members)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "open_groups": len(self._open),
                "batches": self.batches,
                "coalesced_stmts": self.coalesced_stmts,
                "coalesce_by_digest": dict(self._coalesced_by_digest),
            }

    # -- worker side ----------------------------------------------------

    def run_group(self, group: BatchGroup) -> None:
        """Gather (lock-free wait), seal, execute, demux."""
        deadline = group.created + group.window_s
        # adaptive seal: submitters arrive as a wave (each blocked
        # client re-submits right after its previous result); once no
        # member has joined for a fraction of the window, the wave has
        # landed and waiting out the rest is pure latency
        idle_gap = max(group.window_s / 4.0, 100e-6)
        with group.cv:
            while len(group.members) < group.max_size:
                rem = deadline - time.monotonic()
                if rem <= 0:
                    break
                n0 = len(group.members)
                group.cv.wait(min(rem, idle_gap))
                if group.members and len(group.members) == n0:
                    break  # no growth for idle_gap
        with self._lock:
            group.sealed = True
            if self._open.get(group.key) is group:
                del self._open[group.key]
            members = list(group.members)
        self.scheduler.on_group_sealed(group, len(members))
        if not members:
            return  # every member timed out of the queue while gathering
        from tidb_tpu_torch.utils import metrics as M

        n = len(members)
        if group.dml is not None:
            M.DML_BATCH_SIZE.observe(n)
        else:
            M.BATCH_SIZE.observe(n)
        with self._lock:
            self.batches += 1
            if n >= 2:
                self.coalesced_stmts += n
                d = self._coalesced_by_digest
                d[group.key[0]] = d.get(group.key[0], 0) + n
                if len(d) > 256:
                    d.pop(next(iter(d)))
        if n >= 2:
            M.BATCH_COALESCE_TOTAL.inc(n)
        if group.dml is not None:
            self._execute_dml(group, members)
        else:
            self._execute(group, members)

    # -- the one gathered dispatch --------------------------------------

    def _execute(self, group: BatchGroup, members: List[Member]) -> None:
        """One device pass for every member, then per-member
        finalization through Session._execute_timed. The whole batch
        shares one catalog-lock acquisition (all members read the same
        committed snapshot — commits serialize on that lock), one plan
        instantiation shape and one executor pipeline."""
        catalog = self.scheduler.catalog
        batch_id = next(self._seq)
        with catalog.lock:
            try:
                shared = self._shared_pass(group, members)
            except Exception:  # noqa: BLE001 — ANY shared-pass failure
                # falls back to full-fidelity singleton execution: the
                # batch is an optimization, never a correctness risk
                shared = None
            n = len(members)
            for i, m in enumerate(members):
                runner = (None if shared is None
                          else self._member_runner(shared, i, n, batch_id, m))
                self._finalize(m, runner)

    def _shared_pass(self, group: BatchGroup, members: List[Member]):
        """The stacked-params pass. Returns a dict consumed by
        _member_runner, or None when the cached entry no longer
        validates (DDL/ANALYZE raced the gather window) — the members
        then re-plan individually through the normal path."""
        import numpy as np
        import torch

        from tidb_tpu_torch.chunk.chunk import Chunk
        from tidb_tpu_torch.chunk.column import Column
        from tidb_tpu_torch.executor.builder import peel_stages
        from tidb_tpu_torch.executor.scan import make_pipeline_fn
        from tidb_tpu_torch.planner import plancache as _pc
        from tidb_tpu_torch.planner.physical import PProjection

        catalog = self.scheduler.catalog
        cache = getattr(catalog, "plan_cache", None)
        if cache is None:
            return None
        # re-validate under the catalog lock: stale pinned tables must
        # never serve the batch (schema_version / stats identity checks
        # run inside lookup, exactly as a singleton probe would)
        entry = cache.lookup(group.key, catalog.schema_version)
        if entry is not group.entry or entry is None or entry.patches is None:
            return None
        if catalog.has_stale_txns():
            catalog.resolve_locks()  # reader-side resolve, like _execute_timed
        leader = _pc.instantiate(entry, members[0].info.params)

        def point_node(plan):
            node = plan
            while isinstance(node, PProjection):
                node = node.children[0]
            return node

        pg0 = point_node(leader)
        table, index_name = pg0.table, pg0.index_name
        row_sets = []
        for m in members:
            pg = pg0 if m is members[0] else point_node(
                _pc.instantiate(entry, m.info.params))
            row_sets.append(np.asarray(
                table.index_lookup(index_name, pg.key_values),
                dtype=np.int64))
        counts = [len(r) for r in row_sets]
        offsets = [0]
        for c in counts:
            offsets.append(offsets[-1] + c)
        total = offsets[-1]
        all_ids = (np.concatenate(row_sets) if total
                   else np.zeros(0, dtype=np.int64))
        cap = 8
        while cap < total:
            cap *= 2
        cols = {}
        row_bytes = 0
        for c in pg0.schema:  # storage columns of the point access
            if c.name == "__rowid__":
                d = all_ids
                v = np.ones(total, dtype=np.bool_)
            else:
                d = table.data[c.name][all_ids]
                v = table.valid[c.name][all_ids]
            row_bytes += int(getattr(d, "itemsize", 8)) + 1
            # host work, as in the reference (its host_eager() pass): a
            # point-select's few rows are gathered on the CPU, never
            # staged to the card
            cols[c.uid] = Column.from_numpy(d, c.type_, valid=v, capacity=cap,
                                            device="cpu")
        sel = torch.zeros(cap, dtype=torch.bool)
        sel[:total] = True
        chunk = Chunk(cols, sel)
        # batchable_plan guarantees the peeled stages are projections
        # only (parameter-free, 1:1 on rows), so ONE eager pipeline run
        # serves every member and the positional split below is exact
        stages, _base = peel_stages(leader)
        if stages:
            chunk = make_pipeline_fn(stages)(chunk)
        n_vis = leader.n_visible if isinstance(leader, PProjection) else None
        schema = leader.schema
        visible = schema if n_vis is None else schema[:n_vis]
        dicts = {c.uid: c.dict_ for c in visible if c.dict_ is not None}
        rows_all = chunk.to_pylist(dicts=dicts,
                                   names=[c.uid for c in visible])
        return {
            "entry": entry,
            "phys": leader,
            "rows": rows_all,
            "offsets": offsets,
            "row_bytes": row_bytes,
            "names": [c.name for c in visible],
            "types": [c.type_.kind for c in visible],
            "sql_types": [c.type_ for c in visible],
            "collations": [getattr(c.dict_, "collation", None)
                           for c in visible],
        }

    def _member_runner(self, shared: dict, i: int, n: int, batch_id: int,
                       member: Member):
        """The injected _stmt_runner for member `i`: raises the typed
        drop error for a killed/expired member, else books the cache
        hit + memory charge + sched.batch span and returns the member's
        pre-demuxed ResultSet."""
        entry = shared["entry"]
        lo, hi = shared["offsets"][i], shared["offsets"][i + 1]
        rows = shared["rows"][lo:hi]
        est = int(shared["row_bytes"]) * (hi - lo)
        sess = member.session

        def run(_stmt):
            if member.drop is not None:
                raise member.drop
            from tidb_tpu_torch.executor.base import ResultSet
            from tidb_tpu_torch.utils import tracing

            with tracing.span(f"sched.batch[n={n}]"):
                tracing.annotate(f"batch:{batch_id} member:{i} "
                                 f"rows:{len(rows)}")
                ctx = sess._exec_ctx(plan=shared["phys"])
                if est:
                    # per-member accounting: propagates into the
                    # session/server trackers; a quota breach cancels
                    # THIS member only (typed OOM), never the batch.
                    # lifecycle: the statement tracker owns the charge —
                    # Session._execute_timed detach()es it (residuals
                    # included) at this member's statement end
                    ctx.mem_tracker.consume(est)
                cache = sess.catalog.plan_cache
                cache.note_hit(entry)
                sess.sysvars.set("last_plan_from_cache", True, "session")
                sess._plan_from_cache_stmt = True
                if not entry.plan_digest:
                    import hashlib as _hl

                    from tidb_tpu_torch.planner.physical import explain_text

                    entry.plan_digest = _hl.sha256(
                        explain_text(entry.phys).encode()).hexdigest()[:32]
                sess._last_plan_digest = entry.plan_digest
                return ResultSet(names=shared["names"], rows=rows,
                                 types=shared["types"],
                                 sql_types=shared["sql_types"],
                                 collations=shared["collations"])

        return run

    def _finalize(self, member: Member, runner) -> None:
        """Run one member through Session._execute_timed on this worker
        thread (the member's connection thread is parked on its done
        event). runner=None re-executes the statement singleton-style —
        the shared-pass fallback."""
        import time as _time

        from tidb_tpu_torch.errors import QueryKilledError, QueryTimeoutError

        sess = member.session
        # kill/deadline observed during the gather: the member leaves
        # the batch with its typed error. Captured HERE because
        # _execute_timed consumes the one-shot kill flag at entry.
        if sess._kill_query:
            member.drop = QueryKilledError(
                "Query execution was interrupted (KILL)")
        elif member.deadline is not None and \
                _time.monotonic() > member.deadline:
            member.drop = QueryTimeoutError(
                "Query execution was interrupted, maximum statement "
                "execution time exceeded")
        if member.drop is not None and runner is None:
            def runner(_stmt):  # noqa: F811 — fallback member, same drop
                raise member.drop
        sess._stmt_runner = runner
        sess._sched_queue_s = _time.perf_counter() - member.t0
        try:
            if member.sql is not None:
                res = sess.execute(member.sql)
            else:
                res = sess.execute_prepared(member.stmt_id, member.params)
        except BaseException as e:  # noqa: BLE001 — relayed verbatim to
            member.finish(exc=e)    # the submitting connection thread
        else:
            member.finish(result=res)
        finally:
            sess._stmt_runner = None
            sess._sched_queue_s = 0.0

    # -- group-commit DML ------------------------------------

    def _dml_writer(self):
        """The internal session owning group-commit transactions. Not a
        client connection: removed from the process list so KILL can
        never target the shared writer."""
        if self._writer is None:
            from tidb_tpu_torch.session.session import Session

            w = Session(self.scheduler.catalog,
                        device=self.scheduler.device)
            w.catalog.processes.pop(w.conn_id, None)
            self._writer = w
        return self._writer

    def _execute_dml(self, group: BatchGroup, members: List[Member]) -> None:
        """One engine pass for every live member's point write — one
        merged insert/update/delete inside ONE writer transaction —
        then per-member finalization through Session._execute_timed.
        Any failure of the merged pass rolls the group transaction back
        (``_run_dml`` aborts implicit txns on any exception) and every
        member re-executes singleton-style with its exact typed error."""
        catalog = self.scheduler.catalog
        batch_id = next(self._seq)
        with catalog.lock:
            try:
                included = self._dml_pass(group, members)
            except Exception:  # noqa: BLE001 — ANY group-commit failure
                # (conflict shapes, schema race, engine error) aborted
                # the group txn; singleton re-execution is exact
                included = None
            n = len(members)
            for i, m in enumerate(members):
                runner = (self._dml_runner(i, n, batch_id, m)
                          if included is not None and included[i] else None)
                self._finalize(m, runner)

    def _dml_pass(self, group: BatchGroup,
                  members: List[Member]) -> List[bool]:
        """The merged write. Runs under catalog.lock in the writer
        session's own (implicit, autocommit) transaction: one index
        probe stack, one delta append / MVCC marker write, one commit.
        Returns the per-member inclusion mask — members killed or
        expired before the pass are excluded and get their typed error
        from _finalize without having written anything."""
        import time as _time

        import numpy as np

        catalog = self.scheduler.catalog
        # drop snapshot at T1: the kill flag is only consumed at
        # statement entry and deadlines are monotone, so _finalize's
        # re-check re-derives the same typed error for excluded members
        included = []
        now = _time.monotonic()
        for m in members:
            sess = m.session
            dead = m.deadline is not None and now > m.deadline
            included.append(not (sess._kill_query or sess._killed or dead))
        live = [m for m, ok in zip(members, included) if ok]
        if not live:
            return included
        if catalog.schema_version != group.key[4]:
            raise _DmlFallback("schema changed during gather")
        spec0 = group.dml
        table = catalog.table(spec0["db"], spec0["table"])
        kind = spec0["kind"]
        writer = self._dml_writer()

        if kind == "insert":
            rows = []
            for m in live:
                rows.extend(m.info["rows"])

            def do(txn):
                table.insert_rows(rows, columns=spec0["columns"],
                                  begin_ts=txn.marker,
                                  log=txn.log_for(table))
        else:
            def probe(txn):
                sets_ids = []
                for m in live:
                    ids = np.asarray(table.index_lookup(
                        m.info["index"], m.info["key"],
                        read_ts=txn.read_ts, marker=txn.marker),
                        dtype=np.int64)
                    sets_ids.append(ids)
                return sets_ids

            if kind == "update":
                def do(txn):
                    sets_ids = probe(txn)
                    all_ids = (np.concatenate(sets_ids) if sets_ids
                               else np.zeros(0, dtype=np.int64))
                    if len(all_ids) == 0:
                        return
                    if len(np.unique(all_ids)) != len(all_ids):
                        # two members hit the same row: serial order
                        # matters (k+2 vs k+1) — group cannot be exact
                        raise _DmlFallback("duplicate target rows")
                    updates = {name: [] for name, _, _ in live[0].info["sets"]}
                    for m, ids in zip(live, sets_ids):
                        k = len(ids)
                        for name, mode, val in m.info["sets"]:
                            if mode == "const":
                                updates[name].extend([val] * k)
                            else:  # delta: col ± literal on OLD values
                                src, op, delta = val
                                d = table.data[src][ids].tolist()
                                v = table.valid[src][ids].tolist()
                                for dv, ok in zip(d, v):
                                    if not ok:
                                        updates[name].append(None)
                                    elif op == "+":
                                        updates[name].append(dv + delta)
                                    else:
                                        updates[name].append(dv - delta)
                    table.update_rows(all_ids.tolist(), updates,
                                      begin_ts=txn.marker,
                                      end_ts=txn.marker, marker=txn.marker,
                                      log=txn.log_for(table),
                                      log_for=txn.log_for)
            else:  # delete — dup ids dedup to ONE marker, serial-exact
                def do(txn):
                    sets_ids = probe(txn)
                    all_ids = (np.concatenate(sets_ids) if sets_ids
                               else np.zeros(0, dtype=np.int64))
                    if len(all_ids) == 0:
                        return
                    all_ids = np.unique(all_ids)
                    table.delete_rows(all_ids.tolist(), end_ts=txn.marker,
                                      marker=txn.marker,
                                      log=txn.log_for(table),
                                      log_for=txn.log_for)

        writer._run_dml(do)
        return included

    def _dml_runner(self, i: int, n: int, batch_id: int, member: Member):
        """The injected _stmt_runner for an applied group-commit member:
        its write already committed in the merged pass, so the runner
        only books the batch span (DML returns no rows in this engine)."""

        def run(_stmt):
            if member.drop is not None:
                raise member.drop
            from tidb_tpu_torch.utils import tracing

            with tracing.span(f"sched.batch[n={n}]"):
                tracing.annotate(f"batch:{batch_id} member:{i} dml:applied")
                return None

        return run
