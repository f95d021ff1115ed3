"""HashJoinExec (ref: executor/join.go — build + probe workers).

Counterpart of the device tier of tidb_tpu/executor/join.py. The build
side becomes a sorted key tensor plus its payload on ctx.device, and each
probe chunk runs through ops/join_kernels.py:

    probe_count:  key pack -> range lookup -> match count -> prefix sum
                  (on the card one tidb_probe_count launch after the pack)
    expand_tiles: [T, C] fixed-capacity output tiles per call

The range lookup takes, in order of preference: the direct-address index
when the packed build keys form a dense domain; the open-addressing table
(ops/hash_probe.py) when tidb_tpu_join_probe_mode resolves to it; else
searchsorted.

The build drains its child on the device, packs and sorts there
(`_stage_device_build`), or, with tidb_tpu_join_device_build = 0, sorts
on the host and stages the sorted arrays (`_stage_host_sorted_build`).
The host syncs of a probe are the match totals, fetched once per window
of PROBE_SYNC_CHUNKS chunks (`_probe_finish_batch`), to size expansions.

Multi-key equi joins pack keys into one int64 using host-known ranges;
if the ranges overflow int64, packing switches to a 64-bit mixing hash
with exact re-verification of every expanded candidate (`_match_filter`).

Join kinds: inner, left (outer), semi, anti (NOT IN: any NULL build key
empties the result; NOT EXISTS keeps NULL-key probe rows).

The staged build's resident bytes are charged to the query's
`hashjoin.build` tracker until close(). An unfiltered inner join records
its summed match totals as its output rows for plan feedback.

IndexJoinExec is the index-lookup join the cascades memo plans: each
outer chunk's keys are binary-searched against the inner table's sorted
index on the host, and the visible matches are gathered from table
storage.

Not ported from the reference: the host-numpy tier (the port has one
engine, torch on ctx.device, which is its CPU path too). Cancellation is
polled where the reference polls it (between build and probe chunks).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from tidb_tpu_torch.chunk.chunk import Chunk
from tidb_tpu_torch.chunk.column import Column
from tidb_tpu_torch.executor.base import ExecContext, Executor, raise_if_cancelled
from tidb_tpu_torch.expression.compiler import compile_expr, compile_predicate, eval_expr
from tidb_tpu_torch.ops import hash_probe as hp
from tidb_tpu_torch.ops import join_kernels as jk
from tidb_tpu_torch.types import INT64
from tidb_tpu_torch.utils import dispatch
from tidb_tpu_torch.utils.device import torch_dtype

__all__ = ["HashJoinExec", "IndexJoinExec"]


def _pad(a: torch.Tensor, cap: int, fill=0) -> torch.Tensor:
    """Pad a tensor to a shape-bucket capacity."""
    n = a.shape[0]
    if n == cap:
        return a
    return torch.cat([a, torch.full((cap - n,), fill, dtype=a.dtype, device=a.device)])


def tile_row_bytes(p_datas, b_datas) -> int:
    """Device bytes of one expanded output row: each probe and build
    column's value and validity, and the row's selection flag."""
    return 1 + sum(d.element_size() + 1 for d in (*p_datas, *b_datas))


def _to_device(chunk: Chunk, dev: torch.device) -> Chunk:
    """A chunk of a host-side operator (an aggregate's few groups, a sort's
    output) moved to the join's device."""
    if chunk.device.type == dev.type:
        return chunk
    return Chunk({u: Column(c.data.to(dev), c.valid.to(dev), c.type_)
                  for u, c in chunk.columns.items()}, chunk.sel.to(dev))


class HashJoinExec(Executor):
    def __init__(self, schema, probe_child, build_child, kind: str,
                 probe_keys: List, build_keys: List, other_cond=None,
                 probe_schema=None, build_schema=None, exists_sem: bool = False):
        super().__init__(schema, [probe_child, build_child])
        self.kind = kind
        self.probe_keys = probe_keys
        self.build_keys = build_keys
        self.other_cond = other_cond
        self.probe_schema = probe_schema
        self.build_schema = build_schema
        self.exists_sem = exists_sem

    # ------------------------------------------------------------------

    def open(self, ctx: ExecContext) -> None:
        super().open(ctx)
        self.ctx = ctx
        self._pending: list = []
        self._drained = False
        self._filter_fn = None
        self._held = 0
        self._probe_tracker = None
        self._build()

    def _build(self):
        """Drain the build child, then stage the build side (the fused
        scan->probe executor runs the same two halves over a build child
        of its own, executor/pipeline.py)."""
        self._stage_build(*self._drain_build(self.children[1]))

    def _drain_build(self, child: Executor):
        """Drain `child` on the device, compacting key and payload columns
        to live rows: (key arrays, key-ok mask, {uid: (data, valid)})."""
        dev = self.ctx.device
        keys_ir = self.build_keys
        key_cols = [[] for _ in (keys_ir or [None])]
        key_ok = []
        payload: dict = {c.uid: ([], []) for c in (self.build_schema or [])}
        # the drained rows are charged as they arrive: a build that
        # outgrows the statement's quota fails typed before it fills the
        # card (_stage_build trades this charge for the staged bytes)
        self._drain_tracker = self.ctx.mem_tracker.child("hashjoin.drain")
        self._drain_bytes = 0
        for chunk in child.chunks():
            # KILL/deadline interrupts the build drain chunk by chunk
            raise_if_cancelled(self.ctx)
            chunk = _to_device(chunk, dev)
            if keys_ir:
                outs = [eval_expr(k, chunk) for k in keys_ir]
            else:  # keyless (cross) join: a constant key matches everything
                outs = [(torch.zeros(chunk.capacity, dtype=torch.int64, device=dev),
                         torch.ones(chunk.capacity, dtype=torch.bool, device=dev))]
            live = torch.nonzero(chunk.sel).squeeze(1)
            ok = torch.ones(live.shape[0], dtype=torch.bool, device=dev)
            for i, (d, v) in enumerate(outs):
                key_cols[i].append(d[live])
                ok = ok & v[live]
            key_ok.append(ok)
            for uid in payload:
                col = chunk.columns[uid]
                payload[uid][0].append(col.data[live])
                payload[uid][1].append(col.valid[live])
            n = live.shape[0] * (1 + sum(k[-1].element_size() for k in key_cols)
                                 + sum(d[-1].element_size() + 1
                                       for d, _v in payload.values()))
            self._drain_bytes += n
            self._drain_tracker.consume(n)

        def cat(parts, dtype):
            return (torch.cat(parts) if parts
                    else torch.zeros(0, dtype=dtype, device=dev))

        key_arrays = [cat(p, torch.int64) for p in key_cols]
        ok = cat(key_ok, torch.bool)
        self._payload_uids = list(payload)
        self._build_schema_by_uid = {c.uid: c for c in (self.build_schema or [])}
        payload_cols = {}
        for uid, (dlist, vlist) in payload.items():
            dt = torch_dtype(self._build_schema_by_uid[uid].type_.np_dtype)
            payload_cols[uid] = (cat(dlist, dt), cat(vlist, torch.bool))
        return key_arrays, ok, payload_cols

    def _stage_build(self, key_arrays, ok, payload_cols) -> None:
        """Pack + sort + gather the drained build on the device, or sort on
        the host (the join_device_build = 0 hatch), and index it."""
        # pack parameters (and the hash-mode decision) come from the VALID
        # keys only: a NULL slot's garbage value must not widen the range
        valid_keys = [k[ok] for k in key_arrays]
        self._build_had_null = bool(dispatch.device_get((~ok).any()))
        self._n_build = int(valid_keys[0].shape[0])
        self._pack_info = self._key_pack_info(valid_keys)
        self._has_filter = self.other_cond is not None or self._hash_mode
        self._set_probe_pack_params()
        if self.ctx.join_device_build or self._hash_mode:
            # hash mode always builds on the device: its packed keys are
            # made there
            nbytes = self._stage_device_build(key_arrays, ok, payload_cols)
        else:
            nbytes = self._stage_host_sorted_build(valid_keys, ok, payload_cols)
        # account the materialized build side against the query budget
        # (ref: HashJoinExec's build RowContainer under the memory tracker)
        self._mem_tracker = self.ctx.mem_tracker.child("hashjoin.build")
        self._build_bytes = int(nbytes)
        self._release_drain()
        self._mem_tracker.consume(self._build_bytes)

    def _release_drain(self) -> None:
        if getattr(self, "_drain_bytes", 0):
            self._drain_tracker.release(self._drain_bytes)
            self._drain_bytes = 0

    def close(self) -> None:
        for item in getattr(self, "_pending", ()):
            if not isinstance(item, Chunk):
                item.close()  # an expansion's finally returns its bytes
        self._pending = []
        self._release_drain()
        if getattr(self, "_held", 0):
            self._probe_tracker.release(self._held)
            self._held = 0
        if getattr(self, "_build_bytes", 0):
            self._mem_tracker.release(self._build_bytes)
            self._build_bytes = 0
        super().close()

    def _hold(self, nbytes: int) -> None:
        """Charge device bytes the probe holds (the tiles of a
        many-to-many expand call) to the statement's tracker; counted
        before the charge, so close() returns them on a QueryOOMError
        too."""
        if not nbytes:
            return
        if self._probe_tracker is None:
            self._probe_tracker = self.ctx.mem_tracker.child("hashjoin.probe")
        self._held += nbytes
        self._probe_tracker.consume(nbytes)

    def _unhold(self, nbytes: int) -> None:
        nbytes = min(nbytes, self._held)
        if nbytes > 0:
            self._held -= nbytes
            self._probe_tracker.release(nbytes)

    def _key_pack_info(self, key_arrays: List[torch.Tensor]):
        """Pack parameters per key. Sets self._hash_mode; returns
        [(mode, lo, stride, rng), ...] or [("hash", modes)] when the range
        product overflows int64. One host read of every key's min/max."""
        self._hash_mode = False
        modes = ["bits" if k.is_floating_point() else "int" for k in key_arrays]
        conv = [jk.as_int64_key(k, m) for k, m in zip(key_arrays, modes)]
        if len(key_arrays) == 1 and modes[0] != "int":
            return [(modes[0], 0, 1, 0)]
        n = conv[0].shape[0]
        if n:
            bounds = dispatch.device_get(
                torch.stack([torch.stack([k.min(), k.max()]) for k in conv])).tolist()
        else:
            bounds = [(0, 0)] * len(conv)
        if len(key_arrays) == 1:
            if not n:
                return [(modes[0], 0, 1, 0)]
            # lo/rng of the packed domain feed the direct-address index
            # decision (the probe packer ignores them for single keys)
            lo, hi = bounds[0]
            rng = hi - lo + 1
            if rng >= (1 << 63):
                # keys span (almost) the whole int64 domain: rng does not
                # fit int64; 0 is the "unknown range" marker
                rng = 0
            return [(modes[0], lo, 1, rng)]
        info = []
        stride = 1
        for (lo, hi), mode in zip(bounds, modes):
            rng = hi - lo + 1
            if rng <= 0 or rng * stride > (1 << 62):
                self._hash_mode = True
                return [("hash", tuple(modes))]
            info.append((mode, lo, stride, rng))
            stride *= rng
        return info

    # direct-address index ceilings: absolute (device memory for the
    # [rng + 1] prefix array) and relative to the build bucket (no giant
    # histogram for a tiny build over a sparse domain)
    DIRECT_ABS_LIMIT = 1 << 23
    DIRECT_REL_LIMIT = 32

    def _direct_domain(self, n_bucket: int):
        """(lo, rng) of the packed-key domain when the direct-address
        index pays off, else None. Dense build keys — the PK-FK common
        case — resolve probes in O(1) gathers."""
        if self._hash_mode or self._n_build == 0:
            return None
        info = self._pack_info
        if len(info) == 1:
            mode, lo, _stride, rng = info[0]
            if mode != "int" or rng <= 0:
                return None
        else:
            lo = 0
            rng = info[-1][2] * info[-1][3]  # product of per-key ranges
        if rng > min(self.DIRECT_ABS_LIMIT,
                     max(1 << 18, self.DIRECT_REL_LIMIT * n_bucket)):
            return None
        return lo, rng

    def _index_build(self, n_bucket: int) -> int:
        """The probe's index over the staged sorted keys: the direct-address
        index over a dense packed domain, else the open-addressing table
        when tidb_tpu_join_probe_mode resolves to it on this device (None
        for a build over capacity or with a run unplaced), else nothing
        (searchsorted). Returns the index's resident bytes."""
        dom = self._direct_domain(n_bucket)
        self._direct = dom is not None
        self._probe_table = None
        if self._direct:
            lo, rng = dom
            # the histogram length is bucketed as in the reference
            self._firsts = jk.build_direct_index(
                self._sorted_keys, self._n_build_dev, lo, jk.shape_bucket(rng, floor=64))
            self._direct_lo, self._direct_rng = lo, rng
            return self._firsts.nbytes
        self._firsts = torch.zeros(2, dtype=torch.int64, device=self.ctx.device)
        self._direct_lo = self._direct_rng = 0
        if hp.resolve_mode(self.ctx.join_probe_mode, self.ctx.device) == "table":
            self._probe_table = jk.build_hash_table(self._sorted_keys)
        nbytes = self._firsts.nbytes
        if self._probe_table is not None:
            nbytes += sum(a.nbytes for a in self._probe_table[:3])
        return nbytes

    def _set_probe_pack_params(self) -> None:
        """Pack parameters the probe packer takes, as Python ints."""
        info = self._pack_info
        if self._hash_mode:
            self._modes = tuple(info[0][1])
            self._los = self._strides = self._rngs = [0] * len(self._modes)
        else:
            self._modes = tuple(e[0] for e in info)
            self._los = [e[1] for e in info]
            self._strides = [e[2] for e in info]
            self._rngs = [e[3] for e in info]

    def _stage_host_sorted_build(self, valid_keys, ok, payload_cols) -> int:
        """tidb_tpu_join_device_build = 0: the build sorts on the host (one
        stable argsort of the packed keys) and the sorted keys go back to
        the device for the same probe programs. Answers as the device
        build does; only the sort's placement changes."""
        dev = self.ctx.device
        ones = torch.ones(self._n_build, dtype=torch.bool, device=dev)
        packed, _, _ = jk.pack_keys(valid_keys, (ones,) * len(valid_keys), self._los,
                                    self._strides, self._rngs, ones, self._modes, False)
        packed = dispatch.device_get(packed)
        order = np.argsort(packed, kind="stable")
        B = jk.shape_bucket(self._n_build)
        # padding keeps the array sorted: dead slots -> INT64_MAX
        self._sorted_keys = _pad(torch.from_numpy(packed[order]).to(dev), B, jk.I64_MAX)
        self._n_build_dev = torch.tensor(self._n_build, dtype=torch.int64, device=dev)
        live_idx = torch.nonzero(ok).squeeze(1)[torch.from_numpy(order).to(dev)]
        self._build_keyvals = ()  # hash mode never takes this path
        self._build_payload = {
            uid: (_pad(d[live_idx], B), _pad(v[live_idx], B, False))
            for uid, (d, v) in payload_cols.items()}
        return self._staged_nbytes() + self._index_build(B)

    def _staged_nbytes(self) -> int:
        """Resident bytes of the staged sorted keys, payload and raw key
        values (the memory tracker's charge, with the index's)."""
        nbytes = self._sorted_keys.nbytes
        for d, v in self._build_payload.values():
            nbytes += d.nbytes + v.nbytes
        for k in self._build_keyvals:
            nbytes += k.nbytes
        return int(nbytes)

    def _stage_device_build(self, key_arrays, ok, payload_cols) -> int:
        """Pad to a power-of-two shape bucket and run pack + sort + gather
        on the device: the build side becomes sorted tensors with the
        NULL/dead keys at the tail. Returns the resident bytes."""
        B = jk.shape_bucket(ok.shape[0])
        ok_p = _pad(ok, B, False)
        kd = tuple(_pad(k, B) for k in key_arrays)
        kv = (ok_p,) * len(key_arrays)  # key validity is folded into ok
        pd = tuple(_pad(d, B) for d, _ in payload_cols.values())
        pv = tuple(_pad(v, B, False) for _, v in payload_cols.values())
        sorted_keys, n_build_dev, out_d, out_v, out_k = jk.build_sort(
            kd, kv, ok_p, pd, pv, self._los, self._strides, self._rngs,
            modes=self._modes, hash_mode=self._hash_mode)
        self._sorted_keys = sorted_keys
        self._n_build_dev = n_build_dev
        self._build_payload = {
            uid: (d, v) for uid, d, v in zip(self._payload_uids, out_d, out_v)}
        # raw key values in build order: exact verification of
        # hash-expanded candidates reads them
        self._build_keyvals = out_k if self._hash_mode else ()
        return self._staged_nbytes() + self._index_build(B)

    # per-chunk match totals stay on the device and are fetched in one
    # read per window of this many probe chunks (or this many bytes pinned)
    PROBE_SYNC_CHUNKS = 8
    PROBE_DEFER_BYTES = 128 << 20

    def next(self) -> Optional[Chunk]:
        while True:
            out = self._pop_pending()
            if out is not None:
                return out
            if self._drained:
                return None
            self._fill_pending()

    def _pop_pending(self) -> Optional[Chunk]:
        """The next output chunk. A many-to-many chunk's expansion waits in
        _pending as a generator and runs one expand call (at most
        ctx.join_tiles tiles) at a time as the consumer drains it, so the
        probe holds O(join_tiles x capacity) output, not a window's whole
        expansion."""
        while self._pending:
            head = self._pending[0]
            if isinstance(head, Chunk):
                return self._pending.pop(0)
            out = next(head, None)
            if out is not None:
                return out
            self._pending.pop(0)
        return None

    def _fill_pending(self) -> None:
        """Pull probe chunks until output lands in _pending or the child
        drains. Chunks that need a match total (inner/left, filtered
        semi/anti) defer it; one read per window resolves every queued
        chunk."""
        deferred: List[dict] = []
        dbytes = 0
        while not self._pending and not self._drained:
            chunk = self.children[0].next()
            if chunk is None:
                self._drained = True
                break
            # a KILL/deadline interrupts the probe drain between chunks
            raise_if_cancelled(self.ctx)
            tok = self._probe_start(chunk)
            if tok is None:
                continue  # fully handled (unfiltered semi/anti)
            deferred.append(tok)
            # the window pins the chunk's columns and the probe results:
            # 4 int64 + 2 bool [Rp] tensors per token
            dbytes += sum(c.data.nbytes + c.valid.nbytes
                          for c in chunk.columns.values())
            dbytes += tok["Rp"] * 34
            if (len(deferred) >= self.PROBE_SYNC_CHUNKS
                    or dbytes >= self.PROBE_DEFER_BYTES):
                self._probe_finish_batch(deferred)
                deferred = []
                dbytes = 0
        if deferred:
            self._probe_finish_batch(deferred)

    def _probe_finish_batch(self, tokens: List[dict]) -> None:
        """Resolve a deferred window: one device-to-host read of every
        queued chunk's match total, then each chunk finishes."""
        totals = dispatch.device_get(torch.stack([t["total_dev"] for t in tokens])).tolist()
        if self.kind == "inner" and not self._has_filter:
            # plan feedback: for the unfiltered inner join the summed
            # match totals are the output cardinality, host-known from
            # the read this window already pays
            self.stats.add_out_rows(int(sum(int(t) for t in totals)))
        for tok, total in zip(tokens, totals):
            out = self._probe_finish(tok, int(total))
            if out is not None:
                self._pending.append(out)

    def _probe_start(self, chunk: Chunk) -> Optional[dict]:
        """Probe one chunk. Unfiltered semi/anti joins finish here (their
        keep mask needs no total); everything else returns a token that
        _probe_finish_batch resolves."""
        has_filter = self._has_filter
        chunk = _to_device(chunk, self.ctx.device)
        outs = [eval_expr(k, chunk) for k in self.probe_keys]
        key_datas = tuple(d for d, _ in outs)
        key_valids = tuple(v for _, v in outs)
        cap = chunk.capacity
        Rp = jk.shape_bucket(cap)
        sel = chunk.sel
        if Rp != cap:  # shape-bucket the probe: pad keys and sel to pow2
            key_datas = tuple(_pad(d, Rp) for d in key_datas)
            key_valids = tuple(_pad(v, Rp, False) for v in key_valids)
            sel = _pad(sel, Rp, False)
        left_pad = self.kind == "left" and not has_filter
        # an unfiltered semi/anti join reads only ok and matched
        flags_only = self.kind in ("semi", "anti") and not has_filter
        start, count, real_count, cum, total_dev, ok, matched = jk.probe_count(
            self._sorted_keys, self._n_build_dev, key_datas, key_valids,
            sel, self._los, self._strides, self._rngs,
            self._firsts, self._direct_lo, self._direct_rng,
            modes=self._modes, hash_mode=self._hash_mode,
            left_pad=left_pad, direct=self._direct, table=self._probe_table,
            flags_only=flags_only)

        if flags_only:
            okc, matched = ok[:cap], matched[:cap]
            if self.kind == "semi":
                self._pending.append(chunk.with_sel(okc & matched))
            elif self._build_had_null and not self.exists_sem:
                pass  # NOT IN with NULL in the subquery: no row is ever TRUE
            elif self.exists_sem:
                # NOT EXISTS: a NULL probe key never matches -> row kept
                self._pending.append(chunk.with_sel(chunk.sel & ~(okc & matched)))
            else:
                self._pending.append(chunk.with_sel(chunk.sel & okc & ~matched))
            return None
        return {"chunk": chunk, "start": start, "count": count,
                "real_count": real_count, "cum": cum,
                "total_dev": total_dev, "ok": ok, "cap": cap, "Rp": Rp}

    def _probe_finish(self, tok: dict, total: int):
        """Complete one deferred probe chunk with its host-known match
        total: qualification for filtered semi/anti (done here), tile
        expansion for inner/left (returned as a generator of output
        chunks)."""
        chunk = tok["chunk"]
        start, count, real_count = tok["start"], tok["count"], tok["real_count"]
        cum, cap = tok["cum"], tok["cap"]
        okc = tok["ok"][:cap]
        has_filter = self._has_filter

        if self.kind in ("semi", "anti"):  # has_filter: the qualified path
            matched = self._qualified_matches(chunk, start, real_count, cum, total)
            if self.kind == "semi":
                self._pending.append(chunk.with_sel(okc & matched))
                return
            if self._build_had_null and not self.exists_sem:
                return  # NOT IN with NULL in the subquery: no row is ever TRUE
            if self.exists_sem:
                # NOT EXISTS: a NULL probe key never matches -> row kept
                keep = chunk.sel & ~(okc & matched)
            else:
                keep = chunk.sel & okc & ~matched
            self._pending.append(chunk.with_sel(keep))
            return

        left_other = self.kind == "left" and has_filter
        if total == 0 and not left_other:
            return None
        return self._expanded(tok, total, left_other)

    def _expanded(self, tok: dict, total: int, left_other: bool):
        """The output chunks of one inner/left probe chunk, expanded as
        they are pulled."""
        chunk, cap, has_filter = tok["chunk"], tok["cap"], self._has_filter
        matched = (torch.zeros(cap, dtype=torch.bool, device=chunk.device)
                   if left_other else None)
        for out in self._expand_windows(chunk, tok["start"], tok["count"],
                                        tok["real_count"], tok["cum"], total,
                                        bookkeeping=has_filter):
            if has_filter:
                out = self._match_filter(out)
                if left_other:
                    matched[out.columns["__probe_row__"].data[out.sel]] = True
                # bookkeeping columns stay internal to the match tracking
                out = Chunk({u: c for u, c in out.columns.items()
                             if u not in ("__probe_row__", "__build_pos__")},
                            out.sel)
            yield out
        if left_other:
            # probe rows whose every match failed other_cond (or that had
            # none) emit one NULL-payload row each, per LEFT JOIN semantics
            unmatched = chunk.sel & ~matched
            if dispatch.device_get(unmatched.any()):  # one read: is a NULL-pad chunk due?
                yield self._null_build_chunk(chunk, unmatched)

    def _expand_windows(self, chunk: Chunk, start, count, real_count, cum,
                        total: int, bookkeeping: bool):
        """Yield output Chunks of capacity ctx.chunk_capacity, up to
        ctx.join_tiles output tiles per expand_tiles call."""
        C = self.ctx.chunk_capacity
        max_tiles = max(1, self.ctx.join_tiles)
        p_uids = list(chunk.columns.keys())
        p_datas = tuple(chunk.columns[u].data for u in p_uids)
        p_valids = tuple(chunk.columns[u].valid for u in p_uids)
        b_uids = self._payload_uids
        b_datas = tuple(self._build_payload[u][0] for u in b_uids)
        b_valids = tuple(self._build_payload[u][1] for u in b_uids)
        # a many-to-many chunk's tiles are charged while they are out
        row_bytes = 0 if total <= C else tile_row_bytes(p_datas, b_datas) + 8 * (
            bookkeeping + (bookkeeping and self._hash_mode))
        w0 = 0
        while w0 < total:
            rem = -(-(total - w0) // C)  # ceil-div: tiles still needed
            T = min(jk.shape_bucket(rem, floor=1), max_tiles)
            held = T * C * row_bytes
            self._hold(held)  # before the call: over the quota, nothing is made
            try:
                out_p, out_b, sel_t, prow, bpos = jk.expand_tiles(
                    start, count, real_count, cum, w0, p_datas, p_valids,
                    b_datas, b_valids, n_tiles=T, tile_cap=C,
                    build_cap=self._sorted_keys.shape[0],
                    left=self.kind == "left",
                    with_probe_row=bookkeeping,
                    with_build_pos=bookkeeping and self._hash_mode)
                for i in range(min(T, rem)):
                    cols = {}
                    for u, (d2, v2) in zip(p_uids, out_p):
                        cols[u] = Column(d2[i], v2[i], chunk.columns[u].type_)
                    for u, (d2, v2) in zip(b_uids, out_b):
                        cols[u] = Column(d2[i], v2[i], self._build_schema_by_uid[u].type_)
                    if prow is not None:
                        cols["__probe_row__"] = Column(prow[i], sel_t[i], INT64)
                    if bpos is not None:
                        cols["__build_pos__"] = Column(bpos[i], sel_t[i], INT64)
                    yield Chunk(cols, sel_t[i])
            finally:
                self._unhold(held)
            w0 += T * C

    def _qualified_matches(self, chunk: Chunk, start, count, cum, total: int):
        """[capacity] bool: probe rows with at least one build match that
        passes other_cond (and exact key equality in hash mode), through
        windowed expansion."""
        matched = torch.zeros(chunk.capacity, dtype=torch.bool, device=chunk.device)
        for out in self._expand_windows(chunk, start, count, count, cum,
                                        total, bookkeeping=True):
            out = self._match_filter(out)
            matched[out.columns["__probe_row__"].data[out.sel]] = True
        return matched

    def _match_filter(self, out: Chunk) -> Chunk:
        """Filter expanded candidate rows: exact key equality when the
        keys were hash-packed, then other_cond if present."""
        if self._filter_fn is None:
            other = (compile_predicate(self.other_cond)
                     if self.other_cond is not None else None)
            modes = self._pack_info[0][1] if self._hash_mode else ()

            def fn(ch):
                keep = ch.sel
                if self._hash_mode:
                    pos = ch.columns["__build_pos__"].data
                    for k_ir, mode, bv in zip(self.probe_keys, modes, self._build_keyvals):
                        pv = jk.as_int64_key(eval_expr(k_ir, ch)[0], mode)
                        keep = keep & (jk._take(bv, pos) == pv)
                if other is not None:
                    keep = keep & other(ch)
                return ch.with_sel(keep)

            self._filter_fn = fn
        return self._filter_fn(out)

    def _null_build_chunk(self, chunk: Chunk, sel) -> Chunk:
        """Probe columns pass through; build payload is all-NULL."""
        cols = dict(chunk.columns)
        for uid in self._build_payload:
            c = self._build_schema_by_uid[uid]
            cols[uid] = Column(
                torch.zeros(chunk.capacity, dtype=torch_dtype(c.type_.np_dtype),
                            device=chunk.device),
                torch.zeros(chunk.capacity, dtype=torch.bool, device=chunk.device),
                c.type_)
        return Chunk(cols, sel)


class IndexJoinExec(Executor):
    """Index-lookup join (ref: executor's IndexLookUpJoin): the inner side
    is never scanned. Each outer chunk's join keys are binary-searched on
    the host against the inner table's sorted index cache (the substrate
    PointGet and IndexRangeScan probe), candidate rows pass MVCC
    visibility, and matches gather straight from table storage onto the
    context's device. O((outer + matches) log n) host work, independent
    of the inner table's size: the access path the cascades memo costs
    against the hash join's build."""

    def __init__(self, schema, outer: Executor, eq_outer, inner_table,
                 index_name, inner_schema, inner_cond, other_cond):
        super().__init__(schema, [outer])
        self.eq_outer = eq_outer
        self.inner_table = inner_table
        self.index_name = index_name
        self.inner_schema = inner_schema
        self.inner_cond = inner_cond
        self.other_cond = other_cond

    def open(self, ctx: ExecContext) -> None:
        super().open(ctx)
        self.ctx = ctx
        self._key_fns = [compile_expr(e) for e in self.eq_outer]
        self._pending: List[Chunk] = []
        self._skeys, self._srows = self.inner_table._sorted_index(
            self.index_name)
        self._resid = None
        if self.inner_cond is not None or self.other_cond is not None:
            conds = [c for c in (self.inner_cond, self.other_cond)
                     if c is not None]
            self._resid = [compile_predicate(c) for c in conds]

    def next(self) -> Optional[Chunk]:
        while True:
            if self._pending:
                return self._pending.pop(0)
            ch = self.children[0].next()
            if ch is None:
                return None
            raise_if_cancelled(self.ctx)
            self._join_chunk(_to_device(ch, self.ctx.device))

    def _join_chunk(self, ch: Chunk) -> None:
        live_t = torch.nonzero(ch.sel).squeeze(1)
        if live_t.shape[0] == 0:
            return
        skeys, srows = self._skeys, self._srows
        nkeys = len(self._key_fns)
        i64 = np.iinfo(np.int64)
        # the index may be wider than the join key set (a composite key
        # probed on its prefix): floor/ceil the suffix fields so the whole
        # equal-prefix run matches, not just suffix == 0
        n = live_t.shape[0]
        probe_lo = np.zeros(n, dtype=skeys.dtype)
        probe_hi = np.zeros(n, dtype=skeys.dtype)
        for name in skeys.dtype.names[nkeys:]:
            probe_lo[name] = i64.min
            probe_hi[name] = i64.max
        kvalid = np.ones(n, dtype=np.bool_)
        cols = [fn(ch) for fn in self._key_fns]
        # the outer keys and the live rows cross to the host in one fetch
        # per chunk
        live_h, *keys_h = dispatch.device_get(
            [live_t] + [(c.data[live_t], c.valid[live_t]) for c in cols])
        for i, (kd, kv) in enumerate(keys_h):
            kvalid &= kv
            keys = kd.astype(np.int64)
            probe_lo[f"k{i}"] = keys
            probe_hi[f"k{i}"] = keys
        # NULL keys match nothing; searchsorted over the composite tuple
        # gives the exact equality run: no hashing, no collisions
        lo = np.searchsorted(skeys, probe_lo, side="left")
        hi = np.searchsorted(skeys, probe_hi, side="right")
        counts = np.where(kvalid, hi - lo, 0)
        total = int(counts.sum())
        if total == 0:
            return
        outer_pos = np.repeat(np.arange(n), counts)
        starts = np.repeat(lo, counts)
        offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts, counts)
        cand = srows[starts + offs]
        vis = self.inner_table._mvcc_mask(
            cand, read_ts=self.ctx.read_ts, marker=self.ctx.txn_marker)
        cand = cand[vis]
        outer_rows = live_h[outer_pos[vis]]
        # windowed emission: expansion is bounded to chunk_capacity per
        # output chunk (the HashJoinExec contract), so a many-match key
        # set cannot spike memory or mint giant downstream shapes
        win = max(self.ctx.chunk_capacity, 8)
        for s0 in range(0, len(cand), win):
            self._emit(ch, outer_rows[s0:s0 + win], cand[s0:s0 + win])

    def _emit(self, ch: Chunk, outer_rows, cand) -> None:
        if len(cand) == 0:
            return
        dev = ch.device
        cap = 8
        while cap < len(cand):
            cap *= 2
        cols = {}
        for c in self.inner_schema:
            d = self.inner_table.data[c.name][cand]
            v = self.inner_table.valid[c.name][cand]
            cols[c.uid] = Column.from_numpy(d, c.type_, valid=v, capacity=cap,
                                            device=dev)
        idx = _pad(torch.from_numpy(outer_rows).to(dev), cap)
        pad = torch.arange(cap, device=dev) < len(cand)
        for uid, col in ch.columns.items():
            cols[uid] = Column(col.data[idx], col.valid[idx] & pad, col.type_)
        out = Chunk(cols, pad)
        if self._resid is not None:
            for pred in self._resid:
                out = out.filter(pred(out))
        self.stats.chunks += 1
        self._pending.append(out)
