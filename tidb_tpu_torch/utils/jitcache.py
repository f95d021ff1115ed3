"""Built-program cache (the counterpart of tidb_tpu/utils/jitcache.py;
ref: the planner's plan cache reusing compiled plans across executions).

The reference compiles each fused batch of the executor's pipeline into
one XLA program through ``cached_jit``, keyed by the repr of the IR the
program bakes in, so a batch costs one dispatch. Here the built function
is eager torch, and on the card each input signature of it becomes one
captured CUDA graph:

  * a signature's calls run eagerly until one has returned: that is the
    warm-up, in which nvcc builds, the expression compiler's lookup
    uploads, the probe's scan scratch and the allocator's growth all
    happen, outside any capture (a call that arrives while another
    thread's warm-up runs warms up too); what the warm-up uploaded is
    held for the capture (``dispatch.Warmup``), so a lookup table evicted
    from the compiler's cache in between is not uploaded inside it;
  * the next call captures a ``torch.cuda.CUDAGraph`` of exactly the
    launches the function makes (on a side stream, in thread-local
    capture mode, so other threads keep launching), and every later call
    replays it on the caller's current stream.

A signature is everything that changes the launches: the tree of the
arguments, each tensor's shape, dtype, strides and device, and every
non-tensor leaf by value (None-ness of an optional operand, a baked
Python int); the batch's capacity and segment stride are in the shapes
and the key. Keys stay reprs of the compiled IR: binder uids are
deterministic per statement, so the same SQL text gives the same key,
while any difference in baked constants (dictionary codes for string
literals) changes it.

A graph reads fixed addresses, and before a replay the arguments are
copied into them (a ``Packed`` argument, whose tensors are views of one
buffer, is one tensor to the signature and the copy: a staged scan
batch, the segment aggregation's and the top-k's state). A donated
argument's slots are the graph's own. A read-only argument's slots
belong to the program, one set per argument and shapes, shared by every
graph of it: the probe's build side, the same for the full batches and
the tail batch of a scan, is held once per program, not once per
signature; a read-only tensor that is still the one last copied into
its slot, unchanged, is not copied again. A program's replays run one at
a time, since its graphs share those slots. Inside the graph the outputs are packed into one buffer
of the graph's pool, and after the replay that buffer is cloned once: the
caller gets fresh tensors that no later replay overwrites, so a probe
window or a group-table stack may hold them as long as it likes. A
donated argument (``donate_argnums``) may be updated in place by the
function; the caller takes the returned state, never the argument. A
graph holds copies, never a staged batch itself, so the device buffer
cache's invalidations need nothing from this cache.

A resident argument (``resident_argnums``: a mesh fragment's resident
sharding, parallel/executor.py) is read where it lies, as the
reference's jitted program reads the sharded arrays it is passed: it has
no slot and is never copied, and each of its tensors' addresses is part
of the signature beside its shape, dtype and strides. A replay therefore
reads only the memory of tensors its caller passes, alive for the call,
and a graph keeps no reference to them: it cannot pin a retired sharding
nor read freed memory. A program names the shardings it reads
(``owners``); ``drop_owner`` removes every program an owner has, which
the sharding cache runs when it lets a sharding go.

A call whose tensors lie on more than one device (a mesh over several
cards: its collectives copy between cards, which one graph cannot
capture) runs eagerly, counted apart in ``runs()`` as
``eager_multi_device``.

Programs of one ``pool`` (a statement's mesh fragments: each graph's
pool would hold a whole fragment's intermediates, gigabytes at SF1)
capture into one memory pool on each device and share one set of static
slots and one replay lock there: their replays run one at a time, in
stream order, and each is cloned out before the next, so their
intermediates may overlap and the pool holds about the largest
capture's, not their sum.

Captures are serialized in the process and run on a stream of torch's
high-priority pool (the default pool hands its streams out round-robin,
and another thread's copy on the capturing stream would invalidate the
capture). A CUDA random-number op on another thread fails while a
capture is open (torch's generator); the engine draws none on the card.

Nothing falls back: a capture or replay that fails raises. A failed
capture puts its signature back to unseen, so the next call warms up
again. The eager path on the card is reached only through the explicit
switch ``set_graphs(False)`` (or ``eager()``), which chip_smoke.py,
host_ab.py and tests use to compare; on a CPU tensor the function runs
eagerly.

Every call records one dispatch at ``jit:<ns>`` (utils/dispatch.py), a
capture charges its wall time to the statement's compile seconds, and
the host-side effects the function has (launch and route counts) run at
each replay (``dispatch.on_execute``), so the kernels' launch counts
equal their executions. The cache is bounded by entries (LRU) and by the
device bytes its graphs hold (private pools and static input buffers):
the GLOBAL quota ``tidb_tpu_graph_cache_bytes``, which each fused site
passes from its statement's context as the device buffer cache's
callers pass theirs; the least recent entries go first. A shared pool
counts as a whole (what its captures reserved and its slots) and goes
with its last program.
"""

from __future__ import annotations

import contextlib
import threading
import time
import weakref
from collections import OrderedDict
from collections.abc import Mapping
from typing import Callable, Dict, List, Sequence, Tuple

import torch

from tidb_tpu_torch.utils import dispatch, tracing
from tidb_tpu_torch.utils.lru import get_or_build

__all__ = ["cached_jit", "clear", "size", "resident_bytes", "set_graphs",
           "graphs_enabled", "eager", "runs", "reset_runs", "graph_bytes",
           "drop_owner", "programs", "held_units",
           "MAX_ENTRIES", "MAX_BYTES", "max_bytes", "Packed", "PackedMap", "PackedTuple",
           "PackedLayout", "packed", "packed_view", "update_packed"]

# LRU-bounded: keys bake in value-level constants (dictionary codes for
# string literals), so mutating workloads mint new keys over time — old
# entries must age out rather than accumulate for the process lifetime.
MAX_ENTRIES = 512
# and bounded by the device bytes the captured graphs hold: the least
# recently used entries go first (a graph in use stays alive until its
# caller drops it). The default of tidb_tpu_graph_cache_bytes; the bound
# in force is the last one a caller passed (max_bytes())
MAX_BYTES = 4 << 30
_BOUND = [MAX_BYTES]

_CACHE: "OrderedDict[Tuple[str, str], _Program]" = OrderedDict()
# statements run on several threads (the serving tier's workers): the
# OrderedDict's recency moves and evictions must not interleave
_LOCK = threading.Lock()
# one capture at a time in the process: they share a side stream per card
_CAPTURE_LOCK = threading.Lock()
_CAPTURE_STREAMS: Dict[object, object] = {}

_GRAPHS = [True]
# calls of cached programs by namespace and how they ran, process-wide
# (reset_runs)
_RUNS: Dict[str, Dict[str, int]] = {}
_RUNS_LOCK = threading.Lock()

_ALIGN = 256  # every group of the static input buffer and every packed output


def set_graphs(on: bool) -> bool:
    """Turn CUDA-graph capture and replay on or off for the process (off:
    every call runs eagerly, on the card too). Returns the old setting."""
    old = _GRAPHS[0]
    _GRAPHS[0] = bool(on)
    return old


def graphs_enabled() -> bool:
    return _GRAPHS[0]


@contextlib.contextmanager
def eager():
    """The eager path on the card for the duration of the block."""
    old = set_graphs(False)
    try:
        yield
    finally:
        set_graphs(old)


def runs() -> Dict[str, Dict[str, int]]:
    """{ns: {"eager"|"capture"|"replay"|"eager_multi_device": calls}} since
    ``reset_runs``."""
    with _RUNS_LOCK:
        return {k: dict(v) for k, v in _RUNS.items()}


def reset_runs() -> None:
    with _RUNS_LOCK:
        _RUNS.clear()


def _note_run(ns: str, how: str) -> None:
    dispatch.record_jit(f"jit:{ns}")
    with _RUNS_LOCK:
        per = _RUNS.setdefault(ns, {})
        per[how] = per.get(how, 0) + 1


def cached_jit(ns: str, key: str, build: Callable[[], Callable],
               donate_argnums: Sequence[int] = (), max_bytes: int = None,
               resident_argnums: Sequence[int] = (), owners: Sequence = (),
               pool: str = None) -> Callable:
    """Return the counted program for (ns, key), building it on first use.

    `build` returns the function; it is only called on a miss. The
    function takes every per-execution value (staged batch, state, build
    side) as arguments, tensors in nested tuples, lists and dicts, and
    returns such a tree; one entry serves every signature (a graph each
    on the card). `donate_argnums` names the arguments the function may
    update in place (the reference's donated state). `max_bytes` (the
    statement's tidb_tpu_graph_cache_bytes) becomes the bound on the bytes
    the cache's graphs hold. `resident_argnums` names the arguments read in
    place (no slot, no copy; their tensors' addresses join the signature)
    and `owners` the tags whose ``drop_owner`` removes this program; both
    belong in `key`. Programs of one `pool` share a memory pool, static
    slots and a replay lock on each device."""
    donate = tuple(sorted(set(int(i) for i in donate_argnums)))
    resident = tuple(sorted(set(int(i) for i in resident_argnums)))
    if set(donate) & set(resident):
        raise ValueError("an argument cannot be both donated and resident")
    if max_bytes is not None:
        _BOUND[0] = max(int(max_bytes), 0)
    return _entry(ns, key, lambda: _Program(ns, build(), donate, resident,
                                            frozenset(owners), pool))


def max_bytes() -> int:
    """The bound in force on the bytes the cached graphs hold."""
    return _BOUND[0]


def _entry(ns: str, key: str, make: Callable[[], "_Program"]) -> "_Program":
    # the builder arrives as a parameter: the cache-key-completeness pass
    # then checks each cached_jit caller's key, not this lookup
    with _LOCK:
        _drop_pending_locked()
        n, miss = len(_CACHE), (ns, key) not in _CACHE
        prog = get_or_build(_CACHE, (ns, key), make, MAX_ENTRIES)
        if miss and len(_CACHE) <= n:  # past MAX_ENTRIES: an entry went
            _release_pools_locked()
        _trim_locked()
    return prog


# owners whose programs are to go: drop_owner may run from a finalizer,
# at any allocation of any thread, the one holding _LOCK included; what it
# cannot drop at once waits here for the next access under the lock
_PENDING: List = []


def drop_owner(tag) -> None:
    """Remove every program whose owners include `tag` (a sharding the
    sharding cache let go), with its graphs and their pools. Safe from a
    finalizer, which may run inside any allocation of any thread: it
    takes no lock but tries the cache's one, and when that is busy the
    drop happens at the cache's next access."""
    _PENDING.append(tag)
    if _LOCK.acquire(blocking=False):
        try:
            _drop_pending_locked()
        finally:
            _LOCK.release()


def _drop_pending_locked() -> None:
    dropped = False
    while _PENDING:
        tag = _PENDING.pop()
        for k in [k for k, p in _CACHE.items() if tag in p.owners]:
            del _CACHE[k]
            dropped = True
    if dropped:
        _release_pools_locked()


def _release_pools_locked() -> None:
    """Let go of each pool no cached program uses any more: its memory
    returns once the last of its graphs is gone."""
    used = {p.pool for p in _CACHE.values()}
    for k in [k for k in _POOLS if k[0] not in used]:
        del _POOLS[k]


def programs(owner=None) -> List["_Program"]:
    """The cached programs (those `owner` has, when given)."""
    with _LOCK:
        _drop_pending_locked()
        return [p for p in _CACHE.values() if owner is None or owner in p.owners]


def _units_locked() -> List[tuple]:
    """The cache's units of device memory, least recently used first:
    (bytes, keys) of each unpooled program and of each pool (its programs'
    keys; its recency its most recent program's)."""
    pool_bytes: Dict[str, int] = {}
    for (pool, _dev), sh in _POOLS.items():
        pool_bytes[pool] = pool_bytes.get(pool, 0) + sh.nbytes
    order: "OrderedDict[tuple, list]" = OrderedDict()
    for k, p in _CACHE.items():
        unit = (False, k) if p.pool is None else (True, p.pool)
        order.setdefault(unit, []).append(k)
        order.move_to_end(unit)
    return [(pool_bytes.get(name, 0) if pooled else _CACHE[name].nbytes, keys)
            for (pooled, name), keys in order.items()]


def _trim_locked() -> None:
    """Evict the least recently used units (an unpooled program, or a pool
    with all its programs) while the graphs hold more than the bound; the
    most recent unit stays, whatever it holds."""
    units = _units_locked()
    total = sum(b for b, _keys in units)
    released = False
    while total > _BOUND[0] and len(units) > 1:
        nbytes, keys = units.pop(0)
        for k in keys:
            del _CACHE[k]
        total -= nbytes
        released = True
    if released:
        _release_pools_locked()


def held_units() -> List[int]:
    """Device bytes of each unit the cache holds (an unpooled program's
    graphs, or a pool), least recently used first."""
    with _LOCK:
        _drop_pending_locked()
        return [b for b, _keys in _units_locked()]


def _grew() -> None:
    """A program captured a graph: re-check the bytes bound."""
    with _LOCK:
        _trim_locked()


def clear() -> None:
    with _LOCK:
        _PENDING.clear()
        _CACHE.clear()
        _POOLS.clear()  # the pools' slots (a graph still in use keeps its own)


def size() -> int:
    with _LOCK:
        _drop_pending_locked()
        return len(_CACHE)


def resident_bytes() -> int:
    """Device bytes the cached graphs hold (pools and static buffers)."""
    return sum(held_units())


def graph_bytes() -> Dict[str, List[int]]:
    """Per namespace, the bytes of each cached graph."""
    with _LOCK:
        _drop_pending_locked()
        progs = list(_CACHE.values())
    out: Dict[str, List[int]] = {}
    for p in progs:
        out.setdefault(p.ns, []).extend(g.nbytes for g in p.graphs())
    return out


# ---------------------------------------------------------------------------
# argument trees
# ---------------------------------------------------------------------------

class Packed:
    """A mixin for an argument tree whose tensors are all views of one
    byte buffer (``packed_buf``, a 1-d uint8 tensor) at the places its
    ``packed_layout`` (a PackedLayout) describes. A program's signature
    and copy-in see one tensor, not one per view: a staged scan batch, the
    segment aggregation's and the top-k's state."""

    __slots__ = ()

    @classmethod
    def over(cls, buf, layout: "PackedLayout", tree=None):
        raise NotImplementedError


class PackedLayout:
    """The places of a packed tree's tensors: the tree's spec (as
    ``_flatten`` gives it), (offset, nbytes, dtype, shape) per tensor in
    its order, the buffer's size and the Packed class that rebuilds it.
    Equal layouts hash alike (the hash is computed once)."""

    __slots__ = ("spec", "places", "nbytes", "kind", "_hash")

    def __init__(self, spec, places: tuple, nbytes: int, kind):
        self.spec, self.places, self.nbytes, self.kind = spec, places, nbytes, kind
        self._hash = hash((spec, places, nbytes, kind))

    def __hash__(self):
        return self._hash

    def __eq__(self, other):
        return self is other or (isinstance(other, PackedLayout) and self._hash == other._hash
                                 and (self.spec, self.places, self.nbytes, self.kind)
                                 == (other.spec, other.places, other.nbytes, other.kind))

    def views(self, buf) -> list:
        return [buf[o:o + n].view(dt).view(shape) for o, n, dt, shape in self.places]

    def tree(self, buf):
        """The tree of views of `buf` (plain dicts and tuples)."""
        return _unflatten(self.spec, iter(self.views(buf)))

    def rebuild(self, buf) -> Packed:
        return self.kind.over(buf, self)


class PackedMap(Mapping, Packed):
    """A read-only mapping of names to tensors that are views of one
    buffer; the views are made at the first access, so a replay that hands
    the map on to the next batch makes none."""

    __slots__ = ("packed_buf", "packed_layout", "_views")

    def __init__(self, buf, layout: PackedLayout, views: dict = None):
        self.packed_buf, self.packed_layout, self._views = buf, layout, views

    @classmethod
    def over(cls, buf, layout: PackedLayout, tree=None) -> "PackedMap":
        return cls(buf, layout, tree)

    def _view(self) -> dict:
        if self._views is None:
            self._views = self.packed_layout.tree(self.packed_buf)
        return self._views

    def __getitem__(self, key):
        return self._view()[key]

    def __iter__(self):
        return iter(self._view())

    def __len__(self):
        return len(self.packed_layout.spec[1])


class PackedTuple(tuple, Packed):
    """A tuple tree of tensors that are views of one buffer."""

    @classmethod
    def over(cls, buf, layout: PackedLayout, tree=None) -> "PackedTuple":
        t = cls(layout.tree(buf) if tree is None else tree)
        t.packed_buf, t.packed_layout = buf, layout
        return t


def _kind(tree):
    if isinstance(tree, dict):
        return PackedMap
    if isinstance(tree, tuple):
        return PackedTuple
    raise TypeError(f"a packed tree is a dict or a tuple, not {type(tree).__name__}")


def packed_view(buf, tree) -> Packed:
    """`tree` (a dict or a tuple tree) whose tensors are all contiguous
    views of the 1-d uint8 tensor `buf`, as a Packed value over it."""
    leaves: list = []
    spec = _flatten(tree, leaves)
    base = buf.data_ptr()
    places = tuple((t.data_ptr() - base, t.numel() * t.element_size(), t.dtype,
                    tuple(t.shape)) for t in leaves)
    kind = _kind(tree)
    return kind.over(buf, PackedLayout(spec, places, buf.numel(), kind), tree)


def packed(tree) -> Packed:
    """The tensors of `tree` (a dict or a tuple tree) copied into one
    buffer on their device, each on a 256-byte boundary, as a Packed value
    of views (updated in place, they update the buffer)."""
    leaves: list = []
    spec = _flatten(tree, leaves)
    places, off = [], 0
    for t in leaves:
        n = t.numel() * t.element_size()
        places.append((off, n, t.dtype, tuple(t.shape)))
        off += _aligned(max(n, 1))
    dev = leaves[0].device if leaves else torch.device("cpu")
    kind = _kind(tree)
    layout = PackedLayout(spec, tuple(places), max(off, _ALIGN), kind)
    buf = torch.empty(layout.nbytes, dtype=torch.uint8, device=dev)
    _copy_all(layout.views(buf), leaves)
    return layout.rebuild(buf)


def update_packed(state: Packed, tree) -> Packed:
    """Copy the tensors of `tree`, a tree of the same form, into the
    views of the packed `state`, in place; returns `state` (a donated
    state's update inside a program)."""
    leaves: list = []
    if _flatten(tree, leaves) != state.packed_layout.spec:
        raise ValueError("update_packed: the tree is not of the state's form")
    _copy_all(state.packed_layout.views(state.packed_buf), leaves)
    return state


def _flatten(tree, leaves: list):
    """The tree's spec (hashable; non-tensor leaves by value) and its
    tensors appended to `leaves` in order (a Packed tree: its buffer)."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return 0
    if isinstance(tree, Packed):
        leaves.append(tree.packed_buf)
        return ("p", tree.packed_layout)
    if isinstance(tree, dict):
        return ("d", tuple(tree.keys()), tuple(_flatten(v, leaves) for v in tree.values()))
    if isinstance(tree, tuple):
        return ("t", tuple(_flatten(v, leaves) for v in tree))
    if isinstance(tree, list):
        return ("l", tuple(_flatten(v, leaves) for v in tree))
    hash(tree)  # a baked value must be hashable to join the signature
    return ("v", tree)


def _unflatten(spec, it):
    if spec == 0:
        return next(it)
    kind = spec[0]
    if kind == "d":
        return {k: _unflatten(s, it) for k, s in zip(spec[1], spec[2])}
    if kind == "t":
        return tuple(_unflatten(s, it) for s in spec[1])
    if kind == "l":
        return [_unflatten(s, it) for s in spec[1]]
    if kind == "p":
        return spec[1].rebuild(next(it))
    return spec[1]


def _aligned(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _on_card(dev) -> bool:
    return dev.type == "cuda"


def _packing(leaves: list):
    """Where each tensor goes in one byte buffer: leaves grouped by dtype
    (each dtype's region on a 256-byte boundary, its leaves back to back
    in leaf order, so one split views them all), and the buffer's size.
    Returns ([(offset, nbytes)] per leaf, [(dtype, start, [leaf], [numel])]
    per region, size)."""
    regions: "OrderedDict[torch.dtype, list]" = OrderedDict()
    for i, t in enumerate(leaves):
        regions.setdefault(t.dtype, []).append(i)
    place: List[tuple] = [None] * len(leaves)
    plan, off = [], 0
    for dt, idxs in regions.items():
        start = off
        esz = torch.empty(0, dtype=dt).element_size()
        numels = []
        for i in idxs:
            n = leaves[i].numel()
            place[i] = (off, n * esz)
            numels.append(n)
            off += n * esz
        plan.append((dt, start, idxs, numels))
        off = _aligned(off)
    return place, plan, max(off, _ALIGN)


# ---------------------------------------------------------------------------
# programs and their graphs
# ---------------------------------------------------------------------------

class _Shared:
    """What a program's graphs share (or a pool's, on one device): the
    read-only arguments' slots (per argument number and shapes), the lock
    and stream of the replays that copy into them, and for a pool its
    memory pool's handle."""

    def __init__(self, handle=None):
        self.lock = threading.Lock()
        self.slots: Dict[tuple, "_Slots"] = {}
        self.event = None
        self.last_stream = None
        self.handle = handle
        # a pool's first capture: a one-fill graph that keeps the pool
        # alive while this object lives (the allocator refuses a capture
        # into a pool id whose every graph has gone)
        self.anchor = None
        self.nbytes = 0  # a pool's: what its captures reserved, its slots


# (pool, device) -> the pool's _Shared, under _LOCK (the one lock a
# finalizer's drop_owner meets, and it never waits on it)
_POOLS: Dict[tuple, _Shared] = {}


def _pool_shared(pool: str, dev) -> _Shared:
    with _LOCK:
        sh = _POOLS.get((pool, dev))
        if sh is None:
            sh = _POOLS[(pool, dev)] = _Shared(torch.cuda.graph_pool_handle())
        return sh


class _Slots:
    """One read-only argument's static slots: its tensors packed by dtype
    into one buffer, and per tensor the (weakref, version) last copied
    in."""

    def __init__(self, leaves: list, dev):
        place, _plan, size = _packing(leaves)
        self.buf = torch.empty(size, dtype=torch.uint8, device=dev)
        self.views = [self.buf[o:o + nb].view(t.dtype).view(t.shape)
                      for (o, nb), t in zip(place, leaves)]
        self.last: List = [None] * len(leaves)


class _Program:
    """One cache entry: the built function and, per signature, nothing
    (no warm-up has returned yet), the warm-up's record (the next call
    captures) or the captured graph."""

    def __init__(self, ns: str, fn: Callable, donate: Tuple[int, ...],
                 resident: Tuple[int, ...] = (), owners: frozenset = frozenset(),
                 pool: str = None):
        self.ns = ns
        self.fn = fn
        self.donate = donate
        self.resident = resident
        self.owners = owners
        self.pool = pool
        self._sigs: Dict[tuple, object] = {}
        self._lock = threading.Lock()
        self._shared = _Shared() if pool is None else None
        self.nbytes = 0

    def shared(self, dev) -> _Shared:
        """The slots and replay lock this program's graphs use on `dev`."""
        return self._shared if self.pool is None else _pool_shared(self.pool, dev)

    def graphs(self) -> List["_Graph"]:
        with self._lock:
            return [g for g in self._sigs.values() if isinstance(g, _Graph)]

    def slot_bytes(self) -> int:
        """Device bytes of the static input slots of this program's graphs
        (a resident argument has none; a pool's slots count whole)."""
        shared = {id(g.shared): g.shared for g in self.graphs()}
        ro = 0
        for sh in shared.values():
            with sh.lock:
                ro += sum(sl.buf.numel() for sl in sh.slots.values())
        return ro + sum(g.in_buf.numel() for g in self.graphs())

    def __call__(self, *args):
        """Run the program; the call is a ``jit.<ns>`` range while a
        profiler is active, and its host seconds and how it ran go into
        the statement's ``jit.<ns>`` span."""
        name = "jit." + self.ns
        rf = tracing.open_range(name) if tracing.profiling() else None
        t0 = time.perf_counter()
        try:
            how, out = self._run(args)
        finally:
            if rf is not None:
                rf.__exit__(None, None, None)
        tracing.tally(name, t0, time.perf_counter() - t0, how)
        return out

    def _run(self, args):
        """(how it ran, the outputs)."""
        leaves: list = []
        spec = _flatten(args, leaves)
        dev = leaves[0].device if leaves else None
        if dev is None or not _GRAPHS[0] or not _on_card(dev):
            _note_run(self.ns, "eager")
            return "eager", self.fn(*args)
        if len(_devices(leaves)) > 1:
            # the collectives of a mesh over several cards copy between
            # them: no one graph captures that, so it stays eager
            _note_run(self.ns, "eager_multi_device")
            return "eager_multi_device", self.fn(*args)
        kinds = _leaf_kinds(spec, self.donate, self.resident)
        sig = (spec, dev, tuple((t.shape, t.dtype, t.stride()) for t in leaves),
               tuple(t.data_ptr() for t, k in zip(leaves, kinds) if k == _RESIDENT))
        with self._lock:
            g = self._sigs.get(sig)
        if g is None:
            return "eager", self._warm_up(sig, args, dev)
        how = "replay"
        if not isinstance(g, _Graph):
            with _CAPTURE_LOCK:
                with self._lock:
                    g = self._sigs.get(sig)
                if g is None:
                    # another thread's capture of it failed: warm up again
                    return "eager", self._warm_up(sig, args, dev)
                if not isinstance(g, _Graph):
                    g = self._capture(sig, g, spec, leaves, dev)
                    how = "capture"
            if how == "capture":
                _grew()
        _note_run(self.ns, how)
        return how, g.run(leaves)

    def _warm_up(self, sig, args, dev):
        """An eager call of a signature not yet warmed up: builds, uploads
        and allocator growth happen here, and the copy kernels the capture
        will pack the outputs with load (a kernel's first load must not
        fall inside a capture). The first to return lets the next call
        capture, with what it retained held for that capture."""
        _note_run(self.ns, "eager")
        with dispatch.Warmup() as warm:
            out = self.fn(*args)
            out_leaves: list = []
            _flatten(out, out_leaves)
            place, _plan, size = _packing(out_leaves)
            _pack(out_leaves, place, torch.empty(size, dtype=torch.uint8, device=dev))
        with self._lock:
            self._sigs.setdefault(sig, warm)
        return out

    def _capture(self, sig, warm, spec, leaves: list, dev) -> "_Graph":
        """Capture the signature (under _CAPTURE_LOCK). A failure puts it
        back to unseen, so the next call warms up again, and raises."""
        t0 = time.perf_counter()
        try:
            g = _Graph.capture(self, spec, leaves, dev, warm.held)
        except BaseException:
            with self._lock:
                if self._sigs.get(sig) is warm:
                    del self._sigs[sig]
            raise
        dispatch.record_compile_seconds(time.perf_counter() - t0)
        with self._lock:
            self._sigs[sig] = g
            if self.pool is None:
                self.nbytes += g.nbytes
            else:
                g.shared.nbytes += g.nbytes  # the pool's, shared by its graphs
        return g


class _Graph:
    """One captured signature: the graph, its static input slots (its own
    for donated arguments, the program's for read-only ones), its packed
    output buffer and the host effects to replay."""

    def __init__(self):
        self.shared = None
        self.graph = None
        self.device = None
        self.in_buf = None
        self.slots: List = []          # static view per tensor leaf (None: resident)
        self.ro_slots: List = []       # per leaf: (program's _Slots, index) or None
        self.resident: List[bool] = []  # per leaf: read in place, never copied
        self.out_buf = None
        self.out_spec = None
        self.out_plan: List[tuple] = []  # _packing's regions of the outputs
        self.out_shapes: List[tuple] = []
        self.out_place: List[tuple] = []
        self.capture_rec = None
        self.nbytes = 0

    # -- capture -----------------------------------------------------------

    @classmethod
    def capture(cls, prog: _Program, spec, leaves: list, dev, held: dict) -> "_Graph":
        self = cls()
        self.device = dev
        self.shared = prog.shared(dev)
        self._place_slots(spec, leaves, prog, dev)
        static_args = _unflatten(spec, iter(self.slots))
        stream = _CAPTURE_STREAMS.get(dev)
        if stream is None:
            # from torch's high-priority pool: the default-priority pool
            # hands its streams out round-robin (the prefetchers' copy
            # streams), and a copy that lands on the capturing stream from
            # another thread invalidates the capture
            stream = _CAPTURE_STREAMS[dev] = torch.cuda.Stream(device=dev, priority=-1)
        cur = torch.cuda.current_stream(dev)
        stream.wait_stream(cur)
        reserved = torch.cuda.memory_reserved(dev)
        graph = _new_graph()
        rec = dispatch.Capture(held)

        def body():
            out = prog.fn(*static_args)
            out_leaves: list = []
            self.out_spec = _flatten(out, out_leaves)
            if self.out_buf is None:
                self.out_place, self.out_plan, size = _packing(out_leaves)
                self.out_shapes = [t.shape for t in out_leaves]
                self.out_buf = torch.empty(size, dtype=torch.uint8, device=dev)
            _pack(out_leaves, self.out_place, self.out_buf)

        with torch.cuda.device(dev), torch.cuda.stream(stream), rec:
            sh = self.shared
            if sh.handle is not None and sh.anchor is None:
                anchor = _new_graph()
                self._capture_body(anchor, lambda: torch.zeros(1, device=dev), sh.handle)
                sh.anchor = anchor
            self._capture_body(graph, body, sh.handle)
        cur.wait_stream(stream)
        # the graph reads resident tensors where they lie; it holds none
        self.slots = [None if r else v for v, r in zip(self.slots, self.resident)]
        rec.held = {}  # the graph keeps what it read (retained), no more
        self.graph = graph
        self.capture_rec = rec
        self.nbytes += _pool_bytes(dev, reserved) + self.in_buf.numel()
        return self

    def _place_slots(self, spec, leaves: list, prog: _Program, dev) -> None:
        """Static slots, contiguous whatever a leaf's strides (copy_ reads
        them): the donated leaves packed by dtype into this graph's
        buffer, each read-only argument's leaves in the program's slots
        for its shapes (made here if new: their bytes count as this
        graph's); a resident leaf is its own slot while the body is
        captured, and none after."""
        kinds = _leaf_kinds(spec, prog.donate, prog.resident)
        argnos = _leaf_argnos(spec)
        own = [i for i, k in enumerate(kinds) if k == _DONATED]
        place, _plan, size = _packing([leaves[i] for i in own])
        self.in_buf = torch.empty(size if own else 0, dtype=torch.uint8, device=dev)
        self.slots = [None] * len(leaves)
        self.ro_slots = [None] * len(leaves)
        self.resident = [k == _RESIDENT for k in kinds]
        for i, (o, nb) in zip(own, place):
            t = leaves[i]
            self.slots[i] = self.in_buf[o:o + nb].view(t.dtype).view(t.shape)
        for i, r in enumerate(self.resident):
            if r:
                self.slots[i] = leaves[i]
        by_arg: Dict[int, List[int]] = {}
        for i, k in enumerate(kinds):
            if k == _READONLY:
                by_arg.setdefault(argnos[i], []).append(i)
        for argno, idxs in by_arg.items():
            key = (argno, tuple((leaves[i].shape, leaves[i].dtype) for i in idxs))
            with self.shared.lock:
                slots = self.shared.slots.get(key)
                if slots is None:
                    slots = self.shared.slots[key] = _Slots([leaves[i] for i in idxs], dev)
                    self.nbytes += slots.buf.numel()
            for k, i in enumerate(idxs):
                self.slots[i] = slots.views[k]
                self.ro_slots[i] = (slots, k)
        # the slots hold this call's values while the body is captured
        stream = torch.cuda.current_stream(dev)
        with self.shared.lock:
            self._copy_in(leaves, stream)
            self._done_on(stream)

    @staticmethod
    def _capture_body(graph, body: Callable[[], None], pool=None) -> None:
        """Capture `body` into `graph` on the current (side) stream, into
        the memory pool `pool` (a graph_pool_handle) or a private one;
        other threads' launches stay legal meanwhile (thread-local mode)."""
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            body()
        except BaseException:
            try:
                graph.capture_end()
            except Exception:  # noqa: BLE001 — the capture's own error wins
                pass
            raise
        graph.capture_end()

    # -- replay ------------------------------------------------------------

    def run(self, leaves: list):
        stream = torch.cuda.current_stream(self.device)
        with self.shared.lock:
            self._copy_in(leaves, stream)
            self.graph.replay()
            out = self.out_buf.clone()
            self._done_on(stream)
        self.capture_rec.replay_effects()
        # one split per dtype region views every output: fresh tensors
        views: List = [None] * len(self.out_shapes)
        for dt, start, idxs, numels in self.out_plan:
            end = self.out_place[idxs[-1]][0] + self.out_place[idxs[-1]][1]
            for i, v in zip(idxs, out[start:end].view(dt).split(numels)):
                shape = self.out_shapes[i]
                views[i] = v if len(shape) == 1 else v.view(shape)
        return _unflatten(self.out_spec, iter(views))

    def _copy_in(self, leaves: list, stream) -> None:
        """The arguments into their slots on `stream`, in one grouped copy
        (under the program's lock); a read-only leaf that is still the
        tensor last copied into its shared slot, unchanged, is skipped
        (the probe's build side)."""
        sh = self.shared
        if sh.last_stream is not None and sh.last_stream != stream:
            # the last user's copies and clone ran on another stream
            stream.wait_event(sh.event)
        dsts, srcs = [], []
        for i, t in enumerate(leaves):
            if self.resident[i]:
                continue  # read where it lies (its address is in the signature)
            ro = self.ro_slots[i]
            if ro is not None:
                slots, k = ro
                seen = slots.last[k]
                if seen is not None and seen[0]() is t and seen[1] == t._version:
                    continue
                slots.last[k] = (weakref.ref(t), t._version)
            dsts.append(self.slots[i])
            srcs.append(t)
        _copy_all(dsts, srcs)

    def _done_on(self, stream) -> None:
        """The slots' last use was on `stream` (under the program's lock)."""
        sh = self.shared
        if sh.event is None:
            sh.event = torch.cuda.Event()
        sh.event.record(stream)
        sh.last_stream = stream


def _new_graph():
    # lint: disable=jit-hygiene -- the sanctioned captures: one graph per
    # (ns, key) entry and input signature, and one anchor per shared pool,
    # kept in this cache (module doc)
    return torch.cuda.CUDAGraph()


def _leaf_count(s) -> int:
    if s == 0:
        return 1
    if s[0] == "d":
        return sum(_leaf_count(c) for c in s[2])
    if s[0] in ("t", "l"):
        return sum(_leaf_count(c) for c in s[1])
    return int(s[0] == "p")


def _leaf_argnos(spec) -> List[int]:
    """Per tensor leaf of the argument tuple: its argument's number."""
    out: List[int] = []
    for argno, s in enumerate(spec[1]):
        out += [argno] * _leaf_count(s)
    return out


_DONATED, _READONLY, _RESIDENT = 0, 1, 2


def _leaf_kinds(spec, donate: Tuple[int, ...], resident: Tuple[int, ...]) -> List[int]:
    """Per tensor leaf of the argument tuple: in a donated argument, a
    resident one, or a read-only one (copied into the program's slots)."""
    return [_DONATED if a in donate else _RESIDENT if a in resident else _READONLY
            for a in _leaf_argnos(spec)]


def _devices(leaves: list) -> set:
    """The devices the tensor leaves of a call lie on."""
    return {t.device for t in leaves}


def _pack(out_leaves: list, place: list, buf) -> None:
    """Each output into its place in `buf` (inside a capture: graph nodes)."""
    dsts, srcs = [], []
    for (o, nb), t in zip(place, out_leaves):
        if nb:
            dsts.append(buf[o:o + nb].view(t.dtype).view(t.shape))
            srcs.append(t)
    _copy_all(dsts, srcs)


def _copy_all(dsts: list, srcs: list) -> None:
    """dst.copy_(src) for each pair, in as few kernels as torch groups them."""
    if dsts:
        torch._foreach_copy_(dsts, srcs)


def _pool_bytes(dev, reserved_before: int) -> int:
    """The device memory a capture reserved: a private pool starts empty,
    so every block it holds is a segment reserved during the capture (a
    concurrent allocation on another thread can add to the figure)."""
    return max(int(torch.cuda.memory_reserved(dev) - reserved_before), 0)
