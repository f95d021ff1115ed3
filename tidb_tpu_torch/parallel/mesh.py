"""The device mesh and its single-controller SPMD runner (counterpart of
tidb_tpu/parallel/mesh.py).

The reference places work on a ``jax.sharding.Mesh`` with two axes:

  * "shard": the data-partition axis (the region analogue). Scan and
    aggregation fragments run data-parallel over it; join exchanges run
    all_to_all over it.
  * "dcn": the multi-slice tier. Merges reduce over both axes.

and runs one per-shard program over every device inside one process
through ``shard_map``. The port keeps that model, one controller and one
Session, with no process group:

  * ``Mesh`` is a (dcn x shard) grid of ``torch.device``s. A device may
    appear more than once: ``make_mesh(n_shards=4, n_dcn=2,
    devices=[torch.device("cpu")] * 8)`` is the CPU tests' 8-shard mesh
    (the counterpart of ``--xla_force_host_platform_device_count=8``),
    and ``devices=[cuda:0] * 4`` runs four shards on one card.
  * A per-shard program is a Python generator function
    ``program(p, *args)``. Where the reference calls a collective
    (``jax.lax.psum(v, axes)``), the program yields one:
    ``v = yield psum(v)``. ``run_spmd`` runs every shard's generator up to
    its next yield, performs the collective over the shards' tensors and
    sends each shard its result, until every program returns.

Shards run one after another on one thread, so every launch reaches a
card in program order on its default stream: the segment kernel's ticket
and the probe kernel's scan words rely on that.

The collectives are plain tensor operations over the per-shard list: a
reduction on the first shard's device (int64 sums wrap mod 2^64, as
XLA's do), ``.to(device)`` copies between cards, and ``all_to_all``
(``recv[q][p] = send[p][q]``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch

from tidb_tpu_torch.errors import ExecutionError

__all__ = ["Mesh", "make_mesh", "shard_axis", "dcn_axis", "Collective",
           "psum", "pmin", "pmax", "all_to_all", "reduce_each", "run_spmd"]

shard_axis = "shard"
dcn_axis = "dcn"


class Mesh:
    """A (dcn, shard) grid of devices; part p is row-major index p."""

    def __init__(self, grid: Sequence[Sequence]):
        if not grid or not grid[0] or any(len(r) != len(grid[0]) for r in grid):
            raise ValueError("a mesh needs a non-empty rectangular device grid")
        self.shape = {dcn_axis: len(grid), shard_axis: len(grid[0])}
        self.devices: List[torch.device] = [torch.device(d) for row in grid for d in row]

    @property
    def n_parts(self) -> int:
        return len(self.devices)

    def device_of(self, p: int) -> torch.device:
        return self.devices[p]

    @property
    def distinct_devices(self) -> List[torch.device]:
        """The mesh's devices, each once, in part order."""
        return list(dict.fromkeys(self.devices))

    @property
    def single_device(self) -> Optional[torch.device]:
        """The device every part lies on, or None for a mesh over several
        devices."""
        devs = self.distinct_devices
        return devs[0] if len(devs) == 1 else None

    def __repr__(self) -> str:
        return (f"Mesh(dcn={self.shape[dcn_axis]}, shard={self.shape[shard_axis]}, "
                f"devices={[str(d) for d in self.devices]})")


def make_mesh(n_shards: Optional[int] = None, n_dcn: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (dcn, shard) mesh. `devices` defaults to every visible
    CUDA card; with no card that raises (pass `devices` to mesh the
    CPU)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise ExecutionError(
                "no CUDA device is available for the mesh; pass "
                "devices=[torch.device('cpu')] * n to mesh the host")
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
    if n_shards is None:
        n_shards = len(devs) // n_dcn
    total = n_dcn * n_shards
    if total <= 0 or total > len(devs):
        raise ValueError(
            f"mesh {n_dcn}x{n_shards} needs {total} devices, have {len(devs)}")
    return Mesh([devs[r * n_shards:(r + 1) * n_shards] for r in range(n_dcn)])


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

Ops = Union[str, Dict[str, str]]


@dataclass
class Collective:
    """One collective request of a per-shard program. `value` is a tensor
    or a dict of tensors; `op` is "sum", "min", "max" or "all_to_all", or
    a dict of per-key reduction ops for a dict value (merge_state)."""

    op: Ops
    value: object


def psum(v) -> Collective:
    return Collective("sum", v)


def pmin(v) -> Collective:
    return Collective("min", v)


def pmax(v) -> Collective:
    return Collective("max", v)


def all_to_all(v) -> Collective:
    """Each shard's value is [P, cap] (a tensor or a dict of them): row q
    goes to shard q. Each shard receives [P, cap], row p from shard p."""
    return Collective("all_to_all", v)


def reduce_each(ops: Dict[str, str], v: Dict[str, torch.Tensor]) -> Collective:
    """One request reducing each entry of `v` by its own op."""
    return Collective(dict(ops), v)


def _reduce(op: str, parts: List[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    dev0 = parts[0].device
    acc = parts[0]
    for t in parts[1:]:
        t = t.to(dev0)
        if op == "sum":
            acc = acc + t  # int64 wraps mod 2^64, as XLA's psum does
        elif op == "min":
            acc = torch.minimum(acc, t)
        elif op == "max":
            acc = torch.maximum(acc, t)
        else:
            raise ExecutionError(f"unknown collective reduction {op!r}")
    return [acc.to(mesh.device_of(p)) for p in range(mesh.n_parts)]


def _exchange(parts: List[torch.Tensor], mesh: Mesh) -> List[torch.Tensor]:
    P = mesh.n_parts
    for t in parts:
        if t.shape[0] != P:
            raise ExecutionError(f"all_to_all: expected [{P}, cap] sends, got "
                                 f"{tuple(t.shape)}")
    out = []
    for q in range(P):
        dev = mesh.device_of(q)
        out.append(torch.stack([parts[p][q].to(dev) for p in range(P)]))
    return out


def _perform(mesh: Mesh, reqs: List[Collective]) -> list:
    op = reqs[0].op
    vals = [r.value for r in reqs]
    if isinstance(vals[0], dict):
        keys = list(vals[0])
        per_key = {}
        for k in keys:
            parts = [v[k] for v in vals]
            kop = op[k] if isinstance(op, dict) else op
            per_key[k] = (_exchange(parts, mesh) if kop == "all_to_all"
                          else _reduce(kop, parts, mesh))
        return [{k: per_key[k][p] for k in keys} for p in range(mesh.n_parts)]
    if op == "all_to_all":
        return _exchange(vals, mesh)
    return _reduce(op, vals, mesh)


def run_spmd(mesh: Mesh, program: Callable, args: Sequence[tuple]) -> list:
    """Run `program(p, *args[p])` for every part p of `mesh` to its
    return value, performing each collective the programs yield. Every
    program must yield the same sequence of collectives (SPMD)."""
    P = mesh.n_parts
    if len(args) != P:
        raise ExecutionError(f"run_spmd: {len(args)} argument tuples for {P} parts")
    gens = [program(p, *args[p]) for p in range(P)]
    sends: list = [None] * P
    while True:
        reqs, results = [], []
        for g, s in zip(gens, sends):
            try:
                reqs.append(g.send(s))
            except StopIteration as stop:
                results.append(stop.value)
        if results:
            if len(results) != P:
                raise ExecutionError("SPMD programs diverged: some parts returned "
                                     "while others wait in a collective")
            return results
        sig = {(repr(r.op), tuple(sorted(r.value)) if isinstance(r.value, dict)
                else None) for r in reqs}
        if len(sig) != 1:
            raise ExecutionError(f"SPMD programs diverged at a collective: {sig}")
        sends = _perform(mesh, reqs)
