"""Engine invariant analyzer: AST lint passes over tidb_tpu_torch/ (the
port's counterpart of tidb_tpu/analysis/).

The engine rests on a handful of code invariants nothing else enforces:

  * what must be built once is never built per call: kernel libraries
    load only through ops/nvcc_build.py's cache, and no CUDA graph,
    torch.jit or torch.compile program is made inside a function
  * hot paths must not silently sync the host: the sanctioned
    device→host fetch is ``utils.dispatch.device_get``; any other sync
    on the execution tiers carries ``# host-sync: <reason>``
  * the multi-threaded DCN/coordinator layer must keep a cycle-free
    lock-acquisition order and never mutate shared state unlocked
  * every acquired resource (pins, tracker charges, cursors, staging
    generators, failpoint arms) must reach its release on every path
    (resource-lifecycle)
  * no registered lock may be held across a blocking call — waits,
    device fetches, socket/file I/O, tracker consume
    (blocking-under-lock)
  * every registry (metrics, failpoints, sysvars) must stay covered
  * errors must stay typed, coded, and never silently swallowed
  * the DCN dict wire protocol's senders and handler arms must agree
    on cmds and fields, worker re-sends must propagate the statement
    envelope, and the committed protocol model must match a fresh
    extraction (protocol-conformance; the runtime wire witness in
    sanitizer.py diffs real traffic against the model)
  * every value a cached program closes over must be named in its
    cache key (cache-key-completeness)

``python -m tidb_tpu_torch.analysis`` drives the passes (``--json`` for
the machine-readable report, ``--changed <paths>`` for diff lints,
``--gen-wire`` to regenerate the protocol model). Suppressions require
an inline reason:

    # lint: disable=<pass>[,<pass>] -- <reason>            (line scope)
    # lint: module-disable=<pass> -- <reason>              (file scope)
    # host-sync: <reason>           (host-sync pass only; the annotated
                                     allowlist of intentional syncs)
    # lifecycle: <reason>           (resource-lifecycle pass only; a
                                     documented ownership handoff)

A suppression with no reason is itself a violation, and every
suppression is counted and reported so the allowlist stays visible.

The runtime half lives in ``analysis/sanitizer.py``: a debug-mode
witness behind ``tidb_tpu_sanitize`` that records lock orders,
tracker/pin balances, and per-statement host-sync counts, and
cross-checks them against the static model (README "Sanitizer mode").

Importing this package loads neither torch nor jax.
"""

from tidb_tpu_torch.analysis.core import (  # noqa: F401
    Driver,
    Project,
    Violation,
    all_passes,
)
