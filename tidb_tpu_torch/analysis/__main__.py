"""Engine invariant analyzer CLI for the port:
``python -m tidb_tpu_torch.analysis [--json] [--pass NAME] [--list]
[--syncs] [--changed PATH...] [--gen-wire [--check]] [--root DIR]``.

Runs the AST lint passes of this package over ``<root>/tidb_tpu_torch``:

  jit-hygiene          kernel libraries load only through
                       ops/nvcc_build.py; no CUDA graph / torch.jit /
                       torch.compile built per call
  host-sync            no silent device→host syncs on the execution
                       tiers; the sanctioned fetch is dispatch.device_get
  lock-discipline      lock-order cycles, mixed locked/unlocked writes
  resource-lifecycle   acquires (pins/charges/cursors/arms) reach their
                       release on every path
  blocking-under-lock  no registered lock held across a blocking call
  protocol-conformance DCN wire protocol: senders/handler arms agree on
                       cmds+fields, worker re-sends carry the envelope,
                       the committed model (wire_protocol.json) is fresh
  cache-key-completeness every value a cached_jit/get_fragment/
                       get_or_build body closes over is named in its key
  metrics-coverage     /metrics collectors rendered + documented
  failpoint-coverage   no dead/armed-but-siteless failpoints
  sysvar-coverage      tidb_* sysvars registered, read, documented
  error-shape          no bare/swallowing excepts; errors carry codes

Exit 0 only with zero unsuppressed violations. Suppressions need an
inline reason (`# lint: disable=<pass> -- <reason>`, or
`# host-sync: <reason>` / `# lifecycle: <reason>`) and are counted in
the report. ``--json`` emits the machine-readable report (the
reference's schema); ``--changed`` lints only the given repo-relative
files with the AST passes. ``--gen-wire`` regenerates the committed
protocol model (``tidb_tpu_torch/analysis/wire_protocol.json``) and its
rendered reference (``tidb_tpu_torch/analysis/WIRE_PROTOCOL.md``) from
``parallel/dcn.py``; with ``--check`` it writes nothing and exits 1 when
either is stale.

Importing this package loads neither torch nor jax: the analyzer is
ast + stdlib (the metrics pass imports only the stdlib-only
``utils.metrics``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def gen_wire(root: str, check: bool) -> int:
    from tidb_tpu_torch.analysis import wire_protocol as wp
    from tidb_tpu_torch.analysis.core import Project

    wire = wp.to_wire_model(wp.extract_model(Project(root)))
    targets = [
        (os.path.join(root, wp.MODEL_REL_PATH),
         json.dumps(wire, indent=2, sort_keys=True) + "\n"),
        (os.path.join(root, wp.DOC_REL_PATH), wp.render_markdown(wire)),
    ]
    if check:
        stale = []
        for path, want in targets:
            try:
                with open(path, encoding="utf-8") as f:
                    have = f.read()
            except OSError:
                have = None
            if have != want:
                stale.append(os.path.relpath(path, root))
        if stale:
            print("stale wire-protocol artifacts: " + ", ".join(stale)
                  + " (run python -m tidb_tpu_torch.analysis --gen-wire)")
            return 1
        print("wire-protocol artifacts are fresh")
        return 0
    for path, text in targets:
        with open(path, "w", encoding="utf-8") as f:
            f.write(text)
        print(f"wrote {os.path.relpath(path, root)}")
    return 0


def main(argv=None) -> int:
    from tidb_tpu_torch.analysis import core

    ap = argparse.ArgumentParser(prog="python -m tidb_tpu_torch.analysis")
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--pass", dest="passes", action="append", default=None,
                    metavar="NAME", help="run only the named pass(es)")
    ap.add_argument("--list", action="store_true",
                    help="list available passes and exit")
    ap.add_argument("--syncs", action="store_true",
                    help="also print the annotated intentional host-sync "
                         "and lifecycle-handoff tables")
    ap.add_argument("--json", action="store_true",
                    help="emit the machine-readable report as JSON")
    ap.add_argument("--changed", nargs="+", default=None, metavar="PATH",
                    help="lint only these repo-relative files with the "
                         "AST passes")
    ap.add_argument("--gen-wire", action="store_true",
                    help="regenerate the committed wire-protocol model "
                         "and its rendered reference")
    ap.add_argument("--check", action="store_true",
                    help="with --gen-wire: write nothing, exit 1 on drift")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)

    if args.gen_wire:
        return gen_wire(root, args.check)
    passes = core.all_passes()
    if args.list:
        for p in passes:
            print(f"{p.id:20s} {p.doc}")
        return 0
    if args.passes:
        known = {p.id for p in passes}
        unknown = [n for n in args.passes if n not in known]
        if unknown:
            print(f"unknown pass(es): {', '.join(unknown)} "
                  f"(have: {', '.join(sorted(known))})")
            return 2
        passes = [p for p in passes if p.id in args.passes]
    if args.changed is not None and not args.passes:
        # a changed subset cannot prove registry coverage either way:
        # run only the file-scoped AST passes over the diff
        passes = [p for p in passes if p.id in core.AST_PASS_IDS]

    driver = core.Driver(root, passes, changed=args.changed)
    reports = driver.run()
    if args.json:
        print(json.dumps(driver.to_json(reports), indent=2, sort_keys=True))
        return 0 if not any(r.violations or r.problems
                            for r in reports) else 1
    text, rc = driver.render(reports)
    print(text)
    if args.syncs:
        from tidb_tpu_torch.analysis.host_sync import annotated_sites
        from tidb_tpu_torch.analysis.resource_lifecycle import lifecycle_sites

        print("\nannotated intentional host syncs:")
        for rel, line, reason in annotated_sites(driver.project):
            print(f"  {rel}:{line}  {reason}")
        print("\nannotated lifecycle handoffs:")
        for rel, line, reason in lifecycle_sites(driver.project):
            print(f"  {rel}:{line}  {reason}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
