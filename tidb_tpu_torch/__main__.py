"""tidb-server equivalent: boot the MySQL-protocol server from the CLI
(the port's copy of tidb_tpu/__main__.py).

    python -m tidb_tpu_torch [--host H] [--port P] [--config file.toml]
                             [--device {cuda,cpu}] [--mesh {auto,none}]
                             [--load-tpch SF] [--root-password PW]

Ref: tidb-server/main.go (flag parsing -> config merge -> bootstrap ->
Server.Run). Config file keys mirror the flags; explicit flags win.

The server runs on the CUDA card unless `--device cpu` asks for the
host; with no card it exits with an error. `--mesh auto` (the default)
builds a mesh over every visible card (with `--device cpu`, one CPU
shard) and hands it to every connection's Session, so reads run on the
mesh tier (parallel/), as the reference's server does; `--mesh none`
runs each statement on the one device. SIGINT drains the server and
exits 0.
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="tidb_tpu_torch", description=__doc__)
    ap.add_argument("--host", default=None, help="listen address (default 127.0.0.1)")
    ap.add_argument("--port", type=int, default=None, help="listen port (default 4000)")
    ap.add_argument("--status-port", type=int, default=None,
                    help="HTTP status/metrics port (default 10080; -1 disables)")
    ap.add_argument("--config", default=None, help="TOML config file")
    ap.add_argument("--mesh", choices=["auto", "none"], default=None,
                    help="auto: a mesh over every visible card (or the "
                         "one CPU with --device cpu); none: one device")
    ap.add_argument("--load-tpch", type=float, default=None, metavar="SF",
                    help="preload TPC-H tables at scale factor SF")
    ap.add_argument("--root-password", default=None,
                    help="set the root account password at boot")
    ap.add_argument("--plugin-modules", default=None,
                    help="comma-separated module path prefixes INSTALL "
                         "PLUGIN may import (default: none — SQL plugin "
                         "loading disabled on the server)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default=None,
                    help="where every session runs (default cuda; cpu "
                         "runs the plain PyTorch path on the host)")
    return ap.parse_args(argv)


def load_config(path):
    import tomllib

    with open(path, "rb") as f:
        return tomllib.load(f)


def main(argv=None) -> int:
    args = parse_args(argv if argv is not None else sys.argv[1:])
    cfg = load_config(args.config) if args.config else {}
    host = args.host or cfg.get("host", "127.0.0.1")
    port = args.port if args.port is not None else int(cfg.get("port", 4000))
    status_port = (args.status_port if args.status_port is not None
                   else int(cfg.get("status_port", 10080)))
    if status_port < 0:
        status_port = None
    mesh_mode = args.mesh or cfg.get("mesh", "auto")
    sf = args.load_tpch if args.load_tpch is not None else cfg.get("load_tpch")
    root_pw = (args.root_password if args.root_password is not None
               else cfg.get("root_password"))
    plugin_mods = (args.plugin_modules if args.plugin_modules is not None
                   else cfg.get("plugin_modules", ""))

    from tidb_tpu_torch.errors import ExecutionError
    from tidb_tpu_torch.server.server import Server
    from tidb_tpu_torch.storage.catalog import Catalog
    from tidb_tpu_torch.utils.device import resolve_device

    try:
        device = resolve_device(args.device or cfg.get("device", "cuda"))
    except ExecutionError as e:
        print(f"tidb_tpu_torch: {e}", file=sys.stderr)
        return 1
    mesh = None
    if mesh_mode == "auto":
        from tidb_tpu_torch.parallel import make_mesh

        mesh = make_mesh(devices=[device]) if device.type == "cpu" else make_mesh()
        print(f"# mesh {mesh}", file=sys.stderr)

    catalog = Catalog()
    # SQL-reachable plugin imports are allowlisted on the wire server
    catalog.plugins.allowed_prefixes = tuple(
        p.strip() for p in str(plugin_mods).split(",") if p.strip())
    if root_pw:
        catalog.set_password("root", root_pw)
    if sf:
        from tidb_tpu_torch.storage.tpch import load_tpch

        counts = load_tpch(catalog, sf=float(sf))
        print(f"# loaded TPC-H sf={sf}: {counts}", file=sys.stderr)

    server = Server(catalog=catalog, host=host, port=port,
                    status_port=status_port, device=device, mesh=mesh)
    server.start()
    if server.status_port is not None:
        print(f"# status port http://{server.host}:{server.status_port}"
              "/metrics /status /schema", file=sys.stderr)
    print(f"# tidb_tpu_torch server on {device} listening on "
          f"{server.host}:{server.port}", file=sys.stderr, flush=True)
    try:
        server._accept_thread.join()
    except KeyboardInterrupt:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
