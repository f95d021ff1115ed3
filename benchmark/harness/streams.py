"""The client process: one connection per stream, each a closed loop that
sends its next statement when the last one's rows have arrived.

It is started with multiprocessing's spawn and imports the standard
library and harness.wire only, so client threads never take the
server's GIL and the process loads neither torch nor the program
(the parent checks the names it reports).

Protocol over the pipe: the parent sends (host, port, db, streams, sql);
the child connects every stream and answers "ready". During set-up the
parent sends ("run", k, sql): stream k's connection runs it and the child
answers ("ran", error or None), so set-up warms each connection's own
session. Then the parent sends ("go", t0, t_end, drain_s) in
time.monotonic() seconds (one clock for both processes); every stream
sends its first statement at t0 and no new one from t_end; a statement in
flight at t_end gets until t_end + drain_s. The child answers with its
records and its loaded top-level modules."""

from __future__ import annotations

import sys
import threading
import time


def _stream(client, tags, sql, t0, t_end, drain_s, out):
    while time.monotonic() < t0:
        time.sleep(min(0.001, max(0.0, t0 - time.monotonic())))
    for i, t in enumerate(tags):
        t_send = time.monotonic()
        if t_send >= t_end:
            return
        client.settimeout(max(1.0, t_end + drain_s - t_send))
        rows, err = None, None
        try:
            rows = client.query(sql[t])
        except Exception as e:  # noqa: BLE001 - a failed statement is a result
            err = f"{type(e).__name__}: {e}"
        out.append((i, t, t_send, time.monotonic(), rows, err))
        if err is not None and not err.startswith("ServerError"):
            return  # the connection is gone


def child_main(conn) -> None:
    from harness import wire

    host, port, db, streams, sql = conn.recv()
    clients = [wire.Client(host, port, db, timeout=600.0) for _ in streams]
    conn.send(("ready", len(clients)))
    while True:
        msg = conn.recv()
        if msg[0] == "go":
            break
        _, k, stmt = msg
        try:
            clients[k].query(stmt)
            conn.send(("ran", None))
        except Exception as e:  # noqa: BLE001 - the parent raises it
            conn.send(("ran", f"{type(e).__name__}: {e}"))
    _, t0, t_end, drain_s = msg
    outs = [[] for _ in streams]
    threads = [threading.Thread(target=_stream, args=(c, tags, sql, t0, t_end, drain_s, o),
                                name=f"stream-{k}")
               for k, (c, tags, o) in enumerate(zip(clients, streams, outs))]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    for c in clients:
        c.close()
    records = [(k, *r) for k, o in enumerate(outs) for r in o]
    modules = sorted({m.split(".")[0] for m in list(sys.modules)})
    conn.send(("done", records, modules))
    conn.close()
