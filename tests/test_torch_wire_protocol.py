"""The port's DCN wire-protocol model and runtime wire witness on the CPU.

  * the committed model (tidb_tpu_torch/analysis/wire_protocol.json) and
    its rendered reference (WIRE_PROTOCOL.md beside it) equal a fresh
    extraction of the port's parallel/dcn.py and sharding/shuffle.py,
    and `python -m tidb_tpu_torch.analysis --gen-wire --check` agrees;
  * its commands, envelope and fields equal the reference's committed
    model (tidb_tpu/analysis/wire_protocol.json); the senders differ only
    where the port's code does (listed below);
  * the wire witness (sanitizer.note_wire_msg, called by dcn._send) types
    an unknown cmd, an unknown field and a missing required field, and a
    sanitized two-worker CPU fleet (a shuffle join, 2PC writes, a fault
    mid-shuffle and at commit, recovery) sends nothing the model lacks.
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from test_torch_dcn import feedback_stores_cleared  # noqa: F401 (autouse)
from test_torch_session import reference_witness_paused  # noqa: F401
from tidb_tpu_torch.analysis import sanitizer as san
from tidb_tpu_torch.analysis.core import Driver, Project
from tidb_tpu_torch.analysis.wire_protocol import (
    DOC_REL_PATH,
    MODEL_REL_PATH,
    ProtocolConformancePass,
    extract_model,
    render_markdown,
    to_wire_model,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (cmd, sender fn) pairs of one model and not the other: the port's
# gated broadcast sends its own exec, and the port's load_sharded sends
# load_columns and place_shards from a nested `load_one` (one thread per
# worker) where the reference's sends them itself.
PORT_ONLY_SENDERS = {("exec", "Cluster._broadcast_gated"),
                     ("load_columns", "Cluster.load_one"),
                     ("place_shards", "Cluster.load_one")}
REFERENCE_ONLY_SENDERS = {("load_columns", "Cluster.load_sharded"),
                          ("place_shards", "Cluster.load_sharded")}
# the one field the port sends and the reference does not: a paged
# partial's attempt number, which the coordinator sets at both senders and
# _call_retry raises on a retry (the envelope's sent fields list it), so a
# worker ranks a token's attempts whatever order their threads arrive in
PORT_ONLY_FIELD = "attempt"
PORT_ONLY_FIELD_CMDS = {"partial_paged", "shuffle_gather"}


def _reference_fields(cmd, entry):
    """The port's entry for `cmd` with the port-only field taken out."""
    if cmd not in PORT_ONLY_FIELD_CMDS:
        return entry

    def drop(e):
        return {k: ([f for f in v if f != PORT_ONLY_FIELD] if isinstance(v, list) else v)
                for k, v in e.items()}

    return {"handler": drop(entry["handler"]),
            "senders": [drop(x) for x in entry["senders"]]}


@pytest.fixture(scope="module")
def wire():
    return to_wire_model(extract_model(Project(ROOT)))


@pytest.fixture(scope="module")
def reference_model():
    with open(os.path.join(ROOT, "tidb_tpu", "analysis", "wire_protocol.json"),
              encoding="utf-8") as f:
        return json.load(f)


@pytest.fixture()
def clean_sanitizer():
    san.disable()
    yield
    san.disable()


def _wire_findings():
    return [f for f in san.report()["findings"] if f["kind"].startswith("wire-")]


class TestCommittedModel:
    def test_paths_are_the_ports(self):
        assert MODEL_REL_PATH == "tidb_tpu_torch/analysis/wire_protocol.json"
        assert DOC_REL_PATH == "tidb_tpu_torch/analysis/WIRE_PROTOCOL.md"

    def test_committed_model_matches_fresh_extraction(self, wire):
        with open(os.path.join(ROOT, MODEL_REL_PATH), encoding="utf-8") as f:
            assert json.load(f) == wire, "run python -m tidb_tpu_torch.analysis --gen-wire"
        with open(os.path.join(ROOT, DOC_REL_PATH), encoding="utf-8") as f:
            assert f.read() == render_markdown(wire)

    def test_gen_wire_check_mode(self):
        proc = subprocess.run([sys.executable, "-m", "tidb_tpu_torch.analysis",
                               "--gen-wire", "--check"],
                              capture_output=True, text=True, cwd=ROOT, timeout=120)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "fresh" in proc.stdout

    def test_model_is_line_number_free(self, wire):
        text = json.dumps(wire)
        assert '"line"' not in text and '"path"' not in text

    def test_pass_is_clean_with_the_health_arm_suppressed(self):
        reports = Driver(ROOT, [ProtocolConformancePass()]).run()
        rep = [r for r in reports if r.pass_id == "protocol-conformance"][0]
        assert not rep.violations, [v.render() for v in rep.violations]
        assert len(rep.suppressed) == 1 and "health" in rep.suppressed[0][1].reason

    def test_every_wire_message_names_its_fields(self):
        """The encode-once load writes its fields out (no **-expansion a
        static model cannot read)."""
        model = extract_model(Project(ROOT))
        loads = [s for s in model.senders if s.cmd == "load_columns"]
        assert loads and all({"arrays", "valids", "strings"} <= s.fields() for s in loads)


class TestAgainstTheReference:
    def test_cmds_and_envelope_equal(self, wire, reference_model):
        assert set(wire["cmds"]) == set(reference_model["cmds"])
        env = dict(wire["envelope"])
        assert PORT_ONLY_FIELD in env["sent"]
        env["sent"] = [f for f in env["sent"] if f != PORT_ONLY_FIELD]
        assert env == reference_model["envelope"]
        assert wire["schema"] == reference_model["schema"]

    def test_fields_equal(self, wire, reference_model):
        for cmd, ref in reference_model["cmds"].items():
            if cmd in PORT_ONLY_FIELD_CMDS:
                assert PORT_ONLY_FIELD in wire["cmds"][cmd]["handler"]["optional"], cmd
                assert all(PORT_ONLY_FIELD in s["required"]
                           for s in wire["cmds"][cmd]["senders"]
                           if s["fn"] != "Worker._handle"), cmd
            got = _reference_fields(cmd, wire["cmds"][cmd])
            assert got["handler"] == ref["handler"], cmd

            def sent(e):
                return {f for s in e["senders"] for k in ("required", "optional")
                        for f in s[k]}

            assert sent(got) == sent(ref), cmd

    def test_sender_differences_are_the_listed_ones(self, wire, reference_model):
        def senders(m):
            return {(c, s["fn"]) for c, e in m["cmds"].items() for s in e["senders"]}

        port, ref = senders(wire), senders(reference_model)
        assert port - ref == PORT_ONLY_SENDERS
        assert ref - port == REFERENCE_ONLY_SENDERS


class TestWireWitnessUnit:
    def test_unknown_cmd_field_and_missing_required(self, clean_sanitizer):
        san.enable()
        san.note_wire_msg({"cmd": "made_up_cmd", "x": 1})
        san.note_wire_msg({"cmd": "fetch", "cursor": 1, "offset": 0, "bogus": 2})
        san.note_wire_msg({"cmd": "fetch", "cursor": 1})
        kinds = [(f["kind"], f["subject"]) for f in _wire_findings()]
        assert ("wire-unknown-cmd", "made_up_cmd") in kinds
        assert ("wire-unknown-field", "fetch.bogus") in kinds
        assert ("wire-missing-field", "fetch.offset") in kinds

    def test_clean_and_non_request_frames_ignored(self, clean_sanitizer):
        san.enable()
        san.note_wire_msg({"cmd": "exec", "sql": "select 1", "trace_id": "t"})
        san.note_wire_msg({"ok": True, "result": 3})
        san.note_wire_msg([1, 2, 3])
        san.note_wire_msg({"cmd": "exec", "sql": "x", "_deadline_mono": 1.0})
        assert not _wire_findings(), _wire_findings()

    def test_the_model_loaded_is_the_ports(self, clean_sanitizer):
        san.set_wire_model(None)
        assert san._WIRE_MODEL_PATH == os.path.join(ROOT, MODEL_REL_PATH)
        assert san.wire_model()["cmds"].keys() >= {"load_columns", "exec", "fetch"}

    def test_unloadable_model_is_witnessed_not_silent(self, clean_sanitizer, monkeypatch):
        monkeypatch.setattr(san, "_WIRE_MODEL_PATH", "/nonexistent/wire_protocol.json")
        monkeypatch.setitem(san._WIRE, "loaded", False)
        monkeypatch.setitem(san._WIRE, "model", None)
        san.enable()
        san.note_wire_msg({"cmd": "exec", "sql": "x"})
        san.note_wire_msg({"cmd": "exec", "sql": "y"})
        fs = [f for f in san.report()["findings"] if f["kind"] == "wire-model-unavailable"]
        assert len(fs) == 1 and not fs[0]["fatal"], fs
        san.set_wire_model(None)


def _fleet(n_workers=2):
    from tidb_tpu_torch.parallel.dcn import Cluster, Worker

    workers = [Worker(device="cpu") for _ in range(n_workers)]
    for w in workers:
        threading.Thread(target=w.serve_forever, daemon=True).start()
    cl = Cluster([("127.0.0.1", w.port) for w in workers], device="cpu",
                 rpc_timeout_s=30.0, connect_timeout_s=10.0)
    cl.ddl("create table f (k bigint, v bigint) shard by hash(k) shards 4")
    cl.ddl("create table d (k bigint, grp bigint) shard by hash(grp) shards 2")
    ks = np.arange(120, dtype=np.int64)
    cl.load_sharded("f", arrays={"k": ks, "v": ks * 3})
    dk = ks[::2]
    cl.load_sharded("d", arrays={"k": dk, "grp": dk % 5})
    return workers, cl


JOIN_SQL = ("select d.grp, count(*) as n, sum(f.v) as sv from f "
            "join d on f.k = d.k group by d.grp order by d.grp")


class TestWireWitnessFleet:
    def test_sanitized_fleet_is_wire_clean(self, clean_sanitizer):
        from tidb_tpu_torch.errors import TiDBTPUError
        from tidb_tpu_torch.utils.failpoint import FailpointError, failpoint

        san.enable()
        _workers, cl = _fleet()
        try:
            baseline = cl.query(JOIN_SQL)
            assert baseline
            cl.execute_dml("insert into f (k, v) values (500, 1), (501, 2)")
            with failpoint("shuffle.send", times=1):
                try:
                    cl.query(JOIN_SQL)
                except (TiDBTPUError, ConnectionError, OSError, FailpointError):
                    pass
            with failpoint("2pc.commit", times=1):
                try:
                    cl.execute_dml("update f set v = v + 1 where k = 500")
                except (TiDBTPUError, ConnectionError, OSError, FailpointError):
                    pass
            cl.recover_txns()
            assert not cl._txn_pending and not cl._txn_decided
            assert cl.query(JOIN_SQL) == baseline
        finally:
            cl.shutdown()
        assert not _wire_findings(), _wire_findings()

    def test_unmodeled_cmd_is_witnessed(self, clean_sanitizer):
        from tidb_tpu_torch.errors import ExecutionError
        from tidb_tpu_torch.parallel.dcn import Cluster, Worker

        san.enable()
        w = Worker(device="cpu")
        threading.Thread(target=w.serve_forever, daemon=True).start()
        cl = Cluster([("127.0.0.1", w.port)], device="cpu", rpc_timeout_s=10.0)
        try:
            with pytest.raises(ExecutionError):
                cl._call(0, {"cmd": "definitely_not_modeled"})
        finally:
            cl.shutdown()
        kinds = [(f["kind"], f["subject"]) for f in _wire_findings()]
        assert ("wire-unknown-cmd", "definitely_not_modeled") in kinds
