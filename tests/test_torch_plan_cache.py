"""The port's digest-keyed plan cache (tidb_tpu_torch/planner/plancache.py)
held to the reference's: the sequences of tests/test_plan_cache.py run
through a tidb_tpu Session and a tidb_tpu_torch Session (plain PyTorch on
the CPU), step by step. After every step both must return the same rows
and the same @@last_plan_from_cache, so hits and misses match statement
by statement, through invalidation by DDL, ANALYZE and DML. The reference
plans with the port's key-domain join estimate
(test_torch_scale.reference_key_domain)."""

import pytest
import torch

from tidb_tpu.session import Session as JaxSession
from tidb_tpu_torch.session import Session
from test_torch_scale import reference_key_domain
from test_torch_session import reference_witness_paused  # noqa: F401 (autouse)

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def reference_under_key_domain():
    """The reference plans with the port's key-domain join estimate (ROADMAP,
    known divergences): a join's plan, and so whether a cached plan is
    reused for new parameters, follows the rule."""
    with reference_key_domain():
        yield

_PC = ("CREATE TABLE pc (id bigint primary key, v bigint, name varchar(20))",
       "INSERT INTO pc VALUES " + ",".join(
           f"({i},{i * 10},'n{i}')" for i in range(64)))
_NPC = ("SET tidb_enable_non_prepared_plan_cache = 1",)
_O = ("CREATE TABLE o (oid bigint primary key, tid bigint, amt bigint)",
      "INSERT INTO o VALUES " + ",".join(
          f"({i},{i % 8},{i * 7})" for i in range(64)))
_FX = ("CREATE TABLE fx (id bigint primary key, x bigint)",
       "INSERT INTO fx VALUES (1,-10),(2,0),(3,5),(4,10)")


def _warm(name="p"):
    return [("prep", name, "select v from pc where id = ?"),
            ("exec", name, [1]), ("exec", name, [2])]


# each case: (setup statements, steps). A step is ("sql", text),
# ("prep", name, text) or ("exec", name, params).
SEQUENCES = {
    "prepared_reuse": (_PC, [
        ("prep", "p", "select v from pc where id = ?"),
        ("exec", "p", [3]), ("exec", "p", [7]), ("exec", "p", [11])]),
    "last_plan_from_cache_select": (_PC, _warm() + [
        ("sql", "select @@last_plan_from_cache")]),
    "prepared_and_text_share_digest": (_PC + _NPC, [
        ("sql", "select v from pc where id = 5"),
        ("prep", "p", "select v from pc where id = ?"), ("exec", "p", [6])]),
    "no_ast_leak": (_PC, [
        ("prep", "p", "select id from pc where id in (?, ?) order by id"),
        ("exec", "p", [1, 2]), ("exec", "p", [3, 4]), ("exec", "p", [1, 2])]),
    "non_prepared_off_by_default": (_PC, [
        ("sql", "select v from pc where id = 1"),
        ("sql", "select v from pc where id = 2")]),
    "non_prepared_new_literals": (_PC + _NPC, [
        ("sql", "select v from pc where id = 1"),
        ("sql", "select v from pc where id = 2"),
        ("sql", "select id from pc where id between 10 and 12 order by id limit 2"),
        ("sql", "select id from pc where id between 20 and 30 order by id limit 3")]),
    "toggle_non_prepared_off": (_PC + _NPC, [
        ("sql", "select v from pc where id = 1"),
        ("sql", "select v from pc where id = 2"),
        ("sql", "SET tidb_enable_non_prepared_plan_cache = 0"),
        ("sql", "select v from pc where id = 3")]),
    "prepared_cache_off": (_PC + ("SET tidb_enable_prepared_plan_cache = 0",),
                           _warm()),
    "alter_table_evicts": (_PC, _warm() + [
        ("sql", "ALTER TABLE pc ADD COLUMN extra bigint"),
        ("exec", "p", [3]), ("exec", "p", [4])]),
    "drop_create_evicts": (_PC, _warm() + [
        ("sql", "DROP TABLE pc"),
        ("sql", "CREATE TABLE pc (id bigint primary key, v bigint)"),
        ("sql", "INSERT INTO pc VALUES (1, 111)"),
        ("sql", "select v from pc where id = 1")]),
    "create_index_evicts": (_PC, _warm() + [
        ("sql", "CREATE INDEX ix_v ON pc (v)"), ("exec", "p", [5])]),
    "analyze_evicts": (_PC, _warm() + [
        ("sql", "ANALYZE TABLE pc"), ("exec", "p", [3]), ("exec", "p", [4])]),
    "dml_after_analyze": (_PC + ("ANALYZE TABLE pc",), _warm() + [
        ("sql", "INSERT INTO pc VALUES (100, 1000, 'x')"),
        ("exec", "p", [100]), ("exec", "p", [100])]),
    "plan_time_subquery": (_PC + _NPC, [
        ("sql", "select id from pc where v = (select max(v) from pc)"),
        ("sql", "INSERT INTO pc VALUES (500, 99999, 'big')"),
        ("sql", "select id from pc where v = (select max(v) from pc)")]),
    "string_predicates": (_PC + _NPC, [
        ("sql", "select id from pc where name = 'n3'"),
        ("sql", "select id from pc where name = 'n7'")]),
    "locking_read": (_PC + _NPC, [
        ("sql", "BEGIN"), ("sql", "select v from pc where id = 1 for update"),
        ("sql", "COMMIT")]),
    "volatile_builtin": (_PC + _NPC, [
        ("sql", "select count(*) from pc where id >= 0 and now() > '2000-01-01'"),
        ("sql", "select count(*) from pc where id >= 0 and now() > '2000-01-01'")]),
    "foldable_param": (_PC + _FX, [
        ("prep", "a", "select id from fx where x > abs(?)"),
        ("exec", "a", [5]), ("exec", "a", [-7]),
        ("prep", "g", "select id from fx where x > greatest(?, 3)"),
        ("exec", "g", [5]), ("exec", "g", [-99])]),
    "join_reuse": (_PC + _O, [
        ("prep", "j", "select pc.id, sum(o.amt) as sa from pc join o on "
                      "pc.id = o.tid where pc.id < ? group by pc.id "
                      "order by pc.id"),
        ("exec", "j", [8]), ("exec", "j", [3])]),
    "aggregate_zero_params": (_PC + _NPC, [
        ("sql", "select count(*), sum(v) from pc"),
        ("sql", "select count(*), sum(v) from pc"),
        ("sql", "INSERT INTO pc VALUES (900, 9000, 'z')"),
        ("sql", "select count(*), sum(v) from pc")]),
    "union_reuse": (_PC + _NPC, [
        ("sql", "select id from pc where id = 1 union all "
                "select id from pc where id = 2 order by id"),
        ("sql", "select id from pc where id = 5 union all "
                "select id from pc where id = 9 order by id")]),
    "covered_pointget_refused": (_PC, [
        ("prep", "p", "select v from pc where id = ? and id = ?"),
        ("exec", "p", [5, 5]), ("exec", "p", [5, 6]), ("exec", "p", [6, 6])]),
    "tiny_capacity_evicts": (_PC + _NPC + (
        "SET GLOBAL tidb_prepared_plan_cache_size = 2",), [
        ("sql", f"select v as col{k} from pc where id = 1") for k in range(6)]),
}


def _run(session, setup, steps):
    """Each step's (rows, @@last_plan_from_cache) and the cache's final
    (size, hits, misses, evictions) and per-entry cacheability."""
    for sql in setup:
        session.execute(sql)
    prepared, out = {}, []
    for step in steps:
        if step[0] == "prep":
            prepared[step[1]] = session.prepare(step[2])[0]
            continue
        rs = (session.execute(step[1]) if step[0] == "sql"
              else session.execute_prepared(prepared[step[1]], step[2]))
        out.append((None if rs is None else rs.rows,
                    bool(session.sysvars.get("last_plan_from_cache"))))
    pc = session.catalog.plan_cache
    entries = sorted((e.digest, e.patches is not None, e.hits)
                     for e in pc._od.values())
    return out, (len(pc), pc.hits, pc.misses, pc.evictions), entries


@pytest.mark.parametrize("case", sorted(SEQUENCES))
def test_hits_and_misses_match_reference(case):
    setup, steps = SEQUENCES[case]
    want = _run(JaxSession(), setup, steps)
    got = _run(Session(device="cpu"), setup, steps)
    assert got[0] == want[0]
    assert got[1:] == want[1:]


def test_sessions_share_the_instance_cache():
    got = []
    for make in (JaxSession, lambda: Session(device="cpu")):
        a = make()
        a.execute("CREATE TABLE shared (id bigint primary key, v bigint)")
        a.execute("INSERT INTO shared VALUES (1, 10), (2, 20)")
        sid, _ = a.prepare("select v from shared where id = ?")
        a.execute_prepared(sid, [1])
        b = type(a)(catalog=a.catalog, **({} if make is JaxSession
                                          else {"device": "cpu"}))
        sid_b, _ = b.prepare("select v from shared where id = ?")
        got.append((b.execute_prepared(sid_b, [2]).rows,
                    bool(b.sysvars.get("last_plan_from_cache"))))
    assert got[0] == got[1] == ([(20,)], True)


def test_point_get_entry_patches_its_key():
    """The OLTP shape the cache exists for: the cached plan is a
    PointGet whose key is a verified patch slot, in both packages."""
    from tidb_tpu.planner.physical import PPointGet as JPG
    from tidb_tpu_torch.planner.physical import PPointGet

    def find(p, cls):
        if isinstance(p, cls):
            return p
        return next((r for c in p.children
                     if (r := find(c, cls)) is not None), None)

    for make, cls in ((JaxSession, JPG),
                      (lambda: Session(device="cpu"), PPointGet)):
        s = make()
        for sql in _PC:
            s.execute(sql)
        sid, _ = s.prepare("select v from pc where id = ?")
        s.execute_prepared(sid, [1])
        (entry,) = s.catalog.plan_cache._od.values()
        assert find(entry.phys, cls) is not None
        assert entry.patches
        assert s.execute_prepared(sid, [9]).rows == [(90,)]


def test_slot_order_matches_reference():
    """analyze_statement / analyze_template / transform_literals agree
    with the reference's on literal-slot order (the patch map is
    positional)."""
    from tidb_tpu.parser import parse as jparse
    from tidb_tpu.planner import plancache as jpc
    from tidb_tpu_torch.parser import parse
    from tidb_tpu_torch.planner import plancache as pc
    from tidb_tpu_torch.session.session import _sub_params

    sql = ("select id, v from pc where id in (1, 2) and v between 3 and 4"
           " and name = 'x' union all select id, v from pc where id = 7"
           " order by 1 limit 5 offset 6")
    info, jinfo = (pc.analyze_statement(parse(sql)[0]),
                   jpc.analyze_statement(jparse(sql)[0]))
    assert (info.params, info.kinds, info.struct) == (
        jinfo.params, jinfo.kinds, jinfo.struct)
    tsql = ("select v from pc where id = ? and v in (?, 9)"
            " and name = ? limit 2")
    stmt = parse(tsql)[0]
    fast = pc.bind_template_params(pc.analyze_template(stmt), [5, 7, "abc"])
    slow = pc.analyze_statement(_sub_params(stmt, [5, 7, "abc"]))
    assert (fast.params, fast.kinds, fast.struct) == (
        slow.params, slow.kinds, slow.struct)
