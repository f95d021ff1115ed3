"""Authorization: the privilege matrix + checks at statement dispatch.

Ref counterpart: privilege/privileges.go MySQLPrivilege — the reference
loads mysql.user / mysql.db / mysql.tables_priv into an in-memory
matrix consulted by RequestVerification at plan/execute time. Here the
matrix lives in the catalog (the meta owner) at three scopes:

    global  (*.*)       db  (db.*)       table  (db.table)

A privilege check passes if the named priv — or ALL — appears at any
enclosing scope. `root` is the bootstrap superuser and bypasses checks,
like the reference's skip-grant bootstrap session.

DDL/admin statements map to privilege kinds the way MySQL does
(CREATE/DROP/ALTER/INDEX on the schema object; SUPER for user
administration, GRANT/REVOKE, global sysvars, and plugin management).
Views are expanded at bind time, so a SELECT through a view checks the
underlying tables (MySQL's definer model is out of scope; documented).
"""

from __future__ import annotations

from typing import Dict, List, Set, Tuple

from tidb_tpu_torch.errors import PrivilegeError

__all__ = ["Privileges", "PRIV_KINDS"]

PRIV_KINDS = (
    "select", "insert", "update", "delete",
    "create", "drop", "alter", "index", "super", "all",
)

Scope = Tuple[str, str]  # (db, table); "*" is the wildcard at either slot


class Privileges:
    """Grant matrix: user -> scope -> set of priv names."""

    def __init__(self):
        self._grants: Dict[str, Dict[Scope, Set[str]]] = {}

    # -- mutation ----------------------------------------------------------

    def grant(self, user: str, privs: List[str], db: str, table: str) -> None:
        scopes = self._grants.setdefault(user, {})
        bucket = scopes.setdefault((db, table), set())
        bucket.update(p.lower() for p in privs)

    def revoke(self, user: str, privs: List[str], db: str, table: str) -> None:
        scopes = self._grants.get(user)
        if not scopes:
            return
        bucket = scopes.get((db, table))
        if not bucket:
            return
        privs = [p.lower() for p in privs]
        if "all" in privs:
            bucket.clear()  # REVOKE ALL strips everything at this scope
        else:
            if "all" in bucket:
                # expand ALL so revoking one priv leaves the others
                bucket.discard("all")
                bucket.update(k for k in PRIV_KINDS if k != "all")
            for p in privs:
                bucket.discard(p)
        if not bucket:
            del scopes[(db, table)]

    def drop_user(self, user: str) -> None:
        self._grants.pop(user, None)

    # -- checks ------------------------------------------------------------

    def has(self, user: str, priv: str, db: str = "*", table: str = "*") -> bool:
        if user == "root":
            return True
        scopes = self._grants.get(user)
        if not scopes:
            return False
        priv = priv.lower()
        for scope in (("*", "*"), (db, "*"), (db, table)):
            bucket = scopes.get(scope)
            if bucket and (priv in bucket or "all" in bucket):
                return True
        # SUPER is implied only by global ALL (already covered above)
        return False

    def require(self, user: str, priv: str, db: str = "*", table: str = "*") -> None:
        if not self.has(user, priv, db, table):
            obj = ("*.*" if db == "*" else f"{db}.*" if table == "*"
                   else f"{db}.{table}")
            raise PrivilegeError(
                f"{priv.upper()} command denied to user '{user}' for {obj}")

    # -- introspection -----------------------------------------------------

    def grants_for(self, user: str) -> List[str]:
        """SHOW GRANTS rows, global scope first (MySQL ordering)."""
        rows = []
        if user == "root":
            return ["GRANT ALL PRIVILEGES ON *.* TO 'root'"]
        scopes = self._grants.get(user, {})

        def fmt(scope: Scope, privs: Set[str]) -> str:
            db, table = scope
            obj = ("*.*" if db == "*" else f"{db}.*" if table == "*"
                   else f"{db}.{table}")
            if "all" in privs:
                names = "ALL PRIVILEGES"
            else:
                names = ", ".join(p.upper() for p in sorted(privs))
            return f"GRANT {names} ON {obj} TO '{user}'"

        for scope in sorted(scopes, key=lambda s: (s != ("*", "*"), s)):
            if scopes[scope]:
                rows.append(fmt(scope, scopes[scope]))
        if not rows:
            rows.append(f"GRANT USAGE ON *.* TO '{user}'")
        return rows
