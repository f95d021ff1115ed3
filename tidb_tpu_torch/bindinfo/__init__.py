"""SQL plan bindings (a copy of tidb_tpu/bindinfo/__init__.py; ref:
bindinfo/ — BindHandle: normalized-SQL -> hinted statement, session- and
global-scoped). The session injects a matching binding's hints into the
statement; the normalizer and digest also key the plan cache, the
statements summary and the serving tier.

A binding maps the *normalized* form of a statement (literals
parameterized, whitespace collapsed, hints stripped) to a replacement
statement carrying optimizer hints. At plan time the session looks up
the incoming SELECT's normalized text and, on a hit, plans the bound
statement instead — the reference's mechanism for pinning plans without
editing application SQL."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from tidb_tpu_torch.parser.lexer import Lexer

__all__ = ["normalize_sql", "sql_digest", "Binding", "BindHandle"]


def normalize_sql(sql: str) -> str:
    """Token-level normalization: numeric/string literals -> '?', hints
    dropped, keywords lowercased (the lexer already lowercases them),
    single-space joined. Mirrors the reference's parameterized digest."""
    out = []
    for t in Lexer(sql).tokens():
        if t.kind == "EOF":
            break
        if t.kind == "HINT":
            continue
        if t.kind in ("NUM", "STR"):
            out.append("?")
        elif t.kind == "OP" and t.text == ";":
            continue
        else:
            out.append(t.text)
    return " ".join(out)


def sql_digest(normalized: str) -> str:
    """Statement digest: hex SHA-256 of the normalized text (truncated —
    32 hex chars keep full practical collision resistance while staying
    readable in I_S rows and log lines). Shared by the statements-summary
    store and the slow-query log so their digests always join."""
    import hashlib

    return hashlib.sha256(normalized.encode()).hexdigest()[:32]


@dataclass
class Binding:
    original_sql: str
    bind_sql: str
    scope: str  # global | session
    status: str = "enabled"
    stmt: object = None  # parsed bind_sql, cached at create() time


class BindHandle:
    """One scope's bindings (the catalog holds the global handle, each
    session its own)."""

    def __init__(self, scope: str):
        self.scope = scope
        self._by_norm: Dict[str, Binding] = {}
        # bumped on every create/drop; the plan cache keys on it so a
        # binding change can never serve a stale (differently-hinted)
        # cached plan
        self.version = 0

    def match(self, norm: str) -> Optional[Binding]:
        b = self._by_norm.get(norm)
        return b if b is not None and b.status == "enabled" else None

    def rows(self) -> List[tuple]:
        return [(b.original_sql, b.bind_sql, b.scope, b.status)
                for b in self._by_norm.values()]

    def __len__(self):
        return len(self._by_norm)

    def create(self, target_sql: str, using_sql: str) -> None:
        from tidb_tpu_torch.parser import parse

        norm = normalize_sql(target_sql)
        stmts = parse(using_sql)
        stmt = stmts[0] if len(stmts) == 1 else None
        self._by_norm[norm] = Binding(target_sql, using_sql, self.scope, stmt=stmt)
        self.version += 1

    def drop(self, target_sql: str) -> bool:
        hit = self._by_norm.pop(normalize_sql(target_sql), None) is not None
        if hit:
            self.version += 1
        return hit
