"""AST -> SQL text (the tipb-serialization role: plan fragments shipped
to remote coprocessor workers travel as SQL over the DCN RPC tier, and
round-trip through the worker's own parser).

Only expression printing is needed — fragment SELECTs are assembled by
the coordinator from printed pieces. Strings re-quote with '' doubling;
everything prints fully parenthesized so precedence never needs
reconstruction."""

from __future__ import annotations

from tidb_tpu_torch.errors import UnsupportedError
from tidb_tpu_torch.parser import ast as A

__all__ = ["expr_to_sql"]


def _q(s: str) -> str:
    return "'" + str(s).replace("'", "''") + "'"


def expr_to_sql(e) -> str:
    if isinstance(e, A.EName):
        if e.qualifier:
            return f"`{e.qualifier}`.`{e.name}`"
        return f"`{e.name}`"
    if isinstance(e, A.ENum):
        return e.text
    if isinstance(e, A.EStr):
        return _q(e.value)
    if isinstance(e, A.ENull):
        return "NULL"
    if isinstance(e, A.EBool):
        return "TRUE" if e.value else "FALSE"
    if isinstance(e, A.EStar):
        return f"`{e.qualifier}`.*" if e.qualifier else "*"
    if isinstance(e, A.EBinary):
        return f"({expr_to_sql(e.left)} {e.op} {expr_to_sql(e.right)})"
    if isinstance(e, A.EUnary):
        op = {"not": "NOT "}.get(e.op, e.op)
        return f"({op}{expr_to_sql(e.arg)})"
    if isinstance(e, A.EFunc):
        inner = ", ".join(expr_to_sql(a) for a in e.args)
        if e.distinct:
            inner = "DISTINCT " + inner
        return f"{e.name}({inner})"
    if isinstance(e, A.ECase):
        parts = ["CASE"]
        if e.operand is not None:
            parts.append(expr_to_sql(e.operand))
        for w, t in e.whens:
            parts.append(f"WHEN {expr_to_sql(w)} THEN {expr_to_sql(t)}")
        if e.else_ is not None:
            parts.append(f"ELSE {expr_to_sql(e.else_)}")
        parts.append("END")
        return "(" + " ".join(parts) + ")"
    if isinstance(e, A.ECast):
        args = f"({', '.join(str(a) for a in e.type_args)})" if e.type_args else ""
        return f"CAST({expr_to_sql(e.arg)} AS {e.type_name}{args})"
    if isinstance(e, A.EIn):
        if e.values is None:
            raise UnsupportedError("cannot print IN (subquery)")
        vals = ", ".join(expr_to_sql(v) for v in e.values)
        return f"({expr_to_sql(e.arg)} {'NOT ' if e.negated else ''}IN ({vals}))"
    if isinstance(e, A.EBetween):
        return (f"({expr_to_sql(e.arg)} {'NOT ' if e.negated else ''}BETWEEN "
                f"{expr_to_sql(e.low)} AND {expr_to_sql(e.high)})")
    if isinstance(e, A.ELike):
        esc = f" ESCAPE {_q(e.escape)}" if e.escape else ""
        return (f"({expr_to_sql(e.arg)} {'NOT ' if e.negated else ''}LIKE "
                f"{expr_to_sql(e.pattern)}{esc})")
    if isinstance(e, A.EInterval):
        return f"INTERVAL {expr_to_sql(e.value)} {e.unit}"
    if isinstance(e, A.EIsNull):
        return f"({expr_to_sql(e.arg)} IS {'NOT ' if e.negated else ''}NULL)"
    raise UnsupportedError(f"cannot print {type(e).__name__} for fragment shipping")
