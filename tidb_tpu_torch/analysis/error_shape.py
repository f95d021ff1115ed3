"""error-shape pass: errors stay typed, coded, and visible.

  * no bare ``except:`` anywhere in tidb_tpu_torch/ (it swallows
    KeyboardInterrupt/SystemExit and every typo alike)
  * no silent swallow: an ``except Exception:`` / ``except
    BaseException:`` handler whose body is just ``pass``/``continue``
    must justify itself inline — either the repo's existing
    ``# noqa: BLE001 — <why>`` idiom or a lint suppression.  Narrow
    exception tuples may swallow freely (they name what they expect).
  * typed user-facing errors carry MySQL error codes: every class in
    ``errors.py`` must resolve a ``code`` attribute through the in-file
    hierarchy (the server's error packets read it).
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional

from tidb_tpu_torch.analysis.core import Pass, Project, SourceFile, Violation

__all__ = ["ErrorShapePass"]

# the repo's established annotation for deliberate broad catches
_BLE_RE = re.compile(r"#\s*noqa:\s*BLE001\s*(?:[-—–]+\s*(.*))?$")


def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    names = []
    if isinstance(t, ast.Name):
        names = [t.id]
    elif isinstance(t, ast.Tuple):
        names = [e.id for e in t.elts if isinstance(e, ast.Name)]
    return any(n in ("Exception", "BaseException") for n in names)


def _swallows(handler: ast.ExceptHandler) -> bool:
    return all(isinstance(s, (ast.Pass, ast.Continue)) for s in handler.body)


class ErrorShapePass(Pass):
    id = "error-shape"
    doc = ("no bare except, no silent `except Exception: pass` without an "
           "inline reason, error classes carry MySQL codes")

    def run(self, project: Project) -> List[Violation]:
        out: List[Violation] = []
        for sf in project.files():
            for node in ast.walk(sf.tree):
                if not isinstance(node, ast.ExceptHandler):
                    continue
                if node.type is None:
                    out.append(Violation(
                        self.id, sf.rel, node.lineno,
                        "bare `except:` catches SystemExit/KeyboardInterrupt"
                        " and every typo — name the exceptions (or "
                        "`except Exception` with a `# noqa: BLE001 — why`)"))
                    continue
                if _is_broad(node) and _swallows(node) \
                        and not self._annotated(sf, node.lineno):
                    out.append(Violation(
                        self.id, sf.rel, node.lineno,
                        "`except Exception: pass` silently swallows every "
                        "failure — narrow the exception types or annotate "
                        "the except line with `# noqa: BLE001 — <why this "
                        "cleanup path may ignore errors>`"))
            if sf.rel.endswith("errors.py"):
                out.extend(self._check_codes(sf))
        return out

    @staticmethod
    def _annotated(sf: SourceFile, line: int) -> bool:
        for ln in (line, line - 1):
            if 1 <= ln <= len(sf.lines):
                m = _BLE_RE.search(sf.lines[ln - 1])
                if m and (m.group(1) or "").strip():
                    return True
        return False

    def _check_codes(self, sf: SourceFile) -> List[Violation]:
        """Every class in errors.py must resolve `code` via in-file
        bases (user-facing packets render it)."""
        classes: Dict[str, ast.ClassDef] = {
            n.name: n for n in sf.tree.body if isinstance(n, ast.ClassDef)}

        def has_code(cls: ast.ClassDef, seen=frozenset()) -> bool:
            for stmt in cls.body:
                if isinstance(stmt, ast.Assign):
                    for tgt in stmt.targets:
                        if isinstance(tgt, ast.Name) and tgt.id == "code":
                            return True
            for base in cls.bases:
                name = base.id if isinstance(base, ast.Name) else None
                if name and name in classes and name not in seen:
                    if has_code(classes[name], seen | {name}):
                        return True
            return False

        out = []
        for name, cls in classes.items():
            if not has_code(cls):
                out.append(Violation(
                    self.id, sf.rel, cls.lineno,
                    f"error class {name} resolves no MySQL `code` "
                    "attribute — the protocol layer would fall back to a "
                    "generic errno for a typed error"))
        return out
