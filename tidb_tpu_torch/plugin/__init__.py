"""Plugin extension points (ref: plugin/ — audit and authentication
hook enums, plugin loading, and the north star's hook for registering an
alternate executor backend).

The reference loads Go plugins with hook enums fired from the session
and privilege layers. Here a plugin is a Python module exposing

    def plugin_init(registry: PluginRegistry) -> None

which registers one or more `Plugin` instances. Kinds:

  audit     — on_statement_begin(session, sql, stmt_type)
              on_statement_end(session, sql, stmt_type, dur_s, error)
  auth      — authenticate(user, token, salt) -> True/False/None
              (None = not my user, fall through; first non-None wins)
  executor  — build(phys_plan, session) -> executor tree; selected per
              session via the tidb_executor_plugin sysvar (the
              generalization of the tidb_enable_tpu_exec toggle)

Plugins are per-catalog (one registry per server instance, like the
reference's per-process plugin list). INSTALL PLUGIN name SONAME
'python.module' / UNINSTALL PLUGIN / SHOW PLUGINS are the SQL surface.
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

from tidb_tpu_torch.errors import ExecutionError

__all__ = ["Plugin", "PluginRegistry"]

_KINDS = ("audit", "auth", "executor")


@dataclass
class Plugin:
    name: str
    kind: str  # audit | auth | executor
    version: str = "1.0"
    # audit
    on_statement_begin: Optional[Callable] = None
    on_statement_end: Optional[Callable] = None
    # auth
    authenticate: Optional[Callable] = None
    # executor
    build: Optional[Callable] = None
    # bookkeeping
    module: str = ""
    status: str = "ACTIVE"


class PluginRegistry:
    def __init__(self):
        self._plugins: Dict[str, Plugin] = {}

    # -- registration / loading ---------------------------------------

    def register(self, plugin: Plugin) -> None:
        if plugin.kind not in _KINDS:
            raise ExecutionError(f"unknown plugin kind {plugin.kind!r}")
        if plugin.name in self._plugins:
            raise ExecutionError(f"plugin {plugin.name!r} already installed")
        self._plugins[plugin.name] = plugin

    # SQL-reachable import allowlist: module path prefixes INSTALL
    # PLUGIN may load, configured at process start (never via SQL) —
    # MySQL likewise restricts SONAME to the server-local plugin_dir.
    # None = embedding default (trusted in-process callers); the server
    # entrypoint sets it explicitly (--plugin-modules / config).
    allowed_prefixes: "Optional[tuple]" = None

    def load_module(self, name: str, module: str) -> None:
        """INSTALL PLUGIN name SONAME 'module': import and init. The
        module's plugin_init may register several plugins; `name` must
        be among them (MySQL errors likewise on a name mismatch)."""
        if self.allowed_prefixes is not None and not any(
                module == p or module.startswith(p + ".")
                for p in self.allowed_prefixes):
            raise ExecutionError(
                f"plugin module {module!r} is outside the configured "
                f"allowlist")
        try:
            mod = importlib.import_module(module)
        except ImportError as e:
            raise ExecutionError(f"cannot load plugin module {module!r}: {e}")
        init = getattr(mod, "plugin_init", None)
        if init is None:
            raise ExecutionError(f"module {module!r} has no plugin_init")
        before = set(self._plugins)
        try:
            init(self)
        except Exception:
            for n in set(self._plugins) - before:  # no partial installs
                del self._plugins[n]
            raise
        added = set(self._plugins) - before
        for n in added:
            self._plugins[n].module = module
        if name not in added:
            for n in added:
                del self._plugins[n]
            raise ExecutionError(
                f"module {module!r} did not register plugin {name!r}")

    def uninstall(self, name: str) -> None:
        if name not in self._plugins:
            raise ExecutionError(f"plugin {name!r} is not installed")
        del self._plugins[name]

    def rows(self) -> List[tuple]:
        """SHOW PLUGINS resultset rows."""
        return [(p.name, p.status, p.kind.upper(), p.module, p.version)
                for p in self._plugins.values()]

    # -- hook dispatch -------------------------------------------------

    def _of_kind(self, kind: str):
        return [p for p in self._plugins.values()
                if p.kind == kind and p.status == "ACTIVE"]

    def statement_begin(self, session, sql: str, stmt_type: str) -> None:
        for p in self._of_kind("audit"):
            if p.on_statement_begin is not None:
                p.on_statement_begin(session, sql, stmt_type)

    def statement_end(self, session, sql: str, stmt_type: str,
                      dur_s: float, error: Optional[BaseException]) -> None:
        for p in self._of_kind("audit"):
            if p.on_statement_end is not None:
                p.on_statement_end(session, sql, stmt_type, dur_s, error)

    def authenticate(self, user: str, token: bytes, salt: bytes) -> Optional[bool]:
        """First auth plugin claiming the user wins; None = builtin."""
        for p in self._of_kind("auth"):
            if p.authenticate is not None:
                verdict = p.authenticate(user, token, salt)
                if verdict is not None:
                    return bool(verdict)
        return None

    def executor_builder(self, name: str) -> Optional[Callable]:
        p = self._plugins.get(name)
        if p is not None and p.kind == "executor" and p.build is not None:
            return p.build
        return None
