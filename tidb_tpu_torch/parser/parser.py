"""Recursive-descent statement parser + Pratt expression parser.

Grammar shape follows MySQL's, with precedence levels matching the MySQL
manual (OR < XOR < AND < NOT < comparison/IN/BETWEEN/LIKE/IS < | < & <
shifts < +- < */DIV/MOD < ^ < unary). Only the productions the engine
executes are implemented; everything else raises ParseError with position.
"""

from __future__ import annotations

from typing import List, Optional, Union

from tidb_tpu_torch.errors import ParseError
from tidb_tpu_torch.parser.ast import *  # noqa: F403
from tidb_tpu_torch.parser.lexer import Lexer, Token

__all__ = ["Parser", "parse", "parse_one"]


def parse(sql: str) -> list:
    return Parser(sql).parse_statements()


def parse_one(sql: str):
    stmts = parse(sql)
    if len(stmts) != 1:
        raise ParseError(f"expected exactly one statement, got {len(stmts)}")
    return stmts[0]


class Parser:
    def __init__(self, sql: str):
        self.sql = sql
        toks = Lexer(sql).tokens()
        # hints are only meaningful right after SELECT; elsewhere they
        # behave like the comments they are (TiDB likewise ignores
        # DML-position hints it doesn't implement)
        self.toks = [
            t for i, t in enumerate(toks)
            if t.kind != "HINT"
            or (i > 0 and toks[i - 1].kind == "KW" and toks[i - 1].text == "select")
        ]
        self.pos = 0
        self.param_count = 0

    # -- token helpers -----------------------------------------------------

    def peek(self, ahead: int = 0) -> Token:
        i = min(self.pos + ahead, len(self.toks) - 1)
        return self.toks[i]

    def next(self) -> Token:
        t = self.toks[self.pos]
        if t.kind != "EOF":
            self.pos += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "KW" and t.text in kws

    def at_op(self, *ops: str) -> bool:
        t = self.peek()
        return t.kind == "OP" and t.text in ops

    def accept_kw(self, *kws: str) -> Optional[Token]:
        if self.at_kw(*kws):
            return self.next()
        return None

    def accept_op(self, *ops: str) -> Optional[Token]:
        if self.at_op(*ops):
            return self.next()
        return None

    def expect_kw(self, kw: str) -> Token:
        if not self.at_kw(kw):
            raise self.error(f"expected {kw.upper()}")
        return self.next()

    def expect_op(self, op: str) -> Token:
        if not self.at_op(op):
            raise self.error(f"expected {op!r}")
        return self.next()

    def expect_ident(self) -> str:
        t = self.peek()
        if t.kind in ("IDENT", "QIDENT"):
            self.next()
            return t.text
        # non-reserved-ish keywords usable as identifiers in practice
        if t.kind == "KW" and t.text in _IDENTISH_KW:
            self.next()
            return t.text
        raise self.error("expected identifier")

    def error(self, msg: str) -> ParseError:
        t = self.peek()
        line = self.sql.count("\n", 0, t.pos) + 1
        return ParseError(f"{msg} at line {line} near {t.text or '<eof>'!r}")

    # -- statements --------------------------------------------------------

    def parse_statements(self) -> list:
        out = []
        while self.peek().kind != "EOF":
            if self.accept_op(";"):
                continue
            start = self.peek().pos
            stmt = self.parse_statement()
            # statement source text (plan bindings normalize + match it)
            try:
                stmt._source = self.sql[start : self.peek().pos].strip()
            except AttributeError:  # frozen/slotted nodes don't need it
                pass
            out.append(stmt)
            if not self.accept_op(";") and self.peek().kind != "EOF":
                raise self.error("expected ';' or end of input")
        return out

    def parse_statement(self):
        if self.at_op("("):  # parenthesized SELECT statement
            return self.parse_select_or_union()
        t = self.peek()
        if t.kind == "IDENT" and t.text.lower() == "load":
            return self.parse_load_data()
        if t.kind == "IDENT" and t.text.lower() == "savepoint":
            self.next()
            return SavepointStmt(self.expect_ident())
        if t.kind == "IDENT" and t.text.lower() == "kill":
            self.next()
            query_only = bool(self._accept_word("query"))
            self._accept_word("connection")
            return KillStmt(self._int_literal("connection id"), query_only)
        if t.kind == "IDENT" and t.text.lower() == "release":
            self.next()
            self._expect_word("savepoint")
            return ReleaseSavepointStmt(self.expect_ident())
        if t.kind != "KW":
            raise self.error("expected statement keyword")
        kw = t.text
        if kw in ("select", "with"):
            return self.parse_select_or_union()
        handler = {
            "insert": self.parse_insert,
            "replace": self.parse_insert,
            "update": self.parse_update,
            "delete": self.parse_delete,
            "create": self.parse_create,
            "drop": self.parse_drop,
            "alter": self.parse_alter,
            "explain": self.parse_explain,
            "describe": self.parse_explain,
            "desc": self.parse_explain,
            "set": self.parse_set,
            "show": self.parse_show,
            "begin": lambda: (self.next(), BeginStmt())[1],
            "start": self.parse_start_txn,
            "commit": lambda: (self.next(), CommitStmt())[1],
            "rollback": self.parse_rollback,
            "use": self.parse_use,
            "truncate": self.parse_truncate,
            "analyze": self.parse_analyze,
            "trace": lambda: (self.next(), TraceStmt(self.parse_statement()))[1],
            "grant": self.parse_grant,
            "revoke": self.parse_revoke,
            "install": self.parse_install,
            "uninstall": self.parse_uninstall,
        }.get(kw)
        if handler is None:
            raise self.error(f"unsupported statement {kw.upper()}")
        return handler()

    # -- SELECT ------------------------------------------------------------

    def parse_select_or_union(self):
        ctes: List[CTE] = []
        if self.accept_kw("with"):
            self.accept_kw("recursive")  # accepted, not yet executed
            while True:
                name = self.expect_ident()
                cols = None
                if self.accept_op("("):
                    cols = [self.expect_ident()]
                    while self.accept_op(","):
                        cols.append(self.expect_ident())
                    self.expect_op(")")
                self.expect_kw("as")
                self.expect_op("(")
                sel = self.parse_select_or_union()
                self.expect_op(")")
                ctes.append(CTE(name, cols, sel))
                if not self.accept_op(","):
                    break

        node = self._parse_intersect_chain()
        while self.at_kw("union", "except"):
            op = self.next().text
            all_ = bool(self.accept_kw("all"))
            if not all_:
                self.accept_kw("distinct")
            right = self._parse_intersect_chain()
            node = UnionStmt(node, right, all=all_, op=op)
            self._hoist_set_tail(node, right)
        if ctes:
            if isinstance(node, SelectStmt):
                node.ctes = ctes
            else:
                # hang CTEs off the leftmost select of the union
                left = node
                while isinstance(left, UnionStmt):
                    left = left.left
                left.ctes = ctes
        return node

    def _parse_intersect_chain(self):
        """INTERSECT binds tighter than UNION/EXCEPT (SQL standard and
        MySQL 8)."""
        node = self.parse_select_core()
        while self.at_kw("intersect"):
            self.next()
            all_ = bool(self.accept_kw("all"))
            if not all_:
                self.accept_kw("distinct")
            right = self.parse_select_core()
            node = UnionStmt(node, right, all=all_, op="intersect")
            self._hoist_set_tail(node, right)
        return node

    def _hoist_set_tail(self, node: UnionStmt, right) -> None:
        """An unparenthesized trailing ORDER BY/LIMIT was consumed by
        the rightmost operand but binds to the whole compound statement
        (MySQL semantics); a parenthesized operand keeps its own.
        `right` may itself be a set-op chain whose tail was hoisted."""
        if getattr(right, "_parenthesized", False):
            return
        if self.at_kw("union", "except", "intersect"):
            return
        node.order_by, right.order_by = right.order_by, []
        node.limit, node.offset = right.limit, right.offset
        right.limit = right.offset = None

    def parse_select_core(self) -> Union[SelectStmt, "UnionStmt"]:
        if self.accept_op("("):
            sel = self.parse_select_or_union()
            self.expect_op(")")
            sel._parenthesized = True
            return sel
        self.expect_kw("select")
        stmt = SelectStmt()
        if self.peek().kind == "HINT":
            stmt.hints = self._parse_hints(self.next().text)
        if self.accept_kw("distinct"):
            stmt.distinct = True
        else:
            self.accept_kw("all")
        stmt.items = [self.parse_select_item()]
        while self.accept_op(","):
            stmt.items.append(self.parse_select_item())
        if self.accept_kw("from"):
            stmt.from_ = self.parse_table_sources()
        if self.accept_kw("where"):
            stmt.where = self.parse_expr()
        if self.accept_kw("group"):
            self.expect_kw("by")
            stmt.group_by = [self.parse_expr()]
            while self.accept_op(","):
                stmt.group_by.append(self.parse_expr())
        if self.accept_kw("having"):
            stmt.having = self.parse_expr()
        if self.accept_kw("order"):
            self.expect_kw("by")
            stmt.order_by = self.parse_order_items()
        if self.accept_kw("limit"):
            stmt.limit, stmt.offset = self.parse_limit_clause()
        if self.accept_kw("into"):
            # SELECT ... INTO OUTFILE 'path' [FIELDS ...] [LINES ...]
            self._expect_word("outfile")
            if self.peek().kind != "STR":
                raise self.error("expected a quoted file path after OUTFILE")
            into = IntoOutfile(self.next().text)
            self._parse_field_options(into)
            if self._accept_word("lines"):
                self._expect_word("terminated")
                self.expect_kw("by")
                into.lines_term = self.next().text
            stmt.into_outfile = into
        # locking reads: FOR UPDATE / FOR SHARE / LOCK IN SHARE MODE
        # (ref: pessimistic SELECT locking over the 2PC row locks)
        if self.accept_kw("for"):
            if self.accept_kw("update"):
                stmt.lock_mode = "update"
            elif self._accept_word("share"):
                stmt.lock_mode = "share"
            else:
                raise self.error("expected UPDATE or SHARE after FOR")
            if self._accept_word("nowait"):
                stmt.lock_nowait = True
        elif self._accept_word("lock"):
            self.expect_kw("in")
            self._expect_word("share")
            self._expect_word("mode")
            stmt.lock_mode = "share"
        return stmt

    def _parse_field_options(self, target) -> None:
        """FIELDS TERMINATED / [OPTIONALLY] ENCLOSED / ESCAPED BY —
        shared by LOAD DATA and SELECT ... INTO OUTFILE."""
        if not (self._accept_word("fields") or self._accept_word("columns")):
            return
        while True:
            if self._accept_word("terminated"):
                self.expect_kw("by")
                target.fields_term = self.next().text
            elif self._accept_word("optionally"):
                self._expect_word("enclosed")
                self.expect_kw("by")
                target.enclosed = self.next().text
            elif self._accept_word("enclosed"):
                self.expect_kw("by")
                target.enclosed = self.next().text
            elif self._accept_word("escaped"):
                self.expect_kw("by")
                self.next()  # accepted; backslash semantics built in
            else:
                break

    def parse_select_item(self) -> SelectItem:
        if self.at_op("*"):
            self.next()
            return SelectItem(EStar())
        # t.* qualified star
        t = self.peek()
        if (
            t.kind in ("IDENT", "QIDENT")
            and self.peek(1).kind == "OP"
            and self.peek(1).text == "."
            and self.peek(2).kind == "OP"
            and self.peek(2).text == "*"
        ):
            self.next(); self.next(); self.next()
            return SelectItem(EStar(qualifier=t.text))
        expr = self.parse_expr()
        alias = None
        if self.accept_kw("as"):
            alias = self.expect_ident_or_string()
        else:
            nt = self.peek()
            if nt.kind in ("IDENT", "QIDENT") or (nt.kind == "KW" and nt.text in _IDENTISH_KW):
                alias = self.expect_ident()
        return SelectItem(expr, alias)

    def expect_ident_or_string(self) -> str:
        if self.peek().kind == "STR":
            return self.next().text
        return self.expect_ident()

    def parse_order_items(self) -> List[OrderItem]:
        items = [self.parse_order_item()]
        while self.accept_op(","):
            items.append(self.parse_order_item())
        return items

    def parse_order_item(self) -> OrderItem:
        e = self.parse_expr()
        desc = False
        if self.accept_kw("desc"):
            desc = True
        else:
            self.accept_kw("asc")
        return OrderItem(e, desc)

    def parse_limit_clause(self):
        a = int(self.next().text)
        offset = None
        if self.accept_op(","):  # LIMIT offset, count
            b = int(self.next().text)
            return b, a
        if self.accept_kw("offset"):
            offset = int(self.next().text)
        return a, offset

    # -- FROM / joins --------------------------------------------------------

    def parse_table_sources(self) -> TableSource:
        left = self.parse_joined_table()
        while self.accept_op(","):  # comma join == cross join
            right = self.parse_joined_table()
            left = Join("cross", left, right)
        return left

    def parse_joined_table(self) -> TableSource:
        left = self.parse_table_primary()
        while True:
            if self.accept_kw("cross"):
                self.expect_kw("join")
                right = self.parse_table_primary()
                left = Join("cross", left, right)
                continue
            kind = None
            if self.accept_kw("inner"):
                kind = "inner"
            elif self.accept_kw("left"):
                self.accept_kw("outer")
                kind = "left"
            elif self.accept_kw("right"):
                self.accept_kw("outer")
                kind = "right"
            elif self.accept_kw("full"):
                self.accept_kw("outer")
                kind = "full"
            if kind is None:
                if not self.at_kw("join"):
                    return left
                kind = "inner"
            self.expect_kw("join")
            right = self.parse_table_primary()
            on = None
            using = None
            if self.accept_kw("on"):
                on = self.parse_expr()
            elif self.accept_kw("using"):
                self.expect_op("(")
                using = [self.expect_ident()]
                while self.accept_op(","):
                    using.append(self.expect_ident())
                self.expect_op(")")
            left = Join(kind, left, right, on=on, using=using)

    def parse_table_primary(self) -> TableSource:
        if self.accept_op("("):
            if self.at_kw("select", "with") or self.at_op("("):
                sel = self.parse_select_or_union()
                self.expect_op(")")
                self.accept_kw("as")
                alias = self.expect_ident()
                return SubqueryTable(sel, alias)
            src = self.parse_table_sources()
            self.expect_op(")")
            return src
        name = self.expect_ident()
        schema = None
        if self.accept_op("."):
            schema, name = name, self.expect_ident()
        alias = None
        if self.accept_kw("as"):
            alias = self.expect_ident()
        else:
            nt = self.peek()
            if nt.kind in ("IDENT", "QIDENT"):
                alias = self.next().text
        return TableName(name, schema=schema, alias=alias)

    # -- DML -----------------------------------------------------------------

    def parse_insert(self) -> InsertStmt:
        replace = self.peek().text == "replace"
        self.next()  # insert/replace
        self.accept_kw("into")
        table = self._table_name()
        columns = None
        if self.at_op("(") and not self._paren_starts_select():
            self.expect_op("(")
            columns = [self.expect_ident()]
            while self.accept_op(","):
                columns.append(self.expect_ident())
            self.expect_op(")")
        if self.accept_kw("values"):
            rows = [self._value_row()]
            while self.accept_op(","):
                rows.append(self._value_row())
            on_dup = self._on_duplicate()
            if replace and on_dup:
                raise self.error("REPLACE cannot have ON DUPLICATE KEY UPDATE")
            return InsertStmt(table, columns, rows=rows, replace=replace,
                              on_dup=on_dup)
        sel = self.parse_select_or_union()
        on_dup = self._on_duplicate()
        if replace and on_dup:
            raise self.error("REPLACE cannot have ON DUPLICATE KEY UPDATE")
        return InsertStmt(table, columns, select=sel, replace=replace,
                          on_dup=on_dup)

    def _on_duplicate(self):
        if not self.accept_kw("on"):
            return None
        self.expect_kw("duplicate")
        self.expect_kw("key")
        self.expect_kw("update")
        sets = []
        while True:
            name = EName(self.expect_ident())
            self.expect_op("=")
            sets.append((name, self.parse_expr()))
            if not self.accept_op(","):
                break
        return sets

    def _paren_starts_select(self) -> bool:
        t1 = self.peek(1)
        return t1.kind == "KW" and t1.text in ("select", "with")

    def _value_row(self) -> List:
        self.expect_op("(")
        row = [self.parse_expr()]
        while self.accept_op(","):
            row.append(self.parse_expr())
        self.expect_op(")")
        return row

    def _table_name(self) -> TableName:
        name = self.expect_ident()
        schema = None
        if self.accept_op("."):
            schema, name = name, self.expect_ident()
        return TableName(name, schema=schema)

    def _accept_word(self, word: str) -> bool:
        """Accept an IDENT-or-keyword token by lowercase text (LOAD DATA
        options like FIELDS/LINES/TERMINATED aren't reserved words)."""
        t = self.peek()
        if t.kind in ("IDENT", "KW") and t.text.lower() == word:
            self.next()
            return True
        return False

    def _expect_word(self, word: str):
        if not self._accept_word(word):
            raise self.error(f"expected {word.upper()}")

    def parse_rollback(self):
        self.expect_kw("rollback")
        if self.accept_kw("to"):
            self._accept_word("savepoint")
            return RollbackToStmt(self.expect_ident())
        return RollbackStmt()

    def parse_load_data(self) -> LoadDataStmt:
        self._expect_word("load")
        self._expect_word("data")
        local = self._accept_word("local")
        self._expect_word("infile")
        if self.peek().kind != "STR":
            raise self.error("expected a quoted file path after INFILE")
        path = self.next().text
        self.expect_kw("into")
        self.expect_kw("table")
        table = self._table_name()
        stmt = LoadDataStmt(path, table, local=local)
        self._parse_field_options(stmt)
        if self._accept_word("lines"):
            while True:
                if self._accept_word("terminated"):
                    self.expect_kw("by")
                    stmt.lines_term = self.next().text
                elif self._accept_word("starting"):
                    self.expect_kw("by")
                    self.next()
                else:
                    break
        if self._accept_word("ignore"):
            if self.peek().kind != "NUM":
                raise self.error("expected a line count after IGNORE")
            stmt.ignore_lines = int(self.next().text)
            if not (self._accept_word("lines") or self._accept_word("rows")):
                raise self.error("expected LINES/ROWS")
        if self.accept_op("("):
            cols = [self.expect_ident()]
            while self.accept_op(","):
                cols.append(self.expect_ident())
            self.expect_op(")")
            stmt.columns = cols
        return stmt

    def parse_update(self) -> UpdateStmt:
        self.expect_kw("update")
        refs = self.parse_table_sources()
        self.expect_kw("set")
        sets = []
        while True:
            name = self.expect_ident()
            qual = None
            if self.accept_op("."):
                qual, name = name, self.expect_ident()
            self.expect_op("=")
            sets.append((EName(name, qual), self.parse_expr()))
            if not self.accept_op(","):
                break
        where = self.parse_expr() if self.accept_kw("where") else None
        if isinstance(refs, TableName):
            return UpdateStmt(refs, sets, where)
        # multi-table: the single updated target resolves from the SET
        # column qualifiers at execution time (placeholder name here)
        return UpdateStmt(TableName(""), sets, where, from_=refs)

    def parse_delete(self) -> DeleteStmt:
        self.expect_kw("delete")
        if self.accept_kw("from"):
            table = self._table_name()
            if self.accept_kw("using"):
                # DELETE FROM t USING <table_refs> WHERE ...
                refs = self.parse_table_sources()
                where = self.parse_expr() if self.accept_kw("where") else None
                return DeleteStmt(table, where, from_=refs)
            where = self.parse_expr() if self.accept_kw("where") else None
            return DeleteStmt(table, where)
        # DELETE t FROM <table_refs> WHERE ...  (single target supported)
        table = self._table_name()
        self.expect_kw("from")
        refs = self.parse_table_sources()
        where = self.parse_expr() if self.accept_kw("where") else None
        return DeleteStmt(table, where, from_=refs)

    # -- DDL -----------------------------------------------------------------

    def parse_create(self):
        self.expect_kw("create")
        scope = "session"
        if self.at_kw("global", "session") and self.peek(1).text == "binding":
            scope = self.next().text
        if self.accept_kw("binding"):
            self.expect_kw("for")
            t_start = self.peek().pos
            self.parse_statement()  # validated, matched by normalized text
            t_sql = self.sql[t_start : self.peek().pos].strip()
            self.expect_kw("using")
            u_start = self.peek().pos
            self.parse_statement()
            u_sql = self.sql[u_start : self.peek().pos].strip()
            return CreateBindingStmt(scope, t_sql, u_sql)
        or_replace = False
        if self.at_kw("or") and self.peek(1).text == "replace":
            self.next()
            self.next()
            or_replace = True
            self.expect_kw("view")
            return self._create_view_tail(or_replace)
        if self.accept_kw("view"):
            return self._create_view_tail(False)
        if self.accept_kw("database") or self.accept_kw("schema"):
            ine = self._if_not_exists()
            return CreateDatabaseStmt(self.expect_ident(), ine)
        if self.accept_kw("user"):
            ine = self._if_not_exists()
            user = self._user_name()
            password = ""
            if self.accept_kw("identified"):
                self.expect_kw("by")
                password = self.next().text
            return CreateUserStmt(user, password, ine)
        temporary = self._accept_word("temporary")
        if temporary:
            self.expect_kw("table")
            ine = self._if_not_exists()
            stmt = CreateTableStmt(self._table_name(), if_not_exists=ine,
                                   temporary=True)
            return self._create_table_tail(stmt)
        unique = bool(self.accept_kw("unique"))
        if self.accept_kw("index"):
            name = self.expect_ident()
            self.expect_kw("on")
            table = self._table_name()
            self.expect_op("(")
            cols = [self.expect_ident()]
            while self.accept_op(","):
                cols.append(self.expect_ident())
            self.expect_op(")")
            return CreateIndexStmt(name, table, cols, unique)
        self.expect_kw("table")
        ine = self._if_not_exists()
        table = self._table_name()
        stmt = CreateTableStmt(table, if_not_exists=ine)
        return self._create_table_tail(stmt)

    def _create_table_tail(self, stmt):
        if self.accept_kw("like"):
            stmt.like = self._table_name()
            return stmt
        if self.at_op("(") and self.peek(1).kind == "KW" \
                and self.peek(1).text == "like":
            self.next()  # (
            self.next()  # LIKE
            stmt.like = self._table_name()
            self.expect_op(")")
            return stmt
        if self.at_kw("as", "select", "with"):
            # CREATE TABLE t AS SELECT ... (AS optional, like MySQL)
            self.accept_kw("as")
            stmt.as_select = self.parse_select_or_union()
            return stmt
        self.expect_op("(")
        while True:
            if self.accept_kw("primary"):
                self.expect_kw("key")
                stmt.primary_key = self._paren_name_list()
            elif self.accept_kw("unique"):
                self.accept_kw("key") or self.accept_kw("index")
                kname = ""
                if self.peek().kind in ("IDENT", "QIDENT"):
                    kname = self.expect_ident()
                stmt.unique_keys.append((kname, self._paren_name_list()))
            elif self.accept_kw("key") or self.accept_kw("index"):
                kname = ""
                if self.peek().kind in ("IDENT", "QIDENT"):
                    kname = self.expect_ident()
                stmt.indexes.append((kname, self._paren_name_list()))
            elif self.peek().kind == "IDENT" and \
                    self.peek().text.lower() == "check":
                self.next()
                stmt.checks.append(("", *self._parse_check_expr()))
            elif self.accept_kw("constraint"):
                # named constraint: swallow FOREIGN KEY / etc. for parse-compat
                cname = ""
                if self.peek().kind in ("IDENT", "QIDENT") and \
                        self.peek().text.lower() != "check":
                    cname = self.expect_ident()
                if self.peek().kind == "IDENT" and \
                        self.peek().text.lower() == "check":
                    self.next()
                    stmt.checks.append((cname, *self._parse_check_expr()))
                elif self.accept_kw("primary"):
                    self.expect_kw("key")
                    stmt.primary_key = self._paren_name_list()
                elif self.accept_kw("unique"):
                    stmt.unique_keys.append(("", self._paren_name_list()))
                elif self.accept_kw("foreign"):
                    self.expect_kw("key")
                    stmt.foreign_keys.append(self._parse_fk_spec())
            elif self.accept_kw("foreign"):
                self.expect_kw("key")
                stmt.foreign_keys.append(self._parse_fk_spec())
            else:
                stmt.columns.append(self.parse_column_def())
            if not self.accept_op(","):
                break
        self.expect_op(")")
        # table options: ENGINE=... selects the storage engine
        # (kvapi.make_table); COLLATE=... sets the default collation for
        # columns without an explicit one; CHARSET/COMMENT accepted
        # (charset is always utf8mb4 here)
        while self.peek().kind == "KW" and self.peek().text in (
                "engine", "charset", "character", "comment", "collate",
                "default"):
            opt = self.next().text
            if opt == "default":
                continue  # DEFAULT CHARSET=... / DEFAULT COLLATE=...
            self.accept_kw("set")
            self.accept_op("=")
            val = self.next().text
            if opt == "engine":
                stmt.engine = val.lower()
            elif opt == "collate":
                stmt.collation = val.lower()
            else:
                # accepted-and-ignored: surfaced via SHOW WARNINGS
                # instead of vanishing silently (r4 review weak #8)
                stmt.ignored.append(f"table option {opt.upper()}")
        # PARTITION BY RANGE (col) (PARTITION p VALUES LESS THAN (n)...)
        # | PARTITION BY HASH (col) PARTITIONS n   (ref: table partitions
        # pruned like the reference's partition pruning)
        if self._accept_word("partition"):
            self.expect_kw("by")
            if self._accept_word("range"):
                self.expect_op("(")
                col = self.expect_ident()
                self.expect_op(")")
                self.expect_op("(")
                parts = []
                while True:
                    self._expect_word("partition")
                    pname = self.expect_ident()
                    self._expect_word("values")
                    self._expect_word("less")
                    self._expect_word("than")
                    if self.accept_op("("):
                        upper = self._int_literal("partition bound")
                        self.expect_op(")")
                    else:
                        self._expect_word("maxvalue")
                        upper = None
                    parts.append((pname, upper))
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
                stmt.partition = ("range", col, parts)
            elif self._accept_word("hash"):
                self.expect_op("(")
                col = self.expect_ident()
                self.expect_op(")")
                self._expect_word("partitions")
                n = self._int_literal("partition count")
                if n <= 0:
                    raise self.error("PARTITIONS must be positive")
                stmt.partition = ("hash", col, n)
            else:
                raise self.error("expected RANGE or HASH after PARTITION BY")
        # Trailing table options, composable in ANY order (each at most
        # once):
        #   SHARD BY HASH (col) SHARDS n | SHARD BY RANGE (col) SHARDS
        #   (b1, b2, ...) — cross-worker placement (tidb_tpu/sharding):
        #   k ascending bounds make k+1 shards, shard i = [b_{i-1}, b_i)
        #   CLUSTER BY (col) — keep the table physically ordered by
        #   this column at delta->segment compaction so zone maps prune
        #   without hand-ordered ingest (ISSUE 18)
        seen = set()
        while True:
            if self._accept_word("shard"):
                opt = "shard"
            elif self._accept_word("cluster"):
                opt = "cluster"
            else:
                break
            if opt in seen:
                raise self.error(f"duplicate {opt.upper()} BY clause")
            seen.add(opt)
            self.expect_kw("by")
            if opt == "shard":
                stmt.shard = self._parse_shard_spec()
            else:
                stmt.cluster = self._parse_cluster_spec()
        return stmt

    def _parse_cluster_spec(self) -> Optional[str]:
        if self._accept_word("none"):
            return None
        self.expect_op("(")
        col = self.expect_ident()
        self.expect_op(")")
        return col

    def _parse_shard_spec(self) -> tuple:
        if self._accept_word("hash"):
            self.expect_op("(")
            col = self.expect_ident()
            self.expect_op(")")
            self._expect_word("shards")
            n = self._int_literal("shard count")
            if n <= 0:
                raise self.error("SHARDS must be positive")
            return ("hash", col, n)
        if self._accept_word("range"):
            self.expect_op("(")
            col = self.expect_ident()
            self.expect_op(")")
            self._expect_word("shards")
            self.expect_op("(")
            bounds = [self._int_literal("shard bound")]
            while self.accept_op(","):
                bounds.append(self._int_literal("shard bound"))
            self.expect_op(")")
            if any(a >= b for a, b in zip(bounds, bounds[1:])):
                raise self.error("SHARD BY RANGE bounds must be strictly "
                                 "increasing")
            return ("range", col, bounds)
        raise self.error("expected RANGE or HASH after SHARD BY")

    def _int_literal(self, what: str) -> int:
        """A (possibly negative) integer literal token."""
        neg = bool(self.accept_op("-"))
        t = self.peek()
        if t.kind != "NUM" or "." in t.text:
            raise self.error(f"expected integer {what}")
        self.next()
        return -int(t.text) if neg else int(t.text)

    def _if_not_exists(self) -> bool:
        if self.accept_kw("if"):
            self.expect_kw("not")
            # EXISTS lexes as KW
            self.expect_kw("exists")
            return True
        return False

    def _paren_name_list(self) -> List[str]:
        self.expect_op("(")
        out = [self.expect_ident()]
        while self.accept_op(","):
            out.append(self.expect_ident())
        self.expect_op(")")
        return out

    def parse_column_def(self) -> ColumnDef:
        name = self.expect_ident()
        t = self.peek()
        if t.kind not in ("IDENT", "KW"):
            raise self.error("expected column type")
        type_name = self.next().text.lower()
        args = ()
        if self.accept_op("("):
            def type_arg():
                t = self.next()
                # ENUM/SET member lists are quoted strings; numeric
                # lengths everywhere else
                return t.text if t.kind == "STR" else int(t.text)

            a = [type_arg()]
            while self.accept_op(","):
                a.append(type_arg())
            self.expect_op(")")
            args = tuple(a)
        self.accept_kw("unsigned")
        self.accept_kw("zerofill")
        collation = None
        if self.accept_kw("character"):
            self.expect_kw("set")
            cs = self.next().text.lower()
            if cs == "binary":
                collation = "utf8mb4_bin"
        if self.accept_kw("collate"):
            collation = self.next().text.lower()
        col = ColumnDef(name, type_name, args)
        col.collation = collation
        # generated column: [GENERATED ALWAYS] AS (expr) [VIRTUAL|STORED]
        if self._accept_word("generated"):
            self._expect_word("always")
            self.expect_kw("as")
            col.generated = self._parse_generated_expr()
        elif self.accept_kw("as"):
            col.generated = self._parse_generated_expr()
        while True:
            if self.accept_kw("not"):
                self.expect_kw("null")
                col.not_null = True
            elif self.accept_kw("null"):
                pass
            elif self.accept_kw("primary"):
                self.expect_kw("key")
                col.primary_key = True
            elif self.accept_kw("unique"):
                self.accept_kw("key")
                col.unique = True
            elif self.accept_kw("default"):
                col.default = self.parse_primary()
            elif self.accept_kw("auto_increment"):
                col.auto_increment = True
            elif self.accept_kw("comment"):
                self.next()
                col.ignored.append(f"column {name!r} COMMENT")
            elif self.peek().kind == "IDENT" and \
                    self.peek().text.lower() == "check":
                self.next()
                col.checks.append(self._parse_check_expr())
            else:
                return col

    def _parse_fk_spec(self):
        """FOREIGN KEY (...) REFERENCES t (...) [ON DELETE act] [ON
        UPDATE act] -> (cols, ref_table, ref_cols, on_delete, on_update)."""
        cols = self._paren_name_list()
        self.expect_kw("references")
        ref = self._table_name()
        refcols = self._paren_name_list()
        on_delete = on_update = "restrict"
        while self.accept_kw("on"):
            if self.accept_kw("delete"):
                tgt = "delete"
            else:
                self.expect_kw("update")
                tgt = "update"
            if self._accept_word("cascade"):
                act = "cascade"
            elif self._accept_word("restrict"):
                act = "restrict"
            elif self.accept_kw("set"):
                self.expect_kw("null")
                act = "set_null"
            elif self._accept_word("no"):
                self._expect_word("action")
                act = "restrict"  # NO ACTION == RESTRICT here (no
                # deferred checking exists)
            else:
                raise self.error("expected FK referential action")
            if tgt == "delete":
                on_delete = act
            else:
                on_update = act
        return cols, ref, refcols, on_delete, on_update

    def _parse_generated_expr(self):
        """(expr) [VIRTUAL | STORED] -> (ast, verbatim sql, stored)."""
        self.expect_op("(")
        p0 = self.peek().pos
        e = self.parse_expr()
        p1 = self.peek().pos
        self.expect_op(")")
        stored = True
        if self._accept_word("virtual"):
            stored = False
        elif self._accept_word("stored"):
            stored = True
        return e, self.sql[p0:p1].strip(), stored

    def _parse_check_expr(self):
        """CHECK ( expr ) -> (ast expr, verbatim sql text)."""
        self.expect_op("(")
        p0 = self.peek().pos
        e = self.parse_expr()
        p1 = self.peek().pos
        self.expect_op(")")
        return e, self.sql[p0:p1].strip()

    def _user_name(self) -> str:
        """'user'[@'host'] — host accepted and ignored (single node)."""
        t = self.next()
        user = t.text
        if self.accept_op("@"):
            self.next()  # host part
        return user

    def _create_view_tail(self, or_replace: bool) -> CreateViewStmt:
        schema = None
        name = self.expect_ident()
        if self.accept_op("."):
            schema, name = name, self.expect_ident()
        cols = None
        if self.accept_op("("):
            cols = [self.expect_ident()]
            while self.accept_op(","):
                cols.append(self.expect_ident())
            self.expect_op(")")
        self.expect_kw("as")
        start = self.peek().pos
        sel = self.parse_select_or_union()
        sql = self.sql[start : self.peek().pos].strip()
        return CreateViewStmt(name, cols, sel, sql, or_replace, schema)

    def parse_drop(self):
        self.expect_kw("drop")
        scope = "session"
        if self.at_kw("global", "session") and self.peek(1).text == "binding":
            scope = self.next().text
        if self.accept_kw("binding"):
            self.expect_kw("for")
            start = self.peek().pos
            self.parse_statement()
            sql = self.sql[start : self.peek().pos].strip()
            return DropBindingStmt(scope, sql)
        if self.accept_kw("view"):
            ie = self._if_exists()
            names = [self._table_name()]
            while self.accept_op(","):
                names.append(self._table_name())
            return DropViewStmt(names, ie)
        if self.accept_kw("database") or self.accept_kw("schema"):
            ie = self._if_exists()
            return DropDatabaseStmt(self.expect_ident(), ie)
        if self.accept_kw("user"):
            ie = self._if_exists()
            return DropUserStmt(self._user_name(), ie)
        if self.accept_kw("index"):
            name = self.expect_ident()
            self.expect_kw("on")
            return DropIndexStmt(name, self._table_name())
        self.expect_kw("table")
        ie = self._if_exists()
        tables = [self._table_name()]
        while self.accept_op(","):
            tables.append(self._table_name())
        return DropTableStmt(tables, ie)

    def _if_exists(self) -> bool:
        if self.accept_kw("if"):
            self.expect_kw("exists")
            return True
        return False

    def parse_alter(self) -> AlterTableStmt:
        self.expect_kw("alter")
        self.expect_kw("table")
        table = self._table_name()
        if self.accept_kw("add"):
            uniq = bool(self.accept_kw("unique"))
            if self.accept_kw("index") or self.accept_kw("key") or uniq:
                name = ""
                if self.peek().kind in ("IDENT", "QIDENT"):
                    name = self.expect_ident()
                return AlterTableStmt(table, "add_index",
                                      index=(name, self._paren_name_list()),
                                      unique=uniq)
            cname = ""
            if self.accept_kw("constraint"):
                if self.peek().kind in ("IDENT", "QIDENT") and \
                        self.peek().text.lower() != "check":
                    cname = self.expect_ident()
            if self.accept_kw("foreign"):
                self.expect_kw("key")
                return AlterTableStmt(table, "add_foreign_key",
                                      fk=self._parse_fk_spec(),
                                      new_name=cname)
            if self.peek().kind == "IDENT" and \
                    self.peek().text.lower() == "check":
                self.next()
                e, txt = self._parse_check_expr()
                return AlterTableStmt(table, "add_check", check=(cname, e, txt))
            self.accept_kw("column")
            return AlterTableStmt(table, "add_column", column=self.parse_column_def())
        if self.accept_kw("drop"):
            if self.accept_kw("foreign"):
                self.expect_kw("key")
                return AlterTableStmt(table, "drop_foreign_key",
                                      old_name=self.expect_ident())
            if self.peek().kind == "IDENT" and \
                    self.peek().text.lower() == "check":
                self.next()
                return AlterTableStmt(table, "drop_check",
                                      old_name=self.expect_ident())
            self.accept_kw("column")
            return AlterTableStmt(table, "drop_column", old_name=self.expect_ident())
        if self.accept_kw("rename"):
            self.accept_kw("to")
            return AlterTableStmt(table, "rename", new_name=self.expect_ident())
        if self.accept_kw("modify"):
            self.accept_kw("column")
            return AlterTableStmt(table, "modify_column", column=self.parse_column_def())
        if self._accept_word("shard"):
            # ALTER TABLE t SHARD BY ... — resharding DDL: new placement
            # metadata, schema_version bump (plan caches + placement
            # snapshots invalidate)
            self.expect_kw("by")
            return AlterTableStmt(table, "reshard",
                                  shard=self._parse_shard_spec())
        if self._accept_word("cluster"):
            # ALTER TABLE t CLUSTER BY (col) | CLUSTER BY NONE — ordered
            # compaction hint: the next delta->segment fold physically
            # re-sorts the table by this column (ISSUE 18)
            self.expect_kw("by")
            return AlterTableStmt(table, "cluster",
                                  cluster=self._parse_cluster_spec())
        raise self.error("unsupported ALTER TABLE action")

    # -- misc statements -----------------------------------------------------

    def parse_explain(self):
        self.next()  # explain/describe/desc
        t = self.peek()
        # DESCRIBE <table> is SHOW COLUMNS (MySQL shorthand) — but a
        # statement keyword (EXPLAIN REPLACE ..., EXPLAIN TRUNCATE ...)
        # still explains that statement
        if t.kind in ("IDENT", "QIDENT") or (
                t.kind == "KW" and t.text in _IDENTISH_KW
                and t.text not in _STMT_KWS):
            return ShowStmt("columns", target=self.expect_ident())
        analyze = bool(self.accept_kw("analyze"))
        start = self.peek().pos
        inner = self.parse_statement()
        try:
            inner._source = self.sql[start : self.peek().pos].strip()
        except AttributeError:
            pass
        return ExplainStmt(inner, analyze)

    def parse_set(self) -> SetStmt:
        self.expect_kw("set")
        assignments = []
        while True:
            scope = "session"
            if self.accept_kw("global"):
                scope = "global"
            elif self.accept_kw("session"):
                scope = "session"
            t = self.peek()
            if t.kind == "IDENT" and t.text.startswith("@@"):
                self.next()
                name = t.text[2:]
                for pre in ("global.", "session."):
                    if name.startswith(pre):
                        scope = pre[:-1]
                        name = name[len(pre):]
            elif t.kind == "IDENT" and t.text.startswith("@"):
                self.next()
                scope, name = "user", t.text[1:]
            else:
                name = self.expect_ident()
            self.accept_op("=") or self.accept_op(":=")
            value = self.parse_expr()
            assignments.append((scope, name, value))
            if not self.accept_op(","):
                break
        return SetStmt(assignments)

    def parse_show(self) -> ShowStmt:
        self.expect_kw("show")
        if self.accept_kw("databases"):
            return ShowStmt("databases")
        if self.accept_kw("tables"):
            like = self.next().text if self.accept_kw("like") else None
            return ShowStmt("tables", like=like)
        if self.accept_kw("columns"):
            self.expect_kw("from")
            return ShowStmt("columns", target=self.expect_ident())
        if self.accept_kw("create"):
            if self.accept_kw("view"):
                return ShowStmt("create_view", target=self.expect_ident())
            self.expect_kw("table")
            return ShowStmt("create_table", target=self.expect_ident())
        if self.accept_kw("global") or self.accept_kw("session"):
            pass
        if self.accept_kw("variables"):
            like = self.next().text if self.accept_kw("like") else None
            return ShowStmt("variables", like=like)
        if self.accept_kw("status"):
            return ShowStmt("status")
        if self._accept_word("processlist"):
            return ShowStmt("processlist")
        if self._accept_word("warnings"):
            return ShowStmt("warnings")
        if self.accept_kw("plugins"):
            return ShowStmt("plugins")
        if self.accept_kw("index") or (
                self.peek().kind == "IDENT"
                and self.peek().text.lower() in ("indexes", "keys")
                and self.next()):
            self.expect_kw("from")
            return ShowStmt("index", target=self.expect_ident())
        if self.accept_kw("bindings"):
            return ShowStmt("bindings")
        if self.accept_kw("grants"):
            user = None
            if self.accept_kw("for"):
                user = self._user_name()
            return ShowStmt("grants", target=user)
        raise self.error("unsupported SHOW")

    def _parse_priv_list(self):
        """SELECT, INSERT ... | ALL [PRIVILEGES] — lowercase names."""
        from tidb_tpu_torch.privilege import PRIV_KINDS

        if self.accept_kw("all"):
            self.accept_kw("privileges")
            return ["all"]
        privs = []
        while True:
            name = self.next().text.lower()
            if name not in PRIV_KINDS:
                raise self.error(f"unknown privilege {name!r}")
            privs.append(name)
            if not self.accept_op(","):
                return privs

    def _parse_priv_object(self):
        """*.* | db.* | db.table | table (current db resolved later)."""
        if self.accept_op("*"):
            if self.accept_op("."):
                self.expect_op("*")
                return "*", "*"
            return None, "*"  # MySQL: bare * = current database
        first = self.expect_ident()
        if self.accept_op("."):
            if self.accept_op("*"):
                return first, "*"
            return first, self.expect_ident()
        return None, first  # db = session default, filled by the executor

    def parse_grant(self):
        self.expect_kw("grant")
        privs = self._parse_priv_list()
        self.expect_kw("on")
        db, table = self._parse_priv_object()
        self.expect_kw("to")
        return GrantStmt(privs, db, table, self._user_name())

    def parse_revoke(self):
        self.expect_kw("revoke")
        privs = self._parse_priv_list()
        self.expect_kw("on")
        db, table = self._parse_priv_object()
        self.expect_kw("from")
        return RevokeStmt(privs, db, table, self._user_name())

    def _parse_over(self, fname: str, args, distinct: bool) -> EWindow:
        self.expect_kw("over")
        self.expect_op("(")
        if distinct:
            raise self.error("DISTINCT in window functions")
        part, order = [], []
        if self.accept_kw("partition"):
            self.expect_kw("by")
            part.append(self.parse_expr())
            while self.accept_op(","):
                part.append(self.parse_expr())
        if self.accept_kw("order"):
            self.expect_kw("by")
            while True:
                e = self.parse_expr()
                desc = False
                if self.accept_kw("desc"):
                    desc = True
                else:
                    self.accept_kw("asc")
                order.append(OrderItem(e, desc))
                if not self.accept_op(","):
                    break
        frame = None
        is_rows = self._accept_word("rows")
        if is_rows or self._accept_word("range"):
            def bound():
                if self._accept_word("unbounded"):
                    if self._accept_word("preceding"):
                        return ("unbounded_preceding",)
                    self._expect_word("following")
                    return ("unbounded_following",)
                if self._accept_word("current"):
                    self._expect_word("row")
                    return ("current",)
                if self.peek().kind != "NUM" or \
                        not self.peek().text.isdigit():
                    raise self.error("expected an integer frame bound")
                k = int(self.next().text)
                if self._accept_word("preceding"):
                    return ("preceding", k)
                self._expect_word("following")
                return ("following", k)

            if self.accept_kw("between"):
                lo = bound()
                self.expect_kw("and")
                hi = bound()
            else:
                lo, hi = bound(), ("current",)
            # MySQL ER_WINDOW_FRAME_*_ILLEGAL: bound CATEGORIES must be
            # ordered (offsets within a category are not validated,
            # matching MySQL — 5 PRECEDING AND 2 PRECEDING is legal)
            rank = {"unbounded_preceding": 0, "preceding": 1, "current": 2,
                    "following": 3, "unbounded_following": 4}
            if rank[lo[0]] > rank[hi[0]]:
                raise self.error(
                    "frame start cannot come after its end "
                    f"({lo[0].upper()} .. {hi[0].upper()})")
            kind = "rows" if is_rows else "range"
            if kind == "range" and any(
                    b[0] in ("preceding", "following") for b in (lo, hi)):
                raise self.error(
                    "RANGE frames with value offsets are not supported "
                    "(use ROWS)")
            frame = (kind, lo, hi)
        self.expect_op(")")
        return EWindow(fname, args, part, order, frame=frame)

    def _parse_hints(self, text: str):
        """'LEADING(a, b) MEMORY_QUOTA(1048576)' -> [(name, [args])]."""
        import re as _re

        out = []
        for m in _re.finditer(r"(\w+)\s*\(([^)]*)\)", text):
            args = [a.strip().strip("`") for a in m.group(2).split(",") if a.strip()]
            out.append((m.group(1).lower(), args))
        return out

    def parse_install(self) -> InstallPluginStmt:
        self.expect_kw("install")
        self.expect_kw("plugin")
        name = self.expect_ident()
        self.expect_kw("soname")
        module = self.next()
        if module.kind != "STR":
            raise self.error("SONAME needs a quoted module name")
        return InstallPluginStmt(name, module.text)

    def parse_uninstall(self) -> UninstallPluginStmt:
        self.expect_kw("uninstall")
        self.expect_kw("plugin")
        return UninstallPluginStmt(self.expect_ident())

    def parse_start_txn(self) -> BeginStmt:
        self.expect_kw("start")
        self.expect_kw("transaction")
        return BeginStmt()

    def parse_use(self) -> UseStmt:
        self.expect_kw("use")
        return UseStmt(self.expect_ident())

    def parse_truncate(self) -> TruncateStmt:
        self.expect_kw("truncate")
        self.accept_kw("table")
        return TruncateStmt(self._table_name())

    def parse_analyze(self) -> AnalyzeStmt:
        self.expect_kw("analyze")
        self.expect_kw("table")
        tables = [self._table_name()]
        while self.accept_op(","):
            tables.append(self._table_name())
        return AnalyzeStmt(tables)

    # -- expressions (Pratt) -------------------------------------------------

    def parse_expr(self):
        return self.parse_or()

    def parse_or(self):
        left = self.parse_xor()
        while self.at_kw("or") or self.at_op("||"):
            self.next()
            left = EBinary("or", left, self.parse_xor())
        return left

    def parse_xor(self):
        left = self.parse_and()
        while self.at_kw("xor"):
            self.next()
            left = EBinary("xor", left, self.parse_and())
        return left

    def parse_and(self):
        left = self.parse_not()
        while self.at_kw("and") or self.at_op("&&"):
            self.next()
            left = EBinary("and", left, self.parse_not())
        return left

    def parse_not(self):
        if self.accept_kw("not"):
            return EUnary("not", self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self):
        left = self.parse_bitor()
        while True:
            if self.at_op("=", "<>", "!=", "<", "<=", ">", ">=", "<=>"):
                op = self.next().text
                op = {"!=": "<>"}.get(op, op)
                right = self.parse_bitor()
                left = EBinary(op, left, right)
                continue
            negated = False
            save = self.pos
            if self.accept_kw("not"):
                negated = True
            if self.accept_kw("in"):
                self.expect_op("(")
                if self.at_kw("select", "with"):
                    sub = self.parse_select_or_union()
                    self.expect_op(")")
                    left = EIn(left, subquery=sub, negated=negated)
                else:
                    vals = [self.parse_expr()]
                    while self.accept_op(","):
                        vals.append(self.parse_expr())
                    self.expect_op(")")
                    left = EIn(left, values=vals, negated=negated)
                continue
            if self.accept_kw("between"):
                low = self.parse_bitor()
                self.expect_kw("and")
                high = self.parse_bitor()
                left = EBetween(left, low, high, negated=negated)
                continue
            if self.accept_kw("like"):
                pattern = self.parse_bitor()
                escape = None
                t = self.peek()
                if t.kind == "IDENT" and t.text.lower() == "escape":
                    self.next()
                    escape = self.next().text
                left = ELike(left, pattern, negated=negated, escape=escape)
                continue
            t = self.peek()
            if t.kind == "IDENT" and t.text.lower() in ("regexp", "rlike"):
                self.next()
                pattern = self.parse_bitor()
                left = ERegexp(left, pattern, negated=negated)
                continue
            if negated:
                self.pos = save
                break
            if self.accept_kw("is"):
                neg = bool(self.accept_kw("not"))
                if self.accept_kw("null"):
                    left = EIsNull(left, negated=neg)
                elif self.accept_kw("true"):
                    e = EBinary("<=>", left, EBool(True))
                    left = EUnary("not", e) if neg else e
                elif self.accept_kw("false"):
                    e = EBinary("<=>", left, EBool(False))
                    left = EUnary("not", e) if neg else e
                else:
                    raise self.error("expected NULL/TRUE/FALSE after IS")
                continue
            break
        return left

    def parse_bitor(self):
        left = self.parse_bitand()
        while self.at_op("|"):
            self.next()
            left = EBinary("|", left, self.parse_bitand())
        return left

    def parse_bitand(self):
        left = self.parse_shift()
        while self.at_op("&"):
            self.next()
            left = EBinary("&", left, self.parse_shift())
        return left

    def parse_shift(self):
        left = self.parse_additive()
        while self.at_op("<<", ">>"):
            op = self.next().text
            left = EBinary(op, left, self.parse_additive())
        return left

    def parse_additive(self):
        left = self.parse_multiplicative()
        while self.at_op("+", "-"):
            op = self.next().text
            left = EBinary(op, left, self.parse_multiplicative())
        return left

    def parse_multiplicative(self):
        left = self.parse_bitxor()
        while True:
            if self.at_op("*", "/", "%"):
                op = self.next().text
                left = EBinary({"%": "mod"}.get(op, op), left, self.parse_bitxor())
            elif self.peek().kind == "IDENT" and self.peek().text.lower() in ("div", "mod"):
                op = self.next().text.lower()
                left = EBinary(op, left, self.parse_bitxor())
            else:
                return left

    def parse_bitxor(self):
        # MySQL: ^ binds tighter than * /
        left = self.parse_unary()
        while self.at_op("^"):
            self.next()
            left = EBinary("^", left, self.parse_unary())
        return left

    def parse_unary(self):
        if self.at_op("-"):
            self.next()
            return EUnary("-", self.parse_unary())
        if self.at_op("+"):
            self.next()
            return self.parse_unary()
        if self.at_op("~"):
            self.next()
            return EUnary("~", self.parse_unary())
        if self.at_op("!"):
            self.next()
            return EUnary("not", self.parse_unary())
        return self.parse_postfix()

    def parse_postfix(self):
        left = self.parse_primary()
        # MySQL JSON path operators: col->'$.a' / col->>'$.a'
        while self.at_op("->", "->>"):
            op = self.next().text
            t = self.next()
            if t.kind != "STR":
                raise self.error("JSON path must be a quoted string")
            left = EFunc("json_extract", [left, EStr(t.text)])
            if op == "->>":
                left = EFunc("json_unquote", [left])
        return left

    def parse_primary(self):
        t = self.peek()

        if t.kind == "NUM":
            self.next()
            return ENum(t.text)
        if t.kind == "STR":
            self.next()
            return EStr(t.text)
        if t.kind == "PARAM":
            self.next()
            idx = self.param_count
            self.param_count += 1
            return EParam(idx)

        if t.kind == "KW":
            if self.accept_kw("null"):
                return ENull()
            if self.accept_kw("true"):
                return EBool(True)
            if self.accept_kw("false"):
                return EBool(False)
            if self.accept_kw("case"):
                return self.parse_case()
            if self.accept_kw("cast"):
                self.expect_op("(")
                arg = self.parse_expr()
                self.expect_kw("as")
                tt = self.next()
                ty = tt.text.lower()
                targs = ()
                if self.accept_op("("):
                    a = [int(self.next().text)]
                    while self.accept_op(","):
                        a.append(int(self.next().text))
                    self.expect_op(")")
                    targs = tuple(a)
                self.expect_op(")")
                return ECast(arg, ty, targs)
            if self.accept_kw("exists"):
                self.expect_op("(")
                sub = self.parse_select_or_union()
                self.expect_op(")")
                return EExists(sub)
            if self.accept_kw("extract"):
                # EXTRACT(unit FROM expr) -> unit(expr)
                self.expect_op("(")
                unit = self.next().text.lower()
                self.expect_kw("from")
                arg = self.parse_expr()
                self.expect_op(")")
                return EFunc(unit, [arg])
            if self.accept_kw("not"):
                return EUnary("not", self.parse_not())
            if self.accept_kw("interval"):
                val = self.parse_expr()
                unit = self.next().text.lower()
                return EInterval(val, unit)
            if self.at_kw("date", "time", "timestamp") and self.peek(1).kind == "STR":
                kw = self.next().text
                s = self.next().text
                return EFunc(kw, [EStr(s)])
            if t.text in _IDENTISH_KW:
                # keyword usable as function/identifier (e.g. LEFT(x,1))
                return self.parse_name_or_call()
            raise self.error(f"unexpected keyword {t.text.upper()} in expression")

        if t.kind in ("IDENT", "QIDENT"):
            if t.text.startswith("@@"):
                self.next()
                name = t.text[2:]
                scope = ""
                for pre in ("global.", "session."):
                    if name.startswith(pre):
                        scope, name = pre[:-1], name[len(pre):]
                return EVar(name, scope)
            if t.text.startswith("@"):
                self.next()
                return EVar(t.text, "user")
            return self.parse_name_or_call()

        if self.accept_op("("):
            if self.at_kw("select", "with"):
                sub = self.parse_select_or_union()
                self.expect_op(")")
                return ESubquery(sub)
            e = self.parse_expr()
            self.expect_op(")")
            return e

        if self.at_op("*"):
            self.next()
            return EStar()

        raise self.error("unexpected token in expression")

    def parse_name_or_call(self):
        name = self.expect_ident()
        if self.accept_op("("):
            fname = name.lower()
            if fname == "position":
                # POSITION(substr IN str) = LOCATE(substr, str); the
                # needle parses below IN precedence so IN stays the
                # separator
                sub = self.parse_bitor()
                self.expect_kw("in")
                s = self.parse_expr()
                self.expect_op(")")
                return EFunc("locate", [sub, s])
            distinct = bool(self.accept_kw("distinct"))
            args: List = []
            if not self.at_op(")"):
                if self.at_op("*"):
                    self.next()
                    args.append(EStar())
                else:
                    args.append(self.parse_expr())
                    while self.accept_op(","):
                        args.append(self.parse_expr())
            if fname == "group_concat":
                # GROUP_CONCAT(x [ORDER BY k [ASC|DESC], ...]
                #              [SEPARATOR 'sep'])
                agg_order = None
                sep = None
                if self.accept_kw("order"):
                    self.expect_kw("by")
                    agg_order = []
                    while True:
                        k = self.parse_expr()
                        desc = bool(self.accept_kw("desc"))
                        if not desc:
                            self.accept_kw("asc")
                        agg_order.append((k, desc))
                        if not self.accept_op(","):
                            break
                t = self.peek()
                if t.kind == "IDENT" and t.text.lower() == "separator":
                    self.next()
                    sep = self.next().text
                self.expect_op(")")
                return EFunc(fname, args, distinct=distinct,
                             agg_order=agg_order, separator=sep)
            self.expect_op(")")
            if self.at_kw("over"):
                return self._parse_over(fname, args, distinct)
            return EFunc(fname, args, distinct=distinct)
        if self.accept_op("."):
            t = self.peek()
            if self.at_op("*"):
                self.next()
                return EStar(qualifier=name)
            col = self.expect_ident()
            return EName(col, qualifier=name)
        return EName(name)

    def parse_case(self) -> ECase:
        operand = None
        if not self.at_kw("when"):
            operand = self.parse_expr()
        whens = []
        while self.accept_kw("when"):
            cond = self.parse_expr()
            self.expect_kw("then")
            whens.append((cond, self.parse_expr()))
        else_ = None
        if self.accept_kw("else"):
            else_ = self.parse_expr()
        self.expect_kw("end")
        return ECase(operand, whens, else_)


# keywords that may appear where identifiers/functions are expected
# keywords that start a parsable statement: EXPLAIN <stmt> keeps its
# meaning for these even though some double as identifiers
_STMT_KWS = {
    "select", "with", "insert", "replace", "update", "delete", "create",
    "drop", "alter", "set", "show", "begin", "start", "commit", "rollback",
    "use", "truncate", "analyze", "trace", "install", "uninstall",
}

_IDENTISH_KW = {
    "date", "time", "timestamp", "left", "right", "if", "replace", "values",
    "database", "schema", "comment", "status", "key", "engine", "truncate",
    # table/column positions (INFORMATION_SCHEMA names, user accounts)
    "tables", "columns", "column", "user", "variables", "trace",
    # non-reserved in MySQL: usable as identifiers
    "binding", "bindings", "plugin", "plugins", "soname",
    "install", "uninstall", "view", "duplicate",
    # INSERT(str, pos, len, newstr) the string function
    "insert",
    # non-reserved statement-leading words usable as column names
    "start", "begin", "rollback", "commit",
}
