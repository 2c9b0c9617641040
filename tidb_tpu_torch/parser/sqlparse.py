"""Hand-written SQL lexer + recursive-descent/Pratt parser.

Reference: pkg/parser — a 16,207-line goyacc grammar (parser.y) + lexer
(lexer.go). This framework needs the analytical/DML/DDL subset the engine
executes, so a compact Pratt parser replaces the generated LALR tables
(SURVEY.md §2.9 explicitly allows a hand-written parser for the subset).
MySQL-isms covered: backquoted identifiers, # / -- / C-style comments,
case-insensitive keywords, `LIMIT m, n`, DATE/INTERVAL literals,
IS [NOT] NULL, [NOT] BETWEEN/IN/LIKE/EXISTS, COUNT(DISTINCT ...).
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

from tidb_tpu_torch.dtypes import (
    BOOL, DATE, DATETIME, DECIMAL, FLOAT64, INT64, STRING, TIME, SQLType,
)
from tidb_tpu_torch.parser import ast


class ParseError(ValueError):
    pass


def dataclasses_replace_items(q, cols):
    import dataclasses as _dc

    items = [
        _dc.replace(it, alias=c) for it, c in zip(q.items, cols)
    ]
    return _dc.replace(q, items=items)


def dataclasses_replace(obj, **kw):
    import dataclasses as _dc

    return _dc.replace(obj, **kw)


_TOKEN_RE = re.compile(
    r"""
    (?P<hint>/\*\+.*?\*/)
  | (?P<ws>\s+|\#[^\n]*|--[^\n]*|/\*.*?\*/)
  | (?P<num>\d+\.\d*(?:[eE][+-]?\d+)?|\.\d+(?:[eE][+-]?\d+)?|\d+(?:[eE][+-]?\d+)?)
  | (?P<str>'(?:[^'\\]|\\.|'')*'|"(?:[^"\\]|\\.|"")*")
  | (?P<bq>`[^`]*`)
  | (?P<sysvar>@@[A-Za-z_][A-Za-z0-9_.$]*)
  | (?P<op><=>|<>|!=|>=|<=|\|\||&&|<<|>>|[-+*/%(),.;=<>?@&|^~])
  | (?P<id>[A-Za-z_][A-Za-z0-9_$]*)
    """,
    re.VERBOSE | re.DOTALL,
)

KEYWORDS = {
    "select", "from", "where", "group", "by", "having", "order", "limit",
    "offset", "as", "and", "or", "not", "in", "is", "null", "like",
    "between", "exists", "case", "when", "then", "else", "end", "cast",
    "join", "inner", "left", "right", "full", "outer", "cross", "on", "using",
    "distinct", "all", "asc", "desc", "true", "false", "interval",
    "create", "table", "database", "drop", "insert", "into", "values",
    "delete", "update", "set", "use", "explain", "analyze", "show",
    "tables", "databases", "if", "primary", "key", "div", "mod",
    "union", "date", "extract", "count", "sum", "avg", "min", "max",
    "group_concat", "separator", "index", "unique",
    "user", "grant", "revoke", "identified", "privileges", "to", "grants",
    "for", "auto_increment", "ttl", "backup", "restore", "import",
    "collate", "binding", "bindings", "intersect", "except",
    "global", "session", "variables", "trace", "begin", "commit", "alter", "column", "add", "default",
    "rollback", "start", "transaction", "analyze", "load", "data",
    "infile", "fields", "terminated", "lines", "ignore", "rows",
    "over", "partition", "with", "recursive", "local",
    "unbounded", "preceding", "following", "current", "row",
}

_WINDOW_ONLY_FUNCS = {
    "row_number", "rank", "dense_rank", "lag", "lead",
    "ntile", "first_value", "last_value", "nth_value",
    "percent_rank", "cume_dist",
}

# keywords that may also appear as function names in expression position
# (MySQL grammar does the same disambiguation, parser.y sysFuncCall rules)
_FUNC_KEYWORDS = {
    "mod", "left", "right", "if", "database", "user", "values", "insert",
}


class Token:
    __slots__ = ("kind", "text", "pos")

    def __init__(self, kind: str, text: str, pos: int):
        self.kind = kind  # num, str, id, kw, op
        self.text = text
        self.pos = pos

    def __repr__(self) -> str:  # pragma: no cover
        return f"{self.kind}:{self.text}"


def tokenize(sql: str) -> List[Token]:
    out: List[Token] = []
    i = 0
    while i < len(sql):
        m = _TOKEN_RE.match(sql, i)
        if not m:
            raise ParseError(f"bad character {sql[i]!r} at {i}")
        i = m.end()
        if m.lastgroup == "ws":
            continue
        text = m.group()
        kind = m.lastgroup
        if kind == "hint":
            out.append(Token("hint", text[3:-2].strip(), m.start()))
        elif kind == "bq":
            out.append(Token("id", text[1:-1], m.start()))
        elif kind == "sysvar":
            out.append(Token("sysvar", text[2:], m.start()))
        elif kind == "id":
            low = text.lower()
            out.append(Token("kw" if low in KEYWORDS else "id", low if low in KEYWORDS else text, m.start()))
        elif kind == "str":
            q = text[0]
            body = text[1:-1].replace(q + q, q)
            if "\\" in body:  # most literals have no escape: skip the regex
                body = re.sub(r"\\(.)", lambda mm: {"n": "\n", "t": "\t", "0": "\0"}.get(mm.group(1), mm.group(1)), body)
            out.append(Token("str", body, m.start()))
        else:
            out.append(Token(kind, text, m.start()))
    out.append(Token("eof", "", len(sql)))
    return out


_TYPE_MAP = {
    "int": INT64, "integer": INT64, "bigint": INT64, "smallint": INT64,
    "tinyint": INT64, "double": FLOAT64, "float": FLOAT64, "real": FLOAT64,
    "varchar": STRING, "char": STRING, "text": STRING, "string": STRING,
    "date": DATE, "datetime": DATETIME, "timestamp": DATETIME,
    "time": TIME, "boolean": BOOL, "bool": BOOL,
}


class Parser:
    def __init__(self, sql: str):
        self.sql = sql  # raw text (binding statements capture substrings)
        toks = tokenize(sql)
        # hints are only honored right after the SELECT verb (the one
        # position parse_select consumes them); anywhere else /*+ ... */
        # degrades to a comment, as before hint tokens existed
        self.toks = [
            t for j, t in enumerate(toks)
            if t.kind != "hint"
            or (j > 0 and toks[j - 1].kind == "kw" and toks[j - 1].text == "select")
        ]
        self.i = 0
        self._param_count = 0  # '?' placeholders seen (prepared stmts)

    # -- token helpers -----------------------------------------------------
    @property
    def cur(self) -> Token:
        return self.toks[self.i]

    def advance(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        return self.cur.kind == "kw" and self.cur.text in kws

    def at_op(self, *ops: str) -> bool:
        return self.cur.kind == "op" and self.cur.text in ops

    def accept_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.advance()
            return True
        return False

    def accept_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.advance()
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.accept_kw(kw):
            raise ParseError(f"expected {kw.upper()}, got {self.cur.text!r} at {self.cur.pos}")

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            raise ParseError(f"expected {op!r}, got {self.cur.text!r} at {self.cur.pos}")

    # soft keywords: reserved only where their grammar needs them, usable
    # as identifiers elsewhere (MySQL keeps these non-reserved; globally
    # reserving them would break tables with e.g. a `current` column)
    _SOFT_KW = (
        "date", "key", "tables", "databases", "count", "sum", "avg", "min",
        "max", "unbounded", "preceding", "following", "current", "row",
        "column", "add", "default", "alter", "index", "unique", "separator",
        "user", "to", "for", "grants", "privileges",
        "backup", "restore", "import", "ttl",
    )

    def expect_ident(self) -> str:
        t = self.cur
        if t.kind == "id" or (t.kind == "kw" and t.text in self._SOFT_KW):
            self.advance()
            return t.text
        raise ParseError(f"expected identifier, got {t.text!r} at {t.pos}")

    # -- entry -------------------------------------------------------------
    def parse_stmt(self):
        if self.cur.kind == "id" and self.cur.text.lower() == "replace":
            # REPLACE INTO ... (statement position only; replace() stays
            # a plain function elsewhere)
            self.advance()
            stmt = self.parse_insert(skip_verb=True)
            stmt.replace = True
            return stmt
        if self.at_kw("select") or self.at_op("("):
            return self.parse_select_or_union()
        if self.at_kw("with"):
            return self.parse_with()
        if self.at_kw("explain"):
            self.advance()
            analyze = self.accept_kw("analyze")
            return ast.Explain(self.parse_stmt(), analyze=analyze)
        if self.at_kw("create"):
            return self.parse_create()
        if self.at_kw("alter"):
            return self.parse_alter()
        if self.at_kw("drop"):
            return self.parse_drop()
        if self.at_kw("insert"):
            return self.parse_insert()
        if self.at_kw("delete"):
            return self.parse_delete()
        if self.at_kw("update"):
            return self.parse_update()
        if self.at_kw("use"):
            self.advance()
            return ast.UseDatabase(self.expect_ident())
        if self._at_ident("truncate"):
            self.advance()
            self.accept_kw("table")
            db, name = self._qualified_name()
            return ast.TruncateTable(db, name)
        if self._at_ident("do"):
            self.advance()
            exprs = [self.parse_expr()]
            while self.accept_op(","):
                exprs.append(self.parse_expr())
            return ast.Do(exprs)
        if self._at_ident("flush"):
            # FLUSH PRIVILEGES/TABLES/STATUS/...: accepted, no effect
            # (privileges apply immediately here; no table cache)
            while self.cur.kind != "eof" and not self.at_op(";"):
                self.advance()
            return ast.Noop("flush")
        if self._at_ident("lock"):
            self.advance()
            self.expect_kw("tables")
            while self.cur.kind != "eof" and not self.at_op(";"):
                self.advance()
            return ast.Noop("lock_tables")
        if self._at_ident("unlock"):
            self.advance()
            self.expect_kw("tables")
            return ast.Noop("unlock_tables")
        if self._at_ident("check") and self.toks[self.i + 1].kind == "kw" \
                and self.toks[self.i + 1].text == "table":
            self.advance()
            self.expect_kw("table")
            tables = [self._qualified_name()]
            while self.accept_op(","):
                tables.append(self._qualified_name())
            return ast.AdminStmt("check_table_status", tables)
        if self._at_ident("checksum"):
            self.advance()
            self.expect_kw("table")
            tables = [self._qualified_name()]
            while self.accept_op(","):
                tables.append(self._qualified_name())
            return ast.AdminStmt("checksum_table", tables)
        if self._at_ident("optimize"):
            self.advance()
            self.expect_kw("table")
            tables = [self._qualified_name()]
            while self.accept_op(","):
                tables.append(self._qualified_name())
            return ast.OptimizeTable(tables)
        if self._at_ident("admin"):
            self.advance()
            word = self.cur.text.lower()  # CHECK/SHOW may lex as kw
            if word == "check":
                self.advance()
                if self.accept_kw("table"):
                    tables = [self._qualified_name()]
                    while self.accept_op(","):
                        tables.append(self._qualified_name())
                    return ast.AdminStmt("check_table", tables)
                if self.accept_kw("index"):
                    tbl = self._qualified_name()
                    if self.cur.text.lower() == "primary":  # kw, not id
                        self.advance()
                        return ast.AdminStmt(
                            "check_index", [tbl], index="primary"
                        )
                    return ast.AdminStmt(
                        "check_index", [tbl], index=self.expect_ident()
                    )
                raise ParseError("ADMIN CHECK supports TABLE / INDEX")
            if word == "show":
                self.advance()
                self._expect_ident_kw("ddl")
                if self._at_ident("jobs"):
                    self.advance()
                return ast.AdminStmt("show_ddl")
            if word == "checksum":
                self.advance()
                self.expect_kw("table")
                tables = [self._qualified_name()]
                while self.accept_op(","):
                    tables.append(self._qualified_name())
                return ast.AdminStmt("checksum_table", tables)
            raise ParseError(
                "ADMIN supports CHECK TABLE/INDEX, SHOW DDL, "
                "CHECKSUM TABLE"
            )
        if self._at_ident("changefeed"):
            # CHANGEFEED START TO 'uri' / STOP / STATUS (CDC controls)
            self.advance()
            word = self.cur.text.lower()
            if word == "stop":
                self.advance()
                return ast.ChangefeedStmt("stop")
            if word == "status":
                self.advance()
                return ast.ChangefeedStmt("status")
            if word == "start":
                self.advance()
                self.expect_kw("to")
                t = self.advance()
                if t.kind != "str":
                    raise ParseError("CHANGEFEED START expects a string URI")
                return ast.ChangefeedStmt("start", t.text)
            raise ParseError("CHANGEFEED supports START TO | STOP | STATUS")
        if self._at_ident("rename"):
            self.advance()
            self.expect_kw("table")
            pairs = []
            while True:
                src = self._qualified_name()
                self._expect_ident_kw("to")
                pairs.append((src, self._qualified_name()))
                if not self.accept_op(","):
                    break
            return ast.RenameTable(pairs)
        if self._at_ident("kill"):
            # KILL [QUERY | CONNECTION] <connection id>
            self.advance()
            query_only = False
            if self._at_ident("query"):
                self.advance()
                query_only = True
            elif self._at_ident("connection"):
                self.advance()
            t = self.advance()
            try:
                cid = int(t.text)
            except ValueError:
                raise ParseError(
                    f"KILL expects a numeric connection id, got {t.text!r}"
                )
            return ast.Kill(cid, query_only=query_only)
        if (
            self._at_ident("plan")
            and self.toks[self.i + 1].kind == "id"
            and self.toks[self.i + 1].text.lower() == "replayer"
        ):
            # PLAN REPLAYER DUMP EXPLAIN <stmt>
            self.advance()  # plan
            self.advance()  # replayer
            if not self._at_ident("dump"):
                raise ParseError(
                    f"expected DUMP after PLAN REPLAYER at {self.cur.pos}"
                )
            self.advance()
            self.expect_kw("explain")
            pos0 = self.cur.pos
            inner = self.parse_stmt()
            return ast.PlanReplayer(inner, sql_text=self.sql[pos0:].strip())
        if self._at_ident("prepare"):
            # PREPARE name FROM '<sql>'
            self.advance()
            name = self.expect_ident()
            self.expect_kw("from")
            t = self.cur
            if t.kind != "str":
                raise ParseError(f"expected statement string at {t.pos}")
            self.advance()
            return ast.PrepareStmt(name.lower(), t.text)
        if self._at_ident("execute"):
            self.advance()
            name = self.expect_ident()
            using = []
            if self.at_kw("using") or self._at_ident("using"):
                self.advance()
                while True:
                    self.expect_op("@")
                    using.append(self.expect_ident().lower())
                    if not self.accept_op(","):
                        break
            return ast.ExecuteStmt(name.lower(), using)
        if self._at_ident("deallocate"):
            self.advance()
            if not self._at_ident("prepare"):
                raise ParseError("expected PREPARE after DEALLOCATE")
            self.advance()
            return ast.DeallocateStmt(self.expect_ident().lower())
        if self._at_ident("describe") or self.at_kw("desc"):
            self.advance()
            if self.at_kw("select", "with"):
                return ast.Explain(self.parse_stmt())
            db, name = self._qualified_name()
            return ast.Show("columns", db=f"{db or ''}.{name}")
        if self.at_kw("show"):
            self.advance()
            if self.at_kw("full"):  # FULL lexes as a keyword (joins)
                self.advance()  # SHOW FULL PROCESSLIST/COLUMNS/TABLES
            if self._at_ident("warnings") or self._at_ident("errors"):
                self.advance()
                return ast.Show("warnings")
            if self._at_ident("status"):
                self.advance()
                return ast.Show("status", db=self._show_like())
            if self._at_ident("open"):
                self.advance()
                self.expect_kw("tables")
                return ast.Show("open_tables")
            if self.accept_kw("tables"):
                return ast.Show("tables")
            if self.at_kw("table") and (
                self.toks[self.i + 1].text.lower() == "status"
            ):
                self.advance()  # table
                self.advance()  # status
                return ast.Show("table_status", db=self._show_like())
            if self._at_ident("columns") or self._at_ident("fields"):
                self.advance()
                self.expect_kw("from")
                db, name = self._qualified_name()
                return ast.Show("columns", db=f"{db or ''}.{name}")
            if self.accept_kw("databases"):
                return ast.Show("databases")
            if self.accept_kw("global") or self.accept_kw("session"):
                # scope is cosmetic for the memtables behind both
                if self._at_ident("status"):
                    self.advance()
                    return ast.Show("status", db=self._show_like())
                self.expect_kw("variables")
                return ast.Show("variables", db=self._show_like())
            if self.accept_kw("variables"):
                return ast.Show("variables", db=self._show_like())
            if self.accept_kw("bindings"):
                return ast.Show("bindings")
            if self._at_ident("processlist"):
                self.advance()
                return ast.Show("processlist")
            if self.accept_kw("grants"):
                user = None
                if self.accept_kw("for"):
                    user = self._user_name()
                return ast.Show("grants", db=user)
            if self.accept_kw("index") or self._at_ident("indexes") \
                    or self._at_ident("keys"):
                if self.cur.kind == "id":  # consume the alias word
                    self.advance()
                self.expect_kw("from")
                db, name = self._qualified_name()
                return ast.Show("index", db=f"{db or ''}.{name}")
            if self._at_ident("collation"):
                self.advance()
                return ast.Show("collation", db=self._show_like())
            if self._at_ident("character") or self._at_ident("charset"):
                if self._at_ident("character"):
                    self.advance()
                    self.expect_kw("set")
                else:
                    self.advance()
                return ast.Show("charset", db=self._show_like())
            if self._at_ident("engines"):
                self.advance()
                return ast.Show("engines")
            if self.accept_kw("create"):
                if self.accept_kw("database"):
                    return ast.Show(
                        "create_database", db=self.expect_ident()
                    )
                what = (
                    "create_view"
                    if self._at_ident("view")
                    else "create_table" if self.at_kw("table") else None
                )
                if what is None:
                    raise ParseError("SHOW CREATE supports TABLE | VIEW")
                self.advance()
                db, name = self._qualified_name()
                return ast.Show(what, db=f"{db or ''}.{name}")
            raise ParseError(
                "SHOW supports TABLES | DATABASES | VARIABLES | GRANTS | "
                "INDEX | CREATE TABLE/VIEW"
            )
        if self.at_kw("grant", "revoke"):
            return self.parse_grant_revoke()
        if self.at_kw("backup", "restore"):
            # BACKUP DATABASE <db>|* TO 'dir' / RESTORE ... FROM 'dir'
            # BACKUP LOG TO 'uri' / RESTORE POINT FROM 'uri' UNTIL <ts>
            restore = self.advance().text.lower() == "restore"
            if not restore and self._at_ident("log"):
                self.advance()
                if self._at_ident("stop"):
                    self.advance()
                    return ast.BackupLog("stop")
                if self._at_ident("status"):
                    self.advance()
                    return ast.BackupLog("status")
                self.expect_kw("to")
                t = self.advance()
                if t.kind != "str":
                    raise ParseError("BACKUP LOG expects a string URI")
                return ast.BackupLog("start", t.text)
            if restore and self._at_ident("point"):
                self.advance()
                self.expect_kw("from")
                t = self.advance()
                if t.kind != "str":
                    raise ParseError("RESTORE POINT expects a string URI")
                if not self._at_ident("until"):
                    raise ParseError("RESTORE POINT requires UNTIL <unix ts>")
                self.advance()
                ts = self.advance()
                if ts.kind != "num":
                    raise ParseError("UNTIL expects a numeric unix timestamp")
                return ast.RestorePoint(t.text, float(ts.text))
            self.expect_kw("database")
            db = None if self.accept_op("*") else self.expect_ident()
            self.expect_kw("from" if restore else "to")
            t = self.advance()
            if t.kind != "str":
                raise ParseError("BACKUP/RESTORE expects a string path")
            return ast.BackupRestore(restore, db, t.text)
        if self.at_kw("import"):
            # IMPORT INTO t FROM 'file' [FIELDS TERMINATED BY 'sep']
            self.advance()
            self.expect_kw("into")
            db, name = self._qualified_name()
            self.expect_kw("from")
            t = self.advance()
            if t.kind != "str":
                raise ParseError("IMPORT INTO expects a string path")
            sep = "\t"
            if self.accept_kw("fields"):
                self.expect_kw("terminated")
                self.expect_kw("by")
                st = self.advance()
                if st.kind != "str":
                    raise ParseError("TERMINATED BY expects a string")
                sep = st.text
            return ast.ImportInto(db, name, t.text, sep)
        if self.at_kw("set"):
            return self.parse_set()
        if self.at_kw("trace"):
            self.advance()
            return ast.Trace(self.parse_stmt())
        if self.at_kw("begin"):
            self.advance()
            return ast.TxnControl("begin")
        if self.at_kw("start"):
            self.advance()
            self.expect_kw("transaction")
            ro = False
            while True:
                if self.accept_kw("with"):
                    # WITH CONSISTENT SNAPSHOT: already the engine's
                    # only behavior (pinned MVCC snapshot at begin)
                    self._expect_ident_kw("consistent")
                    self._expect_ident_kw("snapshot")
                elif self._at_ident("read"):
                    self.advance()
                    acc = self.expect_ident().lower()
                    if acc == "only":
                        ro = True
                    elif acc != "write":
                        raise ParseError(
                            "expected READ ONLY or READ WRITE"
                        )
                else:
                    break
                if not self.accept_op(","):
                    break
            return ast.TxnControl("begin", read_only=ro)
        if self.at_kw("commit"):
            self.advance()
            return ast.TxnControl("commit")
        if self.at_kw("rollback"):
            self.advance()
            if self.accept_kw("to"):
                if self._at_ident("savepoint"):
                    self.advance()
                return ast.TxnControl("rollback_to", self.expect_ident())
            return ast.TxnControl("rollback")
        if self._at_ident("savepoint"):
            self.advance()
            return ast.TxnControl("savepoint", self.expect_ident())
        if self._at_ident("release"):
            self.advance()
            if not self._at_ident("savepoint"):
                raise ParseError("expected SAVEPOINT after RELEASE")
            self.advance()
            return ast.TxnControl("release", self.expect_ident())
        if self.at_kw("analyze"):
            self.advance()
            self.expect_kw("table")
            db, name = self._qualified_name()
            return ast.AnalyzeTable(db, name)
        if self.at_kw("load"):
            return self.parse_load()
        raise ParseError(f"unsupported statement start {self.cur.text!r}")

    def _show_like(self):
        if self.accept_kw("like"):
            t = self.cur
            if t.kind != "str":
                raise ParseError("SHOW VARIABLES LIKE expects a string")
            self.advance()
            return t.text
        return None

    def parse_set(self):
        self.expect_kw("set")
        if self.at_op("@"):
            # SET @name = <literal> (user variable; EXECUTE ... USING)
            self.advance()
            uname = self.expect_ident().lower()
            self.expect_op("=")
            val = self.parse_expr()
            if (
                isinstance(val, ast.Call)
                and val.op == "neg"
                and len(val.args) == 1
                and isinstance(val.args[0], ast.Const)
                and isinstance(val.args[0].value, (int, float))
            ):
                val = ast.Const(-val.args[0].value)
            if not isinstance(val, ast.Const):
                raise ParseError("user variables accept literal values")
            return ast.SetVariable("@" + uname, val.value, "user")
        if self._at_ident("resource"):
            # SET RESOURCE GROUP <name>: bind this session to a group
            self.advance()
            self._expect_ident_kw("group")
            return ast.SetResourceGroup(self.expect_ident())
        if self._at_ident("names"):
            self.advance()
            charset = self.cur.text
            self.advance()
            coll = None
            if self.accept_kw("collate"):
                coll = self.cur.text
                self.advance()
            return ast.SetNames(charset, coll)
        scope = "session"
        if self.accept_kw("global"):
            scope = "global"
        else:
            self.accept_kw("session")
        if self.at_kw("transaction"):
            self.advance()
            iso = access = None
            while True:
                w = self.cur.text.lower()
                if w == "isolation":
                    self.advance()
                    self._expect_ident_kw("level")
                    w1 = self.cur.text.lower()
                    self.advance()
                    if w1 in ("read", "repeatable"):
                        w2 = self.cur.text.lower()
                        self.advance()
                        iso = f"{w1}-{w2}".upper()
                    else:
                        iso = w1.upper()
                elif w == "read":
                    self.advance()
                    access = self.cur.text.lower()
                    if access not in ("only", "write"):
                        raise ParseError(
                            "SET TRANSACTION READ expects ONLY or WRITE"
                        )
                    self.advance()
                else:
                    raise ParseError(
                        "SET TRANSACTION expects ISOLATION LEVEL or "
                        "READ ONLY/WRITE"
                    )
                if not self.accept_op(","):
                    break
            return ast.SetTransaction(scope, iso, access)
        name = self._set_var_name()
        self.expect_op("=")
        if self.at_kw("on"):
            # MySQL bareword switch value: ON is a keyword to this
            # tokenizer (JOIN ... ON), so the expression path would
            # reject `SET GLOBAL tidb_enable_top_sql = ON`; OFF is a
            # plain identifier and already rides the bareword branch
            self.advance()
            return ast.SetVariable(name, "ON", scope)
        val = self.parse_expr()
        if not isinstance(val, ast.Const):
            if isinstance(val, ast.Name):  # bareword values like utf8mb4
                val = ast.Const(val.column)
            elif isinstance(val, ast.Call) and val.op == "neg" and isinstance(val.args[0], ast.Const):
                val = ast.Const(-val.args[0].value)
            else:
                raise ParseError("SET value must be a literal")
        return ast.SetVariable(name, val.value, scope)

    def _set_var_name(self) -> str:
        # @@[global.|session.]name or bare name
        t = self.cur
        if t.kind == "sysvar":
            self.advance()
            rest = t.text
            for pre in ("global.", "session."):
                if rest.lower().startswith(pre):
                    return rest[len(pre):]
            return rest
        return self.expect_ident()

    def parse_load(self):
        self.expect_kw("load")
        self.expect_kw("data")
        self.accept_kw("local")
        self.expect_kw("infile")
        t = self.cur
        if t.kind != "str":
            raise ParseError("LOAD DATA INFILE expects a path string")
        self.advance()
        path = t.text
        self.expect_kw("into")
        self.expect_kw("table")
        db, name = self._qualified_name()
        sep = "\t"
        if self.accept_kw("fields"):
            self.expect_kw("terminated")
            self.expect_kw("by")
            st = self.cur
            if st.kind != "str":
                raise ParseError("FIELDS TERMINATED BY expects a string")
            self.advance()
            sep = st.text
        return ast.LoadData(db, name, path, sep)

    # -- SELECT / UNION / WITH --------------------------------------------
    def _order_limit_tail(self):
        order_by: List[ast.OrderItem] = []
        limit = offset = None
        if self.accept_kw("order"):
            self.expect_kw("by")
            order_by.append(self.parse_order_item())
            while self.accept_op(","):
                order_by.append(self.parse_order_item())
        if self.accept_kw("limit"):
            a = self.parse_int()
            if self.accept_op(","):
                offset, limit = a, self.parse_int()
            elif self.accept_kw("offset"):
                limit, offset = a, self.parse_int()
            else:
                limit = a
        return order_by, limit, offset

    def parse_select_or_union(self):
        first = self._parse_select_block()
        while self.at_kw("intersect", "except"):
            op = self.advance().text
            if self.accept_kw("all"):
                raise ParseError(f"{op.upper()} ALL is not supported")
            self.accept_kw("distinct")
            right = self._parse_select_block()
            first = ast.SetOp(op, first, right)
        if isinstance(first, ast.SetOp):
            order_by, limit, offset = self._order_limit_tail()
            # the greedy SELECT parser attaches a trailing ORDER BY/LIMIT
            # to the last branch; it belongs to the whole set operation
            # (same hoist as the UNION path below)
            last = first.right
            if not order_by and isinstance(last, ast.Select) and last.order_by:
                order_by = last.order_by
                first.right = dataclasses_replace(last, order_by=[])
            last = first.right
            if (
                limit is None
                and isinstance(last, ast.Select)
                and last.limit is not None
            ):
                limit, offset = last.limit, last.offset
                first.right = dataclasses_replace(
                    last, limit=None, offset=None
                )
            first.order_by, first.limit, first.offset = order_by, limit, offset
            return first
        if not self.at_kw("union"):
            return first
        selects = [first]
        is_all = True
        while self.accept_kw("union"):
            if self.accept_kw("all"):
                part_all = True
            else:
                self.accept_kw("distinct")
                part_all = False
            is_all = is_all and part_all
            selects.append(self._parse_select_block())
        order_by, limit, offset = self._order_limit_tail()
        # MySQL: a trailing ORDER BY/LIMIT after the last unparenthesized
        # branch belongs to the whole UNION, but the greedy SELECT parser
        # already attached it to that branch — move it up.
        last = selects[-1]
        if not order_by and isinstance(last, ast.Select) and last.order_by:
            order_by, last = last.order_by, dataclasses_replace(last, order_by=[])
            selects[-1] = last
        if limit is None and isinstance(last, ast.Select) and last.limit is not None:
            limit, offset = last.limit, last.offset
            selects[-1] = dataclasses_replace(last, limit=None, offset=None)
        return ast.Union(selects, is_all, order_by, limit, offset)

    def _parse_select_block(self):
        if self.accept_op("("):
            s = self.parse_select_or_union()
            self.expect_op(")")
            return s
        return self.parse_select()

    def parse_with(self):
        self.expect_kw("with")
        recursive = bool(self.accept_kw("recursive"))
        ctes = []
        while True:
            name = self.expect_ident()
            if self.accept_op("("):
                # column list — accepted and applied as aliases
                cols = [self.expect_ident()]
                while self.accept_op(","):
                    cols.append(self.expect_ident())
                self.expect_op(")")
            else:
                cols = None
            self.expect_kw("as")
            self.expect_op("(")
            q = self.parse_select_or_union()
            self.expect_op(")")
            if cols is not None:
                target = q.selects[0] if isinstance(q, ast.Union) else q
                if not isinstance(target, ast.Select):
                    raise ParseError("CTE column list needs a SELECT body")
                if len(cols) != len(target.items):
                    raise ParseError("CTE column list arity mismatch")
                renamed = dataclasses_replace_items(target, cols)
                if isinstance(q, ast.Union):
                    q = dataclasses_replace(q, selects=[renamed] + q.selects[1:])
                else:
                    q = renamed
            ctes.append((name.lower(), q))
            if not self.accept_op(","):
                break
        body = self.parse_select_or_union()
        return ast.With(ctes, body, recursive=recursive)

    @staticmethod
    def _parse_hints(text: str) -> tuple:
        """'/*+ NAME(a, 1) NAME2() */' inner text -> ((name, (args...)), ...)
        (reference: pkg/parser/hintparser.y; unknown hints are kept and
        ignored downstream, like MySQL warns-and-continues)."""
        out = []
        for m in re.finditer(r"([A-Za-z_][A-Za-z0-9_]*)\s*\(([^)]*)\)", text):
            name = m.group(1).lower()
            args = tuple(
                a.strip().strip("'\"`") for a in m.group(2).split(",") if a.strip()
            )
            out.append((name, args))
        return tuple(out)

    def _accept_priority(self):
        """HIGH_PRIORITY / LOW_PRIORITY select modifier -> "high" /
        "low" / None. MySQL reserves these words, but THIS dialect
        does not (a column may legally be named high_priority), so
        the identifier is consumed as a modifier only when the next
        token can begin a select item: `select high_priority a from t`
        is a modifier, `select high_priority from t` and
        `select high_priority, 1 from t` keep reading the column."""
        if self.cur.kind != "id":
            return None
        word = self.cur.text.lower()
        if word not in ("high_priority", "low_priority"):
            return None
        nxt = self.toks[self.i + 1]
        if nxt.kind == "eof":
            return None
        if nxt.kind == "op":
            if nxt.text == "*":
                # `high_priority *` is the all-columns item only when
                # the star is not a multiplication: peek one further
                after = self.toks[self.i + 2]
                star_is_item = after.kind == "eof" or (
                    after.kind == "kw" and after.text == "from"
                ) or (after.kind == "op" and after.text in (",", ";"))
                if not star_is_item:
                    return None
            elif nxt.text != "(":
                # ',', '.', ')', arithmetic... — the identifier is a
                # column reference continuing an expression
                return None
        elif nxt.kind == "kw" and nxt.text in (
            "from", "as", "where", "group", "having", "order", "limit",
            "union", "for", "into",
        ):
            return None
        self.advance()
        return "high" if word == "high_priority" else "low"

    def parse_select(self) -> ast.Select:
        if not hasattr(self, "_pending_win_refs"):
            self._pending_win_refs = []
        _win_mark = len(self._pending_win_refs)
        self.expect_kw("select")
        hints = ()
        if self.cur.kind == "hint":
            hints = self._parse_hints(self.advance().text)
        # MySQL statement priority modifiers (reserved words in MySQL;
        # accepted before or after ALL/DISTINCT like the reference's
        # select-option list): SELECT HIGH_PRIORITY ... maps into the
        # serving tier's admission queue (parallel/serving.py)
        priority = self._accept_priority()
        distinct = False
        if self.accept_kw("distinct"):
            distinct = True
        else:
            self.accept_kw("all")
        if priority is None:
            priority = self._accept_priority()
        items = [self.parse_select_item()]
        while self.accept_op(","):
            items.append(self.parse_select_item())
        from_ = None
        if self.accept_kw("from"):
            from_ = self.parse_table_refs()
        where = self.parse_expr() if self.accept_kw("where") else None
        group_by: List[object] = []
        rollup = False
        if self.accept_kw("group"):
            self.expect_kw("by")
            group_by.append(self.parse_expr())
            while self.accept_op(","):
                group_by.append(self.parse_expr())
            if self.accept_kw("with"):
                self._expect_ident_kw("rollup")
                rollup = True
        having = self.parse_expr() if self.accept_kw("having") else None
        windows = {}
        if self._at_ident("window"):
            self.advance()
            while True:
                wname = self.expect_ident().lower()
                if wname in windows:
                    raise ParseError(f"duplicate window name {wname!r}")
                self.expect_kw("as")
                windows[wname] = self._parse_window_spec()
                if not self.accept_op(","):
                    break
        order_by: List[ast.OrderItem] = []
        if self.accept_kw("order"):
            self.expect_kw("by")
            order_by.append(self.parse_order_item())
            while self.accept_op(","):
                order_by.append(self.parse_order_item())
        limit = offset = None
        if self.accept_kw("limit"):
            a = self.parse_int()
            if self.accept_op(","):
                offset, limit = a, self.parse_int()
            elif self.accept_kw("offset"):
                limit, offset = a, self.parse_int()
            else:
                limit = a
        for_update = False
        outfile = None
        if self.accept_kw("into"):
            if not self._at_ident("outfile"):
                raise ParseError("expected OUTFILE after INTO")
            self.advance()
            if self.cur.kind != "str":
                raise ParseError("INTO OUTFILE expects a file path string")
            outfile = self.cur.text
            self.advance()
        if self.at_kw("for") and (
            self.toks[self.i + 1].text.lower() in ("update", "share")
        ):
            self.advance()
            self.advance()
            for_update = True
        elif (
            self.cur.kind == "id" and self.cur.text.lower() == "lock"
        ):  # LOCK IN SHARE MODE: read lock (same table lock here)
            self.advance()
            self.expect_kw("in")
            for word in ("share", "mode"):
                if self.cur.text.lower() != word:
                    raise ParseError(
                        f"expected {word.upper()} at {self.cur.pos}"
                    )
                self.advance()
            for_update = True
        sel = ast.Select(
            items=items, from_=from_, where=where, group_by=group_by,
            having=having, order_by=order_by, limit=limit, offset=offset,
            distinct=distinct, hints=hints, for_update=for_update,
            outfile=outfile, rollup=rollup, priority=priority,
        )
        # resolve THIS block's OVER w references in place — refs below
        # _win_mark belong to an enclosing select, refs above it were
        # already resolved and truncated by nested selects
        for wc in self._pending_win_refs[_win_mark:]:
            spec = windows.get(wc.window_ref)
            if spec is None:
                raise ParseError(f"unknown window {wc.window_ref!r}")
            wc.partition_by, wc.order_by, wc.frame = spec
            wc.window_ref = None
        del self._pending_win_refs[_win_mark:]
        return sel

    def parse_int(self) -> int:
        t = self.cur
        if t.kind != "num":
            raise ParseError(f"expected integer at {t.pos}")
        self.advance()
        return int(t.text)

    def parse_select_item(self) -> ast.SelectItem:
        if self.at_op("*"):
            self.advance()
            return ast.SelectItem(ast.Star())
        # table.* ?
        if self.cur.kind == "id" and self.toks[self.i + 1].kind == "op" and self.toks[self.i + 1].text == "." and self.toks[self.i + 2].text == "*":
            t = self.advance().text
            self.advance()
            self.advance()
            return ast.SelectItem(ast.Star(table=t))
        e = self.parse_expr()
        alias = None
        if self.accept_kw("as"):
            alias = self.expect_ident()
        elif self.cur.kind == "id":
            alias = self.advance().text
        return ast.SelectItem(e, alias)

    def parse_order_item(self) -> ast.OrderItem:
        e = self.parse_expr()
        desc = False
        if self.accept_kw("desc"):
            desc = True
        else:
            self.accept_kw("asc")
        return ast.OrderItem(e, desc)

    # -- FROM --------------------------------------------------------------
    def parse_table_refs(self):
        left = self.parse_table_factor()
        while True:
            if self.accept_op(","):
                right = self.parse_table_factor()
                left = ast.Join("cross", left, right, None)
                continue
            kind = None
            if self.accept_kw("inner"):
                kind = "inner"
                self.expect_kw("join")
            elif self.accept_kw("cross"):
                kind = "cross"
                self.expect_kw("join")
            elif self.accept_kw("left"):
                self.accept_kw("outer")
                self.expect_kw("join")
                kind = "left"
            elif self.accept_kw("right"):
                self.accept_kw("outer")
                self.expect_kw("join")
                kind = "right"
            elif self.accept_kw("full"):
                self.accept_kw("outer")
                self.expect_kw("join")
                kind = "full"
            elif self.accept_kw("join"):
                kind = "inner"
            else:
                return left
            right = self.parse_table_factor()
            on = None
            if self.accept_kw("on"):
                on = self.parse_expr()
            if kind == "right":
                # normalize: a RIGHT JOIN b == b LEFT JOIN a
                left = ast.Join("left", right, left, on)
            else:
                left = ast.Join(kind, left, right, on)

    def parse_table_factor(self):
        if self.accept_op("("):
            if self.at_kw("select") or self.at_kw("with"):
                q = self.parse_with() if self.at_kw("with") else self.parse_select_or_union()
                self.expect_op(")")
                self.accept_kw("as")
                alias = self.expect_ident()
                return ast.SubqueryRef(q, alias)
            refs = self.parse_table_refs()
            self.expect_op(")")
            return refs
        name = self.expect_ident()
        db = None
        if self.accept_op("."):
            db, name = name, self.expect_ident()
        as_of = None
        # stale read: `FROM t AS OF TIMESTAMP <expr>` — must be probed
        # before alias parsing ("AS OF" vs "AS <alias>"; TiDB grammar,
        # pkg/parser staleness clause)
        if (
            self.at_kw("as")
            and self.toks[self.i + 1].text.lower() == "of"
        ):
            self.advance()  # as
            self.advance()  # of
            # TIMESTAMP lexes as an identifier (type name), not a kw
            if not (
                self.cur.kind == "id"
                and self.cur.text.lower() == "timestamp"
            ):
                raise ParseError(
                    f"expected TIMESTAMP after AS OF, got "
                    f"{self.cur.text!r} at {self.cur.pos}"
                )
            self.advance()
            as_of = self.parse_unary()
        alias = None
        if self.accept_kw("as"):
            alias = self.expect_ident()
        elif self.cur.kind == "id" and self.cur.text.lower() != "window":
            # WINDOW starts the named-window clause, never an implicit
            # alias (MySQL reserves it in exactly this position)
            alias = self.advance().text
        return ast.TableRef(db, name, alias, as_of=as_of)

    # -- expressions (Pratt) ----------------------------------------------
    def parse_expr(self):
        return self.parse_or()

    def parse_or(self):
        e = self.parse_logical_xor()
        while self.accept_kw("or") or self.accept_op("||"):
            e = ast.Call("or", [e, self.parse_logical_xor()])
        return e

    def parse_logical_xor(self):
        # MySQL precedence: OR < XOR < AND (the bitwise ^ level keeps
        # the separate parse_xor name further down)
        e = self.parse_and()
        while self._at_ident("xor"):
            # logical XOR: (a != 0) != (b != 0), NULL-propagating
            self.advance()
            r = self.parse_and()
            e = ast.Call("ne", [
                ast.Call("ne", [e, ast.Const(0)]),
                ast.Call("ne", [r, ast.Const(0)]),
            ])
        return e

    def parse_and(self):
        e = self.parse_not()
        while self.accept_kw("and") or self.accept_op("&&"):
            e = ast.Call("and", [e, self.parse_not()])
        return e

    @staticmethod
    def _row_eq(lhs_items, rhs_items):
        """Columnwise AND-of-equalities for row-value comparisons."""
        conj = None
        for le, re_ in zip(lhs_items, rhs_items):
            c = ast.Call("eq", [le, re_])
            conj = c if conj is None else ast.Call("and", [conj, c])
        return conj

    @staticmethod
    def _quantified(opname: str, quant: str, lhs, q):
        """<op> ANY/ALL (subquery) rewrites (MySQL quantified compares):
        = ANY -> IN, <> ALL -> NOT IN. Ordering comparisons compare
        against MIN/MAX over the subquery AS A DERIVED TABLE (its own
        GROUP BY / LIMIT semantics preserved), with a CASE implementing
        the full 3-valued semantics: ALL over an empty set is TRUE (ANY
        is FALSE), a violated bound decides immediately, and otherwise
        a NULL anywhere in the set makes the result NULL."""
        if quant in ("any", "some"):
            if opname == "eq":
                return ast.SubqueryExpr(q, "in", lhs=lhs)
            agg = {"lt": "max", "le": "max", "gt": "min", "ge": "min"}.get(opname)
            if agg is None:  # <> ANY: true unless all values equal lhs
                raise ParseError("<> ANY is not supported; use NOT IN or MIN/MAX")
        else:  # all
            if opname == "ne":
                return ast.SubqueryExpr(q, "not in", lhs=lhs)
            agg = {"lt": "min", "le": "min", "gt": "max", "ge": "max"}.get(opname)
            if agg is None:
                raise ParseError("= ALL is not supported; use IN with a single row")
        item = q.items[0] if isinstance(q, ast.Select) else None
        if item is None:
            raise ParseError("quantified comparison needs a plain SELECT")
        q2 = dataclasses_replace(
            q, items=[ast.SelectItem(item.expr, alias="_qc")]
        )

        def agg_subq(func, over_col):
            inner = ast.Select(
                items=[
                    ast.SelectItem(
                        ast.AggCall(
                            func,
                            ast.Name(None, "_qc") if over_col else None,
                        ),
                        alias="_a",
                    )
                ],
                from_=ast.SubqueryRef(q2, "_qd"),
            )
            return ast.SubqueryExpr(inner, None)

        bound = agg_subq(agg, True)
        c_all = agg_subq("count", False)
        c_nn = agg_subq("count", True)
        cmp_e = ast.Call(opname, [lhs, bound])
        empty = ast.Call("eq", [c_all, ast.Const(0)])
        has_null = ast.Call("gt", [c_all, c_nn])
        if quant == "all":
            return ast.Call("case", [
                empty, ast.Const(True),
                ast.Call("not", [cmp_e]), ast.Const(False),
                has_null, ast.Const(None),
                ast.Const(True),
            ])
        return ast.Call("case", [
            empty, ast.Const(False),
            cmp_e, ast.Const(True),
            has_null, ast.Const(None),
            ast.Const(False),
        ])

    def parse_not(self):
        if self.accept_kw("not"):
            return ast.Call("not", [self.parse_not()])
        return self.parse_predicate()

    # MySQL bit-operator precedence (high to low): ~ (unary), ^,
    # * / %, + -, << >>, &, |, then comparisons
    def parse_bitor(self):
        e = self.parse_bitand()
        while self.at_op("|"):
            self.advance()
            e = ast.Call("bit_or", [e, self.parse_bitand()])
        return e

    def parse_bitand(self):
        e = self.parse_shift()
        while self.at_op("&"):
            self.advance()
            e = ast.Call("bit_and", [e, self.parse_shift()])
        return e

    def parse_shift(self):
        e = self.parse_additive()
        while self.at_op("<<", ">>"):
            op = self.advance().text
            e = ast.Call(
                "shl" if op == "<<" else "shr", [e, self.parse_additive()]
            )
        return e

    def parse_predicate(self):
        e = self.parse_bitor()
        while True:
            if self.at_op("<=>"):
                # null-safe equality: its own kernel op (TRUE when both
                # NULL, FALSE when exactly one is, never NULL) — a
                # desugar would re-evaluate both operands three times
                self.advance()
                e = ast.Call("nulleq", [e, self.parse_bitor()])
                continue
            if self.at_op("=", "<>", "!=", "<", "<=", ">", ">="):
                op = self.advance().text
                opname = {"=": "eq", "<>": "ne", "!=": "ne", "<": "lt", "<=": "le", ">": "gt", ">=": "ge"}[op]
                # quantified comparison: <op> ANY/SOME/ALL (subquery)
                if (
                    self.cur.kind in ("id", "kw")
                    and self.cur.text.lower() in ("any", "some", "all")
                    and self.toks[self.i + 1].text == "("
                ):
                    quant = self.advance().text.lower()
                    self.expect_op("(")
                    q = self.parse_select_or_union()
                    self.expect_op(")")
                    e = self._quantified(opname, quant, e, q)
                    continue
                rhs = self.parse_bitor()
                if isinstance(e, ast.RowExpr) or isinstance(rhs, ast.RowExpr):
                    if (
                        not isinstance(e, ast.RowExpr)
                        or not isinstance(rhs, ast.RowExpr)
                        or len(e.items) != len(rhs.items)
                        or opname not in ("eq", "ne")
                    ):
                        raise ParseError(
                            "row values support only (a,b) = / <> (c,d) "
                            "of equal arity"
                        )
                    conj = self._row_eq(e.items, rhs.items)
                    e = ast.Call("not", [conj]) if opname == "ne" else conj
                    continue
                e = ast.Call(opname, [e, rhs])
                continue
            if self.at_kw("is"):
                self.advance()
                neg = self.accept_kw("not")
                if self.at_kw("true", "false") or self._at_ident("unknown"):
                    # IS [NOT] TRUE/FALSE/UNKNOWN (3-valued truth tests)
                    which = self.advance().text.lower()
                    if which == "unknown":
                        r = ast.Call("isnull", [e])
                    else:
                        # IS is never NULL: NULL input yields FALSE
                        cmp_op = "ne" if which == "true" else "eq"
                        r = ast.Call(
                            "if",
                            [ast.Call("isnull", [e]), ast.Const(False),
                             ast.Call(cmp_op, [e, ast.Const(0)])],
                        )
                    e = ast.Call("not", [r]) if neg else r
                    continue
                self.expect_kw("null")
                e = ast.Call("isnotnull" if neg else "isnull", [e])
                continue
            neg = False
            save = self.i
            if self.accept_kw("not"):
                neg = True
            if self.accept_kw("between"):
                lo = self.parse_bitor()
                self.expect_kw("and")
                hi = self.parse_bitor()
                r = ast.Call("and", [ast.Call("ge", [e, lo]), ast.Call("le", [e, hi])])
                e = ast.Call("not", [r]) if neg else r
                continue
            if self.accept_kw("in"):
                self.expect_op("(")
                if self.at_kw("select"):
                    q = self.parse_select()
                    self.expect_op(")")
                    e = ast.SubqueryExpr(q, "not in" if neg else "in", lhs=e)
                else:
                    vals = [self.parse_expr()]
                    while self.accept_op(","):
                        vals.append(self.parse_expr())
                    self.expect_op(")")
                    if isinstance(e, ast.RowExpr):
                        # (a,b) IN ((1,2),(3,4)) -> OR of row equalities
                        disj = None
                        for v in vals:
                            if (
                                not isinstance(v, ast.RowExpr)
                                or len(v.items) != len(e.items)
                            ):
                                raise ParseError(
                                    "row-value IN list needs rows of "
                                    "matching arity"
                                )
                            conj = self._row_eq(e.items, v.items)
                            disj = (
                                conj if disj is None
                                else ast.Call("or", [disj, conj])
                            )
                        e = ast.Call("not", [disj]) if neg else disj
                        continue
                    r = ast.Call("in", [e] + vals)
                    e = ast.Call("not", [r]) if neg else r
                continue
            if self.accept_kw("like"):
                pat = self.parse_bitor()
                r = ast.Call("like", [e, pat])
                e = ast.Call("not", [r]) if neg else r
                continue
            if self._at_ident("ilike"):
                # case-insensitive LIKE (reference ast.Ilike): desugars
                # through LOWER on the column (a dictionary LUT remap)
                # with the pattern literal lowercased at parse time —
                # the LIKE kernel's pattern-is-literal contract holds
                self.advance()
                pat = self.parse_bitor()
                if isinstance(pat, ast.Const) and isinstance(
                    pat.value, str
                ):
                    pat = ast.Const(pat.value.lower())
                r = ast.Call("like", [ast.Call("lower", [e]), pat])
                e = ast.Call("not", [r]) if neg else r
                continue
            if self.cur.kind == "id" and self.cur.text.lower() in (
                "regexp", "rlike"
            ):
                self.advance()
                pat = self.parse_bitor()
                r = ast.Call("regexp", [e, pat])
                e = ast.Call("not", [r]) if neg else r
                continue
            if neg:
                self.i = save
            return e

    def parse_additive(self):
        e = self.parse_multiplicative()
        while True:
            if self.accept_op("+"):
                rhs = self.parse_multiplicative()
                e = self._maybe_interval("add", e, rhs)
            elif self.accept_op("-"):
                rhs = self.parse_multiplicative()
                e = self._maybe_interval("sub", e, rhs)
            else:
                return e

    def _maybe_interval(self, op, lhs, rhs):
        if isinstance(rhs, ast.Interval):
            return ast.Call("date_" + op, [lhs, rhs])
        return ast.Call(op, [lhs, rhs])

    def parse_multiplicative(self):
        e = self.parse_xor()
        while True:
            if self.accept_op("*"):
                e = ast.Call("mul", [e, self.parse_xor()])
            elif self.accept_op("/"):
                e = ast.Call("div", [e, self.parse_xor()])
            elif self.accept_kw("div"):
                e = ast.Call("intdiv", [e, self.parse_xor()])
            elif self.accept_op("%") or self.accept_kw("mod"):
                e = ast.Call("mod", [e, self.parse_xor()])
            else:
                return e

    def parse_xor(self):
        e = self.parse_unary()
        while self.at_op("^"):
            self.advance()
            e = ast.Call("bit_xor", [e, self.parse_unary()])
        return e

    def parse_unary(self):
        if self.accept_op("-"):
            return ast.Call("neg", [self.parse_unary()])
        if self.accept_op("+"):
            return self.parse_unary()
        if self.accept_op("~"):
            return ast.Call("bit_neg", [self.parse_unary()])
        e = self.parse_primary()
        # expr COLLATE <name>: _ci collations compare case-folded,
        # _bin is the engine default (dictionary order IS binary order)
        while self.accept_kw("collate"):
            cname = self.expect_ident().lower()
            if cname.endswith("_ci"):
                e = ast.Call("_collate_ci", [e])
            elif cname.endswith("_bin") or cname == "binary":
                # marker: overrides a CI COLUMN collation back to binary
                e = ast.Call("_collate_bin", [e])
            else:
                raise ParseError(f"unsupported collation {cname!r}")
        return e

    def parse_primary(self):
        t = self.cur
        if t.kind == "op" and t.text == "@":
            # @name: session user variable read (SET @x = ... writes it)
            self.advance()
            return ast.UserVarRef(self.expect_ident().lower())
        if t.kind == "sysvar":
            self.advance()
            rest = t.text
            scope = None
            for pre in ("global.", "session."):
                if rest.lower().startswith(pre):
                    scope, rest = pre[:-1], rest[len(pre):]
            return ast.SysVarRef(rest, scope)
        if t.kind == "num":
            self.advance()
            if re.fullmatch(r"\d+", t.text):
                return ast.Const(int(t.text))
            return ast.Const(float(t.text))
        if t.kind == "str":
            self.advance()
            return ast.Const(t.text)
        if t.kind == "op" and t.text == "?":
            # prepared-statement placeholder; value bound per EXECUTE
            self.advance()
            idx = self._param_count
            self._param_count += 1
            return ast.Const(None, param_index=idx)
        if self.at_kw("null"):
            self.advance()
            return ast.Const(None)
        if self.at_kw("true"):
            self.advance()
            return ast.Const(True)
        if self.at_kw("false"):
            self.advance()
            return ast.Const(False)
        if self.at_kw("date"):
            # DATE 'yyyy-mm-dd' literal
            if self.toks[self.i + 1].kind == "str":
                self.advance()
                return ast.Const(self.advance().text, type_hint=DATE)
            # else fall through: DATE(...) function or identifier
        if (
            self.cur.kind in ("kw", "id")
            and self.cur.text.lower() in ("time", "timestamp")
            and self.toks[self.i + 1].kind == "str"
        ):
            # TIME 'hh:mm:ss' / TIMESTAMP 'yyyy-mm-dd hh:mm:ss' literals
            kind = self.cur.text.lower()
            self.advance()
            return ast.Const(
                self.advance().text,
                type_hint=TIME if kind == "time" else DATETIME,
            )
        if self.at_kw("interval"):
            self.advance()
            if self.at_op("("):
                # INTERVAL(N, a, b, ...) comparison function
                self.advance()
                args = [self.parse_expr()]
                while self.accept_op(","):
                    args.append(self.parse_expr())
                self.expect_op(")")
                return ast.Call("interval_fn", args)
            v = self.parse_unary()
            unit = self.expect_ident()
            if isinstance(v, ast.Const) and isinstance(v.value, str):
                v = ast.Const(int(v.value))
            return ast.Interval(v, unit.lower())
        if self.at_kw("case"):
            return self.parse_case()
        if self.at_kw("cast"):
            self.advance()
            self.expect_op("(")
            e = self.parse_expr()
            self.expect_kw("as")
            typ = self.parse_type()
            self.expect_op(")")
            return ast.Call("cast", [e], cast_type=typ)
        if self.cur.kind == "id" and self.cur.text.lower() == "convert" \
                and self.toks[self.i + 1].text == "(":
            # CONVERT(expr, type) — the cast in function clothing;
            # CONVERT(expr USING charset) — charset conversion (all
            # strings are utf8 internally: identity + collation reset
            # to the target charset's default)
            self.advance()
            self.expect_op("(")
            e = self.parse_expr()
            if self.cur.text.lower() == "using":
                self.advance()
                from tidb_tpu_torch.utils import collate as _coll

                cs = self.expect_ident().lower()
                if cs not in _coll.CHARSET_DEFAULTS:
                    raise ParseError(f"unknown character set {cs!r}")
                self.expect_op(")")
                dflt = _coll.CHARSET_DEFAULTS[cs]
                if _coll.is_binary(dflt):
                    return ast.Call("_collate_bin", [e])
                return ast.Call("_collate_ci", [e])
            self.expect_op(",")
            typ = self.parse_type()
            self.expect_op(")")
            return ast.Call("cast", [e], cast_type=typ)
        if self.at_kw("exists"):
            self.advance()
            self.expect_op("(")
            q = self.parse_select()
            self.expect_op(")")
            return ast.SubqueryExpr(q, "exists")
        if self.at_kw("extract"):
            self.advance()
            self.expect_op("(")
            unit = self.expect_ident().lower()
            self.expect_kw("from")
            e = self.parse_expr()
            self.expect_op(")")
            return ast.Call(unit, [e])
        if self.at_kw("count", "sum", "avg", "min", "max", "group_concat"):
            func = self.advance().text
            self.expect_op("(")
            distinct = self.accept_kw("distinct")
            if func == "count" and self.accept_op("*"):
                self.expect_op(")")
                if self.at_kw("over"):
                    return self._parse_over(func, None)
                return ast.AggCall("count", None, False)
            arg = self.parse_expr()
            if func == "group_concat":
                # GROUP_CONCAT(expr [ORDER BY e [ASC|DESC], ...]
                #              [SEPARATOR 'sep'])  (MySQL grammar)
                order_by = []
                if self.accept_kw("order"):
                    self.expect_kw("by")
                    while True:
                        e = self.parse_expr()
                        desc = False
                        if self.accept_kw("desc"):
                            desc = True
                        else:
                            self.accept_kw("asc")
                        order_by.append((e, desc))
                        if not self.accept_op(","):
                            break
                sep = ","
                if self.accept_kw("separator"):
                    tok = self.advance()
                    if tok.kind != "str":
                        raise ParseError(
                            f"SEPARATOR expects a string literal, got {tok.text!r}"
                        )
                    sep = tok.text
                self.expect_op(")")
                return ast.AggCall(
                    func, arg, distinct, separator=sep,
                    order_by=tuple(order_by),
                )
            self.expect_op(")")
            if self.at_kw("over"):
                return self._parse_over(func, arg)
            return ast.AggCall(func, arg, distinct)
        if self.accept_op("("):
            if self.at_kw("select"):
                q = self.parse_select()
                self.expect_op(")")
                return ast.SubqueryExpr(q, None)
            e = self.parse_expr()
            if self.at_op(","):
                # row-value constructor (a, b, ...): meaningful only
                # directly under =/<>/IN, expanded by the planner
                items = [e]
                while self.accept_op(","):
                    items.append(self.parse_expr())
                self.expect_op(")")
                return ast.RowExpr(items)
            self.expect_op(")")
            return e
        if (
            t.kind == "kw"
            and t.text in _FUNC_KEYWORDS
            and self.toks[self.i + 1].text == "("
        ):
            name = self.advance().text
            self.expect_op("(")
            args = []
            if not self.at_op(")"):
                args.append(self.parse_expr())
                while self.accept_op(","):
                    args.append(self.parse_expr())
            self.expect_op(")")
            return ast.Call(name.lower(), args)
        if t.kind == "id" or t.kind == "kw":
            name = self.expect_ident()
            if name.lower() == "position" and self.at_op("("):
                # POSITION(x IN s) — the IN here is grammar, not the
                # set-membership operator
                self.advance()
                x = self.parse_additive()
                self.expect_kw("in")
                s_arg = self.parse_expr()
                self.expect_op(")")
                return ast.Call("locate", [x, s_arg])
            if name.lower() == "timestampdiff" and self.at_op("("):
                # TIMESTAMPDIFF(unit, a, b): bareword unit
                self.advance()
                unit = self.expect_ident().lower()
                self.expect_op(",")
                a = self.parse_expr()
                self.expect_op(",")
                b = self.parse_expr()
                self.expect_op(")")
                return ast.Call("timestampdiff", [ast.Const(unit), a, b])
            if name.lower() == "timestampadd" and self.at_op("("):
                # TIMESTAMPADD(unit, n, d) == DATE_ADD(d, INTERVAL n unit)
                self.advance()
                unit = self.expect_ident().lower()
                self.expect_op(",")
                n = self.parse_expr()
                self.expect_op(",")
                d = self.parse_expr()
                self.expect_op(")")
                return ast.Call("date_add", [d, ast.Interval(n, unit)])
            if self.accept_op("("):
                args = []
                if not self.at_op(")"):
                    args.append(self.parse_expr())
                    while self.accept_op(","):
                        args.append(self.parse_expr())
                self.expect_op(")")
                low0 = name.lower()
                if low0 == "json_arrayagg" and len(args) == 1:
                    return ast.AggCall(
                        "json_arrayagg", args[0], False,
                        separator="\x00json_array",
                    )
                if low0 == "json_objectagg" and len(args) == 2:
                    # the KEY expr rides the order-by slot (projected
                    # alongside by the host-assisted aggregation)
                    return ast.AggCall(
                        "json_objectagg", args[1], False,
                        separator="\x00json_object",
                        order_by=((args[0], False),),
                    )
                if low0 in (
                    "any_value", "variance", "var_pop", "var_samp",
                    "std", "stddev", "stddev_pop", "stddev_samp",
                ) and len(args) == 1:
                    # expanded by planner (_rewrite_derived_aggs);
                    # DISTINCT is not accepted here, like MySQL
                    return ast.AggCall(low0, args[0], False)
                if name.lower() in _WINDOW_ONLY_FUNCS:
                    low = name.lower()
                    offset = 1
                    if low in ("lag", "lead") and len(args) > 1:
                        o = args[1]
                        if isinstance(o, ast.Const):
                            offset = int(o.value)
                    if low == "nth_value":
                        # MySQL: exactly two args, N a positive constant
                        if len(args) != 2:
                            raise ParseError(
                                "NTH_VALUE expects (expr, N)"
                            )
                        o = args[1]
                        if (
                            not isinstance(o, ast.Const)
                            or not isinstance(o.value, int)
                            or o.value < 1
                        ):
                            raise ParseError(
                                "NTH_VALUE's N must be a positive integer "
                                "constant"
                            )
                        offset = int(o.value)
                    arg = args[0] if args else None
                    if low == "ntile":
                        # NTILE(n): the bucket count rides in offset
                        if (
                            not args
                            or not isinstance(args[0], ast.Const)
                            or not isinstance(args[0].value, int)
                            or args[0].value < 1
                        ):
                            raise ParseError(
                                "NTILE expects a positive integer constant"
                            )
                        offset, arg = int(args[0].value), None
                    return self._parse_over(low, arg, offset)
                return ast.Call(name.lower(), args)
            if self.accept_op("."):
                col = self.expect_ident()
                return ast.Name(name, col)
            return ast.Name(None, name)
        raise ParseError(f"unexpected token {t.text!r} at {t.pos}")

    def _parse_over(self, func: str, arg, offset: int = 1):
        self.expect_kw("over")
        if not self.at_op("("):
            # OVER w — named window (resolved against the WINDOW clause
            # at the end of parse_select; the pending list makes that
            # O(refs), no tree walk). expect_ident accepts the same
            # soft keywords the definition side does.
            ref = self.expect_ident().lower()
            wc = ast.WindowCall(func, arg, [], [], offset, None)
            wc.window_ref = ref
            if not hasattr(self, "_pending_win_refs"):
                self._pending_win_refs = []
            self._pending_win_refs.append(wc)
            return wc
        partition, order, frame = self._parse_window_spec()
        return ast.WindowCall(func, arg, partition, order, offset, frame)

    def _parse_window_spec(self):
        """Parenthesized window spec: ([PARTITION BY ...] [ORDER BY ...]
        [ROWS|RANGE frame]) — shared by OVER (...) and WINDOW w AS (...)."""
        self.expect_op("(")
        partition = []
        order = []
        if self.accept_kw("partition"):
            self.expect_kw("by")
            partition.append(self.parse_expr())
            while self.accept_op(","):
                partition.append(self.parse_expr())
        if self.accept_kw("order"):
            self.expect_kw("by")
            order.append(self.parse_order_item())
            while self.accept_op(","):
                order.append(self.parse_order_item())
        frame = None
        if self.accept_kw("rows"):
            if self.accept_kw("between"):
                lo = self._parse_frame_bound(is_start=True)
                self.expect_kw("and")
                hi = self._parse_frame_bound(is_start=False)
                # MySQL ER_WINDOW_FRAME_ILLEGAL: start must not be after
                # end (silently-empty frames would yield wrong results)
                if lo is not None and hi is not None and lo > hi:
                    raise ParseError("window frame start cannot follow its end")
            else:
                # short form: only UNBOUNDED PRECEDING / n PRECEDING /
                # CURRENT ROW are legal starts (end is CURRENT ROW)
                lo = self._parse_frame_bound(is_start=True)
                if lo is not None and lo > 0:
                    raise ParseError(
                        "FOLLOWING frame start requires BETWEEN ... AND ..."
                    )
                hi = 0
            frame = (lo, hi)
        elif self.cur.kind == "id" and self.cur.text.lower() == "range":
            # RANGE value frames: offsets against the (single) ORDER BY
            # key value, numeric or INTERVAL for temporal keys
            self.advance()
            if self.accept_kw("between"):
                rlo = self._parse_range_bound(is_start=True)
                self.expect_kw("and")
                rhi = self._parse_range_bound(is_start=False)
            else:
                rlo = self._parse_range_bound(is_start=True)
                if self._range_bound_order(rlo) > 0:
                    raise ParseError(
                        "FOLLOWING frame start requires BETWEEN ... AND ..."
                    )
                rhi = "cur"
            lo_o = (
                float("-inf") if rlo is None else self._range_bound_order(rlo)
            )
            hi_o = (
                float("inf") if rhi is None else self._range_bound_order(rhi)
            )
            if lo_o > hi_o:
                raise ParseError("window frame start cannot follow its end")
            frame = ("range", rlo, rhi)
        self.expect_op(")")
        return partition, order, frame

    def _parse_range_bound(self, is_start: bool):
        """RANGE frame bound: None = unbounded, 'cur' = current row
        (peers), ('num', signed value) or ('interval', signed n, unit) —
        PRECEDING negative, FOLLOWING positive."""
        if self.accept_kw("unbounded"):
            if self.accept_kw("preceding"):
                if not is_start:
                    raise ParseError("UNBOUNDED PRECEDING is only a frame start")
                return None
            if self.accept_kw("following"):
                if is_start:
                    raise ParseError("UNBOUNDED FOLLOWING is only a frame end")
                return None
            raise ParseError("expected PRECEDING or FOLLOWING")
        if self.accept_kw("current"):
            self.expect_kw("row")
            return "cur"
        if self.accept_kw("interval"):
            t = self.advance()
            if t.kind not in ("num", "str"):
                raise ParseError("INTERVAL expects a number")
            n = int(float(t.text))
            unit = self.expect_ident().lower().rstrip("s")
            sign = self._frame_dir()
            return ("interval", sign * n, unit)
        t = self.cur
        if t.kind != "num":
            raise ParseError(f"expected a frame offset at {t.pos}")
        self.advance()
        v = float(t.text)
        sign = self._frame_dir()
        return ("num", sign * v)

    @staticmethod
    def _range_bound_order(bound) -> float:
        """Comparable magnitude of a RANGE bound for start<=end
        validation (ER_WINDOW_FRAME_ILLEGAL): unbounded handled by the
        caller's bound direction, intervals compare in seconds."""
        if bound == "cur":
            return 0.0
        if bound[0] == "num":
            return float(bound[1])
        _i, n, unit = bound
        secs = {
            "microsecond": 1e-6, "second": 1.0, "minute": 60.0,
            "hour": 3600.0, "day": 86400.0, "week": 604800.0,
            "month": 2.6e6, "year": 3.15e7,
        }.get(unit, 1.0)
        return float(n) * secs

    def _frame_dir(self) -> int:
        if self.accept_kw("preceding"):
            return -1
        if self.accept_kw("following"):
            return 1
        raise ParseError("expected PRECEDING or FOLLOWING")

    def _parse_frame_bound(self, is_start: bool = True):
        """ROWS frame bound -> row offset relative to the current row:
        negative = preceding, positive = following, 0 = current row,
        None = unbounded (preceding for the start bound, following for
        the end bound; the illegal crossings are rejected)."""
        if self.accept_kw("unbounded"):
            if self.accept_kw("preceding"):
                if not is_start:
                    raise ParseError("UNBOUNDED PRECEDING is only a frame start")
                return None
            if self.accept_kw("following"):
                if is_start:
                    raise ParseError("UNBOUNDED FOLLOWING is only a frame end")
                return None
            raise ParseError("expected PRECEDING or FOLLOWING")
        if self.accept_kw("current"):
            self.expect_kw("row")
            return 0
        tok = self.cur
        if tok.kind != "num":
            raise ParseError(f"expected frame bound at {tok.pos}")
        self.advance()
        n = int(tok.text)
        if self.accept_kw("preceding"):
            return -n
        if self.accept_kw("following"):
            return n
        raise ParseError("expected PRECEDING or FOLLOWING")

    def parse_case(self):
        self.expect_kw("case")
        args: List[object] = []
        operand = None
        if not self.at_kw("when"):
            operand = self.parse_expr()
        while self.accept_kw("when"):
            cond = self.parse_expr()
            if operand is not None:
                cond = ast.Call("eq", [operand, cond])
            self.expect_kw("then")
            val = self.parse_expr()
            args.extend([cond, val])
        if self.accept_kw("else"):
            args.append(self.parse_expr())
        self.expect_kw("end")
        return ast.Call("case", args)

    def parse_type(self) -> SQLType:
        t, _meta = self.parse_type_full()
        return t

    def parse_type_full(self):
        """(SQLType, meta) — meta carries ENUM/SET member lists and the
        JSON marker (these ride on the schema, not the device type: on
        device all three are dictionary-coded strings)."""
        if self.at_kw("set"):  # SET('a','b') column type (kw elsewhere)
            self.advance()
            name = "set"
        else:
            name = self.expect_ident().lower()
        meta = {}
        if name == "decimal" or name == "numeric":
            scale = 0
            if self.accept_op("("):
                self.parse_int()
                if self.accept_op(","):
                    scale = self.parse_int()
                self.expect_op(")")
            return DECIMAL(scale), meta
        if name in ("signed", "unsigned"):
            return INT64, meta
        if name in ("enum", "set"):
            self.expect_op("(")
            members = []
            while True:
                tok = self.advance()
                if tok.kind != "str":
                    raise ParseError(f"{name.upper()} members must be strings")
                members.append(tok.text)
                if not self.accept_op(","):
                    break
            self.expect_op(")")
            meta["enum" if name == "enum" else "set"] = tuple(members)
            return STRING, meta
        if name == "json":
            meta["json"] = True
            return STRING, meta
        t = _TYPE_MAP.get(name)
        if t is None:
            raise ParseError(f"unknown type {name!r}")
        if self.accept_op("("):
            self.parse_int()
            self.expect_op(")")
        return t, meta

    # -- DDL / DML ---------------------------------------------------------
    def _user_name(self) -> str:
        """'u'[@'host'] — host accepted and ignored (single-host grants)."""
        t = self.cur
        if t.kind in ("str", "id") or (t.kind == "kw" and t.text in self._SOFT_KW):
            self.advance()
            name = t.text
        else:
            raise ParseError(f"expected user name, got {t.text!r} at {t.pos}")
        if self.accept_op("@"):
            h = self.advance()
            if h.kind not in ("str", "id", "op"):
                raise ParseError(f"bad host {h.text!r}")
        return name

    def parse_grant_revoke(self):
        revoke = self.cur.text == "revoke"
        self.advance()
        privs = []
        if self.accept_kw("all"):
            self.accept_kw("privileges")
            privs = ["all"]
        else:
            while True:
                t = self.advance()
                privs.append(t.text.lower())
                if not self.accept_op(","):
                    break
        self.expect_kw("on")
        # *.* | db.* | [db.]tbl
        if self.accept_op("*"):
            self.expect_op(".")
            self.expect_op("*")
            db, tbl = "*", "*"
        else:
            a = self.expect_ident()
            if self.accept_op("."):
                db = a
                tbl = "*" if self.accept_op("*") else self.expect_ident()
            else:
                db, tbl = "", a  # current database, resolved by session
        self.expect_kw("from" if revoke else "to")
        user = self._user_name()
        return ast.GrantStmt(tuple(privs), db, tbl, user, revoke=revoke)

    def _at_ident(self, word: str) -> bool:
        return self.cur.kind == "id" and self.cur.text.lower() == word

    def _expect_ident_kw(self, word: str) -> None:
        """Expect a word that may lex as EITHER identifier or keyword
        (e.g. GROUP in RESOURCE GROUP)."""
        if self.cur.text.lower() != word:
            raise ParseError(
                f"expected {word.upper()}, got {self.cur.text!r} "
                f"at {self.cur.pos}"
            )
        self.advance()

    def _resource_group_options(self):
        """[RU_PER_SEC = n] [BURSTABLE] in any order."""
        ru = None
        burst = None
        while True:
            if self._at_ident("ru_per_sec"):
                self.advance()
                self.accept_op("=")
                t = self.advance()
                try:
                    ru = int(t.text)
                except ValueError:
                    raise ParseError("RU_PER_SEC expects an integer")
            elif self._at_ident("burstable"):
                self.advance()
                burst = True
                if self.accept_op("="):
                    # BURSTABLE = TRUE|FALSE: the only way ALTER can
                    # REVOKE burstability
                    t = self.advance()
                    word = t.text.lower()
                    if word in ("true", "1", "on"):
                        burst = True
                    elif word in ("false", "0", "off"):
                        burst = False
                    else:
                        raise ParseError(
                            f"BURSTABLE expects TRUE or FALSE, got "
                            f"{t.text!r} at {t.pos}"
                        )
            else:
                return ru, burst

    def parse_create(self):
        self.expect_kw("create")
        or_replace = False
        if self.accept_kw("or"):
            # OR REPLACE is only valid before VIEW ('view'/'replace' stay
            # plain identifiers everywhere else, like REPLACE INTO)
            if not self._at_ident("replace"):
                raise ParseError("expected REPLACE after CREATE OR")
            self.advance()
            if not self._at_ident("view"):
                raise ParseError("expected VIEW after CREATE OR REPLACE")
            or_replace = True
        if self._at_ident("view"):
            self.advance()
            db, name = self._qualified_name()
            cols = None
            if self.accept_op("("):
                cols = [self.expect_ident()]
                while self.accept_op(","):
                    cols.append(self.expect_ident())
                self.expect_op(")")
            self.expect_kw("as")
            start = self.cur.pos
            q = (
                self.parse_with()
                if self.at_kw("with")
                else self.parse_select_or_union()
            )
            return ast.CreateView(
                db, name, cols, self.sql[start : self.cur.pos].strip(),
                query=q, or_replace=or_replace,
            )
        if self.accept_kw("database"):
            ine = self._if_not_exists()
            return ast.CreateDatabase(self.expect_ident(), ine)
        if self.accept_kw("binding"):
            # CREATE BINDING FOR <stmt> USING <stmt-with-hints>
            self.expect_kw("for")
            start = self.cur.pos
            self.parse_select_or_union()
            if not self.at_kw("using"):
                raise ParseError("expected USING in CREATE BINDING")
            for_sql = self.sql[start : self.cur.pos]
            self.advance()  # using
            ustart = self.cur.pos
            self.parse_select_or_union()
            return ast.CreateBinding(
                for_sql.strip(), self.sql[ustart : self.cur.pos].strip()
            )
        if self.accept_kw("user"):
            ine = self._if_not_exists()
            name = self._user_name()
            pw = ""
            if self.accept_kw("identified"):
                self.expect_kw("by")
                t = self.advance()
                if t.kind != "str":
                    raise ParseError("IDENTIFIED BY expects a string")
                pw = t.text
            return ast.CreateUser(name, pw, ine)
        if self._at_ident("resource"):
            self.advance()
            self._expect_ident_kw("group")
            ine = self._if_not_exists()
            name = self.expect_ident()
            ru, burst = self._resource_group_options()
            return ast.ResourceGroupDDL(
                "create", name, ru_per_sec=ru,
                burstable=bool(burst), if_not_exists=ine,
            )
        unique = self.accept_kw("unique")
        if unique and not self.at_kw("index"):
            raise ParseError("expected INDEX after UNIQUE")
        if self.accept_kw("index"):
            # CREATE [UNIQUE] INDEX [IF NOT EXISTS] name ON tbl (cols)
            ine = self._if_not_exists()
            iname = self.expect_ident()
            self.expect_kw("on")
            db, tname = self._qualified_name()
            self.expect_op("(")
            icols = [self.expect_ident()]
            while self.accept_op(","):
                icols.append(self.expect_ident())
            self.expect_op(")")
            return ast.CreateIndex(db, tname, iname, icols, ine, unique)
        if self._at_ident("sequence"):
            return self._parse_create_sequence()
        temporary = False
        if self._at_ident("temporary"):
            self.advance()
            temporary = True
        self.expect_kw("table")
        ine = self._if_not_exists()
        db, name = self._qualified_name()
        if self.accept_kw("like"):
            sdb, sname = self._qualified_name()
            return ast.CreateTable(
                db, name, [], [], ine, like=(sdb, sname),
                temporary=temporary,
            )
        if (
            self.cur.kind == "op"
            and self.cur.text == "("
            and self.toks[self.i + 1].kind == "kw"
            and self.toks[self.i + 1].text == "like"
        ):
            self.advance()  # (
            self.advance()  # like
            sdb, sname = self._qualified_name()
            self.expect_op(")")
            return ast.CreateTable(
                db, name, [], [], ine, like=(sdb, sname),
                temporary=temporary,
            )
        if self.accept_kw("as") or self.at_kw("select", "with"):
            # CREATE TABLE ... AS SELECT (columns derived from the query)
            q = (
                self.parse_with()
                if self.at_kw("with")
                else self.parse_select_or_union()
            )
            return ast.CreateTable(
                db, name, [], [], ine, as_query=q, temporary=temporary
            )
        self.expect_op("(")
        cols: List[ast.ColumnDef] = []
        pk: List[str] = []
        indexes: List[tuple] = []
        checks: List[tuple] = []
        fks: List[tuple] = []
        fk_actions: dict = {}
        fk_update_actions: dict = {}

        def _parse_check(cname):
            self.expect_op("(")
            start = self.cur.pos
            expr = self.parse_expr()
            end = self.cur.pos
            self.expect_op(")")
            nm = cname or f"chk_{len(checks) + 1}"
            checks.append((nm, self.sql[start:end].strip(), expr))

        def _parse_fk_actions():
            # [ON DELETE action] [ON UPDATE action] in either order
            odel = oupd = "restrict"
            while self.at_kw("on"):
                self.advance()
                which = self.cur.text.lower()
                if which not in ("delete", "update"):
                    raise ParseError("expected DELETE or UPDATE after ON")
                self.advance()
                if self._at_ident("cascade"):
                    self.advance()
                    act = "cascade"
                elif self.at_kw("set"):
                    self.advance()
                    self.expect_kw("null")
                    act = "set_null"
                elif self._at_ident("restrict") or self._at_ident("no"):
                    if self._at_ident("no"):
                        self.advance()
                        if not self._at_ident("action"):
                            raise ParseError("expected ACTION after NO")
                    self.advance()
                    act = "restrict"
                else:
                    raise ParseError(
                        "expected CASCADE, SET NULL, RESTRICT or NO ACTION"
                    )
                if which == "delete":
                    odel = act
                else:
                    oupd = act
            return odel, oupd

        def _parse_fk(cname):
            # FOREIGN KEY (col) REFERENCES tbl (col) [ON DELETE action]
            self.expect_op("(")
            col = self.expect_ident()
            self.expect_op(")")
            if not self._at_ident("references"):
                raise ParseError("expected REFERENCES in FOREIGN KEY")
            self.advance()
            rdb, rtbl = self._qualified_name()
            self.expect_op("(")
            rcol = self.expect_ident()
            self.expect_op(")")
            nm = cname or f"fk_{len(fks) + 1}"
            odel, oupd = _parse_fk_actions()
            fks.append((nm, col, rdb, rtbl, rcol))
            fk_actions[nm.lower()] = odel
            fk_update_actions[nm.lower()] = oupd

        while True:
            if self._at_ident("constraint"):
                self.advance()
                cname = (
                    self.expect_ident()
                    if self.cur.kind == "id"
                    and self.cur.text.lower() not in ("check", "foreign")
                    else None
                )
                if self._at_ident("check"):
                    self.advance()
                    _parse_check(cname)
                elif self._at_ident("foreign"):
                    self.advance()
                    self.expect_kw("key")
                    _parse_fk(cname)
                else:
                    raise ParseError(
                        "CONSTRAINT supports CHECK | FOREIGN KEY"
                    )
            elif self._at_ident("check") and self.toks[self.i + 1].text == "(":
                self.advance()
                _parse_check(None)
            elif self._at_ident("foreign") and (
                self.toks[self.i + 1].text.lower() == "key"
            ):
                self.advance()
                self.expect_kw("key")
                _parse_fk(None)
            elif self.accept_kw("primary"):
                self.expect_kw("key")
                self.expect_op("(")
                pk.append(self.expect_ident())
                while self.accept_op(","):
                    pk.append(self.expect_ident())
                self.expect_op(")")
            elif (
                self.at_kw("index", "key")
                or (self.at_kw("unique") and self.toks[self.i + 1].text.lower() in ("index", "key"))
            ) and (
                self.toks[self.i + (2 if self.at_kw("unique") else 1)].text == "("
                or (
                    self.toks[self.i + (2 if self.at_kw("unique") else 1)].kind == "id"
                    and self.toks[self.i + (3 if self.at_kw("unique") else 2)].text == "("
                )
            ):
                # [UNIQUE] INDEX/KEY [name] (cols) table element — only
                # when a '(' follows, so columns NAMED `key`/`index`
                # still parse as column definitions
                elem_unique = self.accept_kw("unique")
                self.advance()
                iname = (
                    self.expect_ident() if self.cur.kind == "id" else None
                )
                self.expect_op("(")
                icols = [self.expect_ident()]
                while self.accept_op(","):
                    icols.append(self.expect_ident())
                self.expect_op(")")
                base = iname or f"idx_{'_'.join(icols)}"
                name_i, n = base, 2
                while any(name_i == x for x, *_ in indexes):
                    name_i, n = f"{base}_{n}", n + 1
                indexes.append((name_i, icols, elem_unique))
            else:
                cname = self.expect_ident()
                if self._at_ident("serial"):
                    # SERIAL = BIGINT NOT NULL AUTO_INCREMENT UNIQUE
                    self.advance()
                    cd = ast.ColumnDef(
                        cname, INT64, not_null=True, auto_increment=True
                    )
                    indexes.append((f"u_{cname}", [cname], True))
                    cols.append(cd)
                    if not self.accept_op(","):
                        break
                    continue
                ctype, tmeta = self.parse_type_full()
                cd = ast.ColumnDef(cname, ctype)
                cd.enum_members = tmeta.get("enum", ())
                cd.set_members = tmeta.get("set", ())
                cd.is_json = bool(tmeta.get("json"))
                col_collate = None   # explicit COLLATE (always wins)
                col_charset = None   # CHARACTER SET (its default applies
                                     # only when no COLLATE is given)
                while True:
                    if self.accept_kw("not"):
                        self.expect_kw("null")
                        cd.not_null = True
                    elif self.accept_kw("null"):
                        pass
                    elif self.accept_kw("primary"):
                        self.expect_kw("key")
                        cd.primary_key = True
                        pk.append(cname)
                    elif self.at_kw("key"):
                        self.advance()
                    elif self.accept_kw("auto_increment"):
                        cd.auto_increment = True
                    elif self.accept_kw("default"):
                        cd.default = self._default_const().value
                    elif self.accept_kw("collate"):
                        from tidb_tpu_torch.utils import collate as _coll

                        col_collate = _coll.validate(self.expect_ident())
                    elif self._at_ident("character") or self._at_ident("charset"):
                        if self._at_ident("character"):
                            self.advance()
                            self.expect_kw("set")
                        else:
                            self.advance()
                        from tidb_tpu_torch.utils import collate as _coll

                        cs = self.expect_ident().lower()
                        if cs not in _coll.CHARSET_DEFAULTS:
                            raise ParseError(f"unknown character set {cs!r}")
                        col_charset = cs
                    elif self._at_generated_clause():
                        cd.generated = self._parse_generated_clause()
                    elif self._at_ident("check"):
                        self.advance()
                        _parse_check(None)
                    elif self._at_ident("references"):
                        # column-level FK shorthand
                        self.advance()
                        rdb, rtbl = self._qualified_name()
                        self.expect_op("(")
                        rcol = self.expect_ident()
                        self.expect_op(")")
                        nm0 = f"fk_{len(fks) + 1}"
                        odel0, oupd0 = _parse_fk_actions()
                        fks.append((nm0, cname, rdb, rtbl, rcol))
                        fk_actions[nm0.lower()] = odel0
                        fk_update_actions[nm0.lower()] = oupd0
                    else:
                        break
                # collation resolution: explicit COLLATE always wins
                # (including binary, which must be able to OVERRIDE a
                # charset default); otherwise the charset's default
                if ctype.kind.value == "string":
                    from tidb_tpu_torch.utils import collate as _coll

                    eff = (
                        col_collate
                        if col_collate is not None
                        else _coll.CHARSET_DEFAULTS.get(col_charset or "")
                    )
                    if eff is not None and not _coll.is_binary(eff):
                        import dataclasses as _dc

                        cd.type = ctype = _dc.replace(ctype, collation=eff)
                cols.append(cd)
            if not self.accept_op(","):
                break
        self.expect_op(")")
        ttl = None
        partition = None
        # PARTITION BY RANGE (col) (PARTITION p VALUES LESS THAN (n)|
        # MAXVALUE, ...) | PARTITION BY HASH (col) PARTITIONS n
        if self.at_kw("partition"):
            self.advance()
            self.expect_kw("by")
            kindw = self.expect_ident().lower()
            if kindw in ("range", "list"):
                self.expect_op("(")
                pcol = self.expect_ident().lower()
                self.expect_op(")")
                self.expect_op("(")
                parts = self._parse_range_partition_items()
                self.expect_op(")")
                partition = (kindw, pcol, parts)
            elif kindw == "hash":
                self.expect_op("(")
                pcol = self.expect_ident().lower()
                self.expect_op(")")
                if not self._at_ident("partitions"):
                    raise ParseError("expected PARTITIONS n")
                self.advance()
                n = self.parse_int()
                partition = ("hash", pcol, n)
            else:
                raise ParseError(f"unsupported partitioning {kindw!r}")
        # table options: TTL = col + INTERVAL n unit  (reference: TiDB
        # TTL table option, pkg/ttl)
        while self.cur.kind == "kw":
            if self.accept_kw("ttl"):
                self.expect_op("=")
                tcol = self.expect_ident()
                self.expect_op("+")
                self.expect_kw("interval")
                t = self.advance()
                if t.kind != "num":
                    raise ParseError(
                        f"TTL interval expects a number, got {t.text!r} at {t.pos}"
                    )
                iv = int(t.text)
                unit = self.expect_ident().lower().rstrip("s")
                ttl = (tcol, iv, unit)
            else:
                break
        return ast.CreateTable(
            db, name, cols, pk, ine, indexes=indexes, ttl=ttl,
            checks=checks, fks=fks, partition=partition,
            fk_actions=fk_actions, fk_update_actions=fk_update_actions,
            temporary=temporary,
        )

    def _parse_create_sequence(self):
        """CREATE SEQUENCE [IF NOT EXISTS] name [START [WITH] n]
        [INCREMENT [BY] n] [MINVALUE n | NOMINVALUE] [MAXVALUE n |
        NOMAXVALUE] [CACHE n | NOCACHE] [CYCLE | NOCYCLE] — the
        reference's option grammar (pkg/parser sequence options)."""
        self.advance()  # 'sequence'
        ine = self._if_not_exists()
        db, name = self._qualified_name()
        seq = ast.CreateSequence(db, name, if_not_exists=ine)

        def _int(allow_neg=True):
            neg = allow_neg and self.accept_op("-")
            t = self.cur
            if t.kind != "num":
                raise ParseError(f"expected number at {t.pos}")
            self.advance()
            return -int(t.text) if neg else int(t.text)

        while True:
            if self._at_ident("start") or self.at_kw("start"):
                self.advance()
                self.accept_kw("with")
                seq.start = _int()
            elif self._at_ident("increment"):
                self.advance()
                if self._at_ident("by") or self.at_kw("by"):
                    self.advance()
                seq.increment = _int()
                if seq.increment == 0:
                    raise ParseError("INCREMENT must be non-zero")
            elif self._at_ident("minvalue"):
                self.advance()
                seq.minvalue = _int()
            elif self._at_ident("maxvalue"):
                self.advance()
                seq.maxvalue = _int()
            elif self._at_ident("nominvalue") or self._at_ident("nomaxvalue"):
                self.advance()
            elif self._at_ident("cache"):
                self.advance()
                seq.cache = _int(allow_neg=False)
            elif self._at_ident("nocache"):
                self.advance()
                seq.cache = 0
            elif self._at_ident("cycle"):
                self.advance()
                seq.cycle = True
            elif self._at_ident("nocycle"):
                self.advance()
                seq.cycle = False
            else:
                break
        return seq

    def _parse_range_partition_items(self):
        """PARTITION p VALUES {LESS THAN ((expr)|MAXVALUE) | IN (expr,
        ...)}[, ...] — shared by CREATE TABLE ... PARTITION BY
        RANGE/LIST and ALTER TABLE ADD PARTITION. Range items carry the
        bound expr (None = MAXVALUE); list items carry ("in", [exprs])
        — _encode_partition validates kind consistency."""
        parts = []
        while True:
            self.expect_kw("partition")
            pname = self.expect_ident().lower()
            self.expect_kw("values")
            if self.accept_kw("in"):
                self.expect_op("(")
                vals = [self.parse_expr()]
                while self.accept_op(","):
                    vals.append(self.parse_expr())
                self.expect_op(")")
                parts.append((pname, ("in", vals)))
                if not self.accept_op(","):
                    break
                continue
            if not (self.cur.kind == "id" and self.cur.text.lower() == "less"):
                raise ParseError("expected VALUES LESS THAN or VALUES IN")
            self.advance()
            if not (self.cur.kind == "id" and self.cur.text.lower() == "than"):
                raise ParseError("expected THAN")
            self.advance()
            if self.cur.kind == "id" and self.cur.text.lower() == "maxvalue":
                self.advance()
                upper = None
            else:
                self.expect_op("(")
                ue = self.parse_expr()
                self.expect_op(")")
                upper = ue
            parts.append((pname, upper))
            if not self.accept_op(","):
                break
        return parts

    def _partition_name_list(self):
        """Comma-separated partition names; a comma followed by another
        ALTER action keyword ends the list (the spec loop then reports
        the cannot-combine error instead of a bogus parse failure)."""
        names = [self.expect_ident().lower()]
        while True:
            mark = self.i
            if not self.accept_op(","):
                break
            # a partition NAME here is followed by ',' or end-of-spec;
            # an ACTION word is followed by its own grammar — peek one
            # token so partitions legitimately named modify/exchange/...
            # still parse while ', change column ...' ends the list
            nxt = self.toks[self.i + 1]
            looks_action = (
                (
                    self.cur.kind == "kw"
                    and self.cur.text in ("add", "drop", "alter")
                )
                or (
                    (self._at_ident("change") or self._at_ident("modify"))
                    and nxt.kind in ("id", "kw")
                )
                or (
                    self._at_ident("rename")
                    and nxt.kind == "kw"
                    and nxt.text in ("to", "as", "column")
                )
                or (
                    (
                        self._at_ident("truncate")
                        or self._at_ident("exchange")
                    )
                    and nxt.kind == "kw"
                    and nxt.text == "partition"
                )
            )
            if looks_action:
                self.i = mark  # leave the comma for the spec loop
                break
            names.append(self.expect_ident().lower())
        return names

    def parse_alter(self):
        self.expect_kw("alter")
        if self._at_ident("resource"):
            self.advance()
            self._expect_ident_kw("group")
            name = self.expect_ident()
            ru, burst = self._resource_group_options()
            return ast.ResourceGroupDDL(
                "alter", name, ru_per_sec=ru, burstable=burst
            )
        self.expect_kw("table")
        db, name = self._qualified_name()
        specs = [self._parse_alter_spec(db, name)]
        while self.accept_op(","):
            specs.append(self._parse_alter_spec(db, name))
        if len(specs) == 1:
            return specs[0]
        return ast.MultiAlter(db, name, specs)

    def _default_const(self):
        """DEFAULT <literal> with negative-number folding — one grammar
        for every DEFAULT site (column tail, SET DEFAULT)."""
        neg = self.accept_op("-")
        d = self.parse_primary()
        if not isinstance(d, ast.Const):
            raise ParseError("DEFAULT must be a constant")
        if neg:
            if not isinstance(d.value, (int, float)):
                raise ParseError("DEFAULT must be a constant")
            d = ast.Const(-d.value)
        return d

    def _parse_alter_spec(self, db, name):
        """One comma-separated ALTER TABLE action (MySQL multi-spec /
        the reference's multi-schema change, pkg/ddl multiSchemaChange)."""
        if self.accept_kw("alter"):
            # ALTER INDEX i {VISIBLE|INVISIBLE} |
            # ALTER [COLUMN] c SET DEFAULT <const> | DROP DEFAULT
            if self.accept_kw("index"):
                iname = self.expect_ident().lower()
                vis = self.expect_ident().lower()
                if vis not in ("visible", "invisible"):
                    raise ParseError("expected VISIBLE or INVISIBLE")
                return ast.AlterTable(
                    db, name, "index_visibility", col_name=iname,
                    new_name=vis,
                )
            self.accept_kw("column")
            cname = self.expect_ident()
            if self.accept_kw("set"):
                self.expect_kw("default")
                d = self._default_const()
                return ast.AlterTable(
                    db, name, "set_default", col_name=cname,
                    default=d.value,
                )
            if self.accept_kw("drop"):
                self.expect_kw("default")
                return ast.AlterTable(
                    db, name, "drop_default", col_name=cname
                )
            raise ParseError("ALTER COLUMN expects SET/DROP DEFAULT")
        if self.accept_kw("add"):
            if self.at_kw("unique", "index", "key"):
                unique = self.accept_kw("unique")
                if not (self.accept_kw("index") or self.accept_kw("key")):
                    if not unique:
                        raise ParseError("expected INDEX or KEY")
                # MySQL allows an anonymous index: name auto-generates
                # from the first column
                iname = None if self.at_op("(") else self.expect_ident()
                self.expect_op("(")
                icols = [self.expect_ident()]
                while self.accept_op(","):
                    icols.append(self.expect_ident())
                self.expect_op(")")
                if iname is None:
                    iname = icols[0]
                return ast.CreateIndex(db, name, iname, icols, False, unique)
            if self.accept_kw("partition"):
                self.expect_op("(")
                parts = self._parse_range_partition_items()
                self.expect_op(")")
                return ast.AlterTable(
                    db, name, "add_partition", partitions=parts
                )
            self.accept_kw("column")
            cd, default = self._alter_column_tail(self.expect_ident())
            return ast.AlterTable(db, name, "add", column=cd, default=default)
        if self.accept_kw("drop"):
            if self.accept_kw("partition"):
                return ast.AlterTable(
                    db, name, "drop_partition",
                    partitions=self._partition_name_list(),
                )
            if self.accept_kw("index") or self.accept_kw("key"):
                return ast.DropIndex(db, name, self.expect_ident())
            self.accept_kw("column")
            return ast.AlterTable(db, name, "drop", col_name=self.expect_ident())
        if self._at_ident("truncate"):  # "truncate" lexes as an ident
            self.advance()
            self.expect_kw("partition")
            return ast.AlterTable(
                db, name, "truncate_partition",
                partitions=self._partition_name_list(),
            )
        if self._at_ident("exchange"):
            self.advance()
            self.expect_kw("partition")
            pname = self.expect_ident().lower()
            self.expect_kw("with")
            self.expect_kw("table")
            tdb, tname = self._qualified_name()
            validate = True
            if self.accept_kw("with"):
                self._expect_ident_kw("validation")
            elif self._at_ident("without"):
                self.advance()
                self._expect_ident_kw("validation")
                validate = False
            return ast.AlterTable(
                db, name, "exchange_partition",
                partitions=[pname], exchange=(tdb, tname, validate),
            )
        if self._at_ident("modify"):
            self.advance()
            self.accept_kw("column")
            cd, default = self._alter_column_tail(self.expect_ident())
            return ast.AlterTable(db, name, "modify", column=cd, default=default)
        if self._at_ident("change"):
            self.advance()
            self.accept_kw("column")
            old = self.expect_ident()
            cd, default = self._alter_column_tail(self.expect_ident())
            return ast.AlterTable(
                db, name, "change", column=cd, col_name=old, default=default
            )
        if self._at_ident("rename"):
            self.advance()
            if self.accept_kw("column"):
                old = self.expect_ident()
                self._expect_ident_kw("to")
                return ast.AlterTable(
                    db, name, "rename_col", col_name=old,
                    new_name=self.expect_ident(),
                )
            # TO/AS optional (MySQL); both always lex as keywords
            self.accept_kw("to") or self.accept_kw("as")
            return ast.AlterTable(
                db, name, "rename", new_name=self.expect_ident()
            )
        raise ParseError(
            "ALTER TABLE supports ADD/DROP/MODIFY/CHANGE COLUMN, "
            "RENAME COLUMN, RENAME TO"
        )

    def _alter_column_tail(self, cname: str):
        """<type> [NOT NULL | NULL | DEFAULT <const> |
        [GENERATED ALWAYS] AS (expr) [VIRTUAL|STORED]]* after a column
        name in ADD/MODIFY/CHANGE COLUMN."""
        ctype = self.parse_type()
        default = None
        not_null = False
        generated = None
        while True:  # NOT NULL / DEFAULT in either order (MySQL)
            if self.accept_kw("not"):
                self.expect_kw("null")
                not_null = True
            elif self.accept_kw("null"):
                pass
            elif self.accept_kw("default"):
                default = self._default_const().value
            elif self._at_generated_clause():
                generated = self._parse_generated_clause()
            else:
                break
        cd = ast.ColumnDef(cname, ctype, not_null=not_null)
        cd.generated = generated
        return cd, default

    def _at_generated_clause(self) -> bool:
        return self._at_ident("generated") or (
            self.at_kw("as") and self.toks[self.i + 1].text == "("
        )

    def _parse_generated_clause(self):
        """[GENERATED ALWAYS] AS (expr) [VIRTUAL|STORED] ->
        (expr SQL text, parsed expr, stored?). Shared by the CREATE
        TABLE column loop and ALTER ADD/MODIFY/CHANGE column tails."""
        if self._at_ident("generated"):
            self.advance()
            if not self._at_ident("always"):
                raise ParseError("expected ALWAYS after GENERATED")
            self.advance()
            self.expect_kw("as")
        else:
            self.advance()
        self.expect_op("(")
        gstart = self.cur.pos
        gexpr = self.parse_expr()
        gend = self.cur.pos
        self.expect_op(")")
        stored = False
        if self._at_ident("stored"):
            self.advance()
            stored = True
        elif self._at_ident("virtual"):
            self.advance()
        return (self.sql[gstart:gend].strip(), gexpr, stored)

    def _if_not_exists(self) -> bool:
        if self.accept_kw("if"):
            self.expect_kw("not")
            self.expect_kw("exists")
            return True
        return False

    def _qualified_name(self) -> Tuple[Optional[str], str]:
        a = self.expect_ident()
        if self.accept_op("."):
            return a, self.expect_ident()
        return None, a

    def parse_drop(self):
        self.expect_kw("drop")
        if self._at_ident("resource"):
            self.advance()
            self._expect_ident_kw("group")
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            return ast.ResourceGroupDDL(
                "drop", self.expect_ident(), if_exists=if_exists
            )
        if self._at_ident("view"):
            self.advance()
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            db, name = self._qualified_name()
            return ast.DropView(db, name, if_exists)
        if self.accept_kw("database"):
            return ast.DropDatabase(self.expect_ident())
        if self.accept_kw("binding"):
            self.expect_kw("for")
            start = self.cur.pos
            self.parse_select_or_union()
            return ast.CreateBinding(
                self.sql[start : self.cur.pos].strip(), "", drop=True
            )
        if self.accept_kw("user"):
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            return ast.DropUser(self._user_name(), if_exists)
        if self.accept_kw("index"):
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            iname = self.expect_ident()
            self.expect_kw("on")
            db, tname = self._qualified_name()
            return ast.DropIndex(db, tname, iname, if_exists)
        if self._at_ident("sequence"):
            self.advance()
            if_exists = False
            if self.accept_kw("if"):
                self.expect_kw("exists")
                if_exists = True
            db, name = self._qualified_name()
            return ast.DropSequence(db, name, if_exists)
        temporary = False
        if self._at_ident("temporary"):
            self.advance()
            temporary = True
        self.expect_kw("table")
        if_exists = False
        if self.accept_kw("if"):
            self.expect_kw("exists")
            if_exists = True
        db, name = self._qualified_name()
        return ast.DropTable(db, name, if_exists, temporary=temporary)

    def parse_insert(self, skip_verb: bool = False):
        if not skip_verb:
            self.expect_kw("insert")
        ignore = self.accept_kw("ignore")
        self.accept_kw("into")
        db, name = self._qualified_name()
        columns = None
        if self.accept_op("("):
            columns = [self.expect_ident()]
            while self.accept_op(","):
                columns.append(self.expect_ident())
            self.expect_op(")")
        if self.at_kw("select", "with"):
            q = (
                self.parse_with()
                if self.at_kw("with")
                else self.parse_select_or_union()
            )
            return ast.Insert(db, name, columns, [], query=q, ignore=ignore,
                              on_dup=self._on_duplicate_key())
        if columns is None and self.accept_kw("set"):
            # INSERT INTO t SET a = 1, b = 2 (MySQL single-row sugar);
            # falls through to the shared ON DUPLICATE KEY parsing
            columns, row = [], []
            while True:
                columns.append(self.expect_ident())
                self.expect_op("=")
                row.append(self.parse_expr())
                if not self.accept_op(","):
                    break
            rows = [row]
        else:
            self.expect_kw("values")
            rows = []
            while True:
                self.expect_op("(")
                row = [self._values_item()]
                while self.accept_op(","):
                    row.append(self._values_item())
                self.expect_op(")")
                rows.append(row)
                if not self.accept_op(","):
                    break
        return ast.Insert(
            db, name, columns, rows, ignore=ignore, on_dup=self._on_duplicate_key()
        )

    def _on_duplicate_key(self):
        """[ON DUPLICATE KEY UPDATE col = expr, ...] after an INSERT's
        rows: its assignments, or None. It follows a SELECT source too
        (MySQL's INSERT ... SELECT ... ON DUPLICATE KEY UPDATE), where the
        JAX package's parser stops."""
        if not self.accept_kw("on"):
            return None
        if not self._at_ident("duplicate"):
            raise ParseError("expected DUPLICATE after ON")
        self.advance()
        self.expect_kw("key")
        self.expect_kw("update")
        on_dup = []
        while True:
            col = self.expect_ident()
            self.expect_op("=")
            on_dup.append((col, self.parse_expr()))
            if not self.accept_op(","):
                break
        return on_dup

    def _values_item(self):
        """One VALUES item. A lone number, string or NULL followed by
        ',' or ')' (a bulk INSERT's rows) is its literal as the
        expression descent would make it, without that descent; anything
        else parses as an expression."""
        t, nxt = self.toks[self.i], self.toks[self.i + 1]
        if nxt.kind == "op" and nxt.text in (",", ")"):
            if t.kind == "num":
                self.i += 1
                return ast.Const(int(t.text) if t.text.isascii() and t.text.isdigit()
                                 else float(t.text))
            if t.kind == "str":
                self.i += 1
                return ast.Const(t.text)
            if t.kind == "kw" and t.text == "null":
                self.i += 1
                return ast.Const(None)
        return self.parse_expr()

    def _delete_target(self):
        """One DELETE target: [db.]name[.*] — the trailing .* is noise
        MySQL accepts (DELETE t1.* FROM ...)."""
        db, name = None, self.expect_ident()
        if self.accept_op("."):
            if self.at_op("*"):
                self.advance()
                return db, name
            db, name = name, self.expect_ident()
        if self.accept_op("."):
            self.expect_op("*")
        return db, name

    def _dml_order_limit(self):
        """[ORDER BY items] [LIMIT n] tail of single-table DELETE/UPDATE
        (MySQL batch-DML form)."""
        order_by = []
        if self.accept_kw("order"):
            self.expect_kw("by")
            order_by.append(self.parse_order_item())
            while self.accept_op(","):
                order_by.append(self.parse_order_item())
        limit = None
        if self.accept_kw("limit"):
            limit = self.parse_int()
        return order_by, limit

    def parse_delete(self):
        self.expect_kw("delete")
        if self.accept_kw("from"):
            db, name = self._qualified_name()
            alias = None
            if self.accept_kw("as"):
                alias = self.expect_ident()
            elif self.cur.kind == "id":
                alias = self.advance().text
            if self.accept_kw("using"):
                # DELETE FROM t USING t JOIN u ... : rows of t matched by
                # the joined source are deleted
                refs = self.parse_table_refs()
                where = self.parse_expr() if self.accept_kw("where") else None
                return ast.Delete(
                    None, name, where,
                    targets=[(db, alias or name)], from_refs=refs,
                )
            where = self.parse_expr() if self.accept_kw("where") else None
            order_by, limit = self._dml_order_limit()
            if alias is not None:
                if order_by or limit is not None:
                    raise ParseError(
                        "DELETE ... ORDER BY/LIMIT does not take a "
                        "table alias"
                    )
                # single-table with alias: route through the multi-table
                # machinery so WHERE sees the alias qualifier
                return ast.Delete(
                    None, name, where,
                    targets=[(db, alias)],
                    from_refs=ast.TableRef(db, name, alias),
                )
            return ast.Delete(
                db, name, where, order_by=order_by, limit=limit
            )
        # DELETE t1[, t2] FROM <joined refs> [WHERE ...]
        targets = [self._delete_target()]
        while self.accept_op(","):
            targets.append(self._delete_target())
        self.expect_kw("from")
        refs = self.parse_table_refs()
        where = self.parse_expr() if self.accept_kw("where") else None
        return ast.Delete(None, targets[0][1], where, targets=targets, from_refs=refs)

    def parse_update(self):
        self.expect_kw("update")
        refs = self.parse_table_refs()
        self.expect_kw("set")
        sets = []
        qualified = False
        while True:
            col = self.expect_ident()
            if self.accept_op("."):
                col = col + "." + self.expect_ident()
                qualified = True
            self.expect_op("=")
            sets.append((col, self.parse_expr()))
            if not self.accept_op(","):
                break
        where = self.parse_expr() if self.accept_kw("where") else None
        order_by, limit = self._dml_order_limit()
        if (
            isinstance(refs, ast.TableRef)
            and refs.alias is None
            and not qualified
        ):
            return ast.Update(
                refs.db, refs.name, sets, where,
                order_by=order_by, limit=limit,
            )
        if order_by or limit is not None:
            raise ParseError(
                "UPDATE ... ORDER BY/LIMIT takes a single plain table "
                "(no alias, no joins)"
            )
        return ast.Update(None, "", sets, where, from_refs=refs)


def parse(sql: str):
    """Parse one or more ;-separated statements; returns a list."""
    return parse_tokens(sql)[0]


def parse_tokens(sql: str):
    """``parse``, and the tokens it read: the statement digest is built
    from them (``utils.metrics.digest_tokens``), so no text is tokenized
    twice. The parse never changes a token."""
    p = Parser(sql)
    stmts = []
    while p.cur.kind != "eof":
        if p.accept_op(";"):
            continue
        stmts.append(p.parse_stmt())
        if p.cur.kind not in ("eof",) and not p.at_op(";"):
            raise ParseError(f"trailing input at {p.cur.pos}: {p.cur.text!r}")
    return stmts, p.toks


def parse_expr(sql: str):
    p = Parser(sql)
    e = p.parse_expr()
    if p.cur.kind != "eof":
        raise ParseError(f"trailing input at {p.cur.pos}")
    return e
