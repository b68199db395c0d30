"""Hand-written recursive-descent SQL parser (Postgres dialect subset).

A copy of ``risingwave_tpu/sql/parser.py``, unchanged except that its imports
name this package: the module imports no JAX, and the port keeps its
own copy instead of importing the reference package.

Reference counterpart: ``src/sqlparser/src/parser.rs`` — same approach
(tokenizer + recursive descent with precedence climbing), scoped to the
streaming benchmark surface: CREATE SOURCE / CREATE MATERIALIZED VIEW /
SELECT with windows (TUMBLE/HOP), joins, aggregation, TopN, casts,
CASE, intervals.
"""

from __future__ import annotations

import re

from risingwave_tpu_torch.sql import ast

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>--[^\n]*)
  | (?P<number>\d+\.\d+|\.\d+|\d+)
  | (?P<string>'(?:[^']|'')*')
  | (?P<dollar>\$(?P<dtag>[A-Za-z_]*)\$.*?\$(?P=dtag)\$)
  | (?P<cast>::)
  | (?P<op><=|>=|<>|!=|\|\||[-+*/%<>=(),.;\[\]])
  | (?P<ident>[A-Za-z_][A-Za-z0-9_]*|"[^"]+")
    """,
    re.VERBOSE | re.DOTALL,
)

_INTERVAL_UNITS = {
    "second": 1_000_000, "seconds": 1_000_000,
    "minute": 60_000_000, "minutes": 60_000_000,
    "hour": 3_600_000_000, "hours": 3_600_000_000,
    "day": 86_400_000_000, "days": 86_400_000_000,
    "millisecond": 1_000, "milliseconds": 1_000,
}

#: calendar units carried as a months count (ref Interval {months,
#: days, usecs}); consumed by bind-time date-arithmetic folding
_INTERVAL_MONTH_UNITS = {
    "month": 1, "months": 1, "year": 12, "years": 12,
}


class Token:
    __slots__ = ("kind", "value")

    def __init__(self, kind: str, value: str):
        self.kind = kind
        self.value = value

    def __repr__(self):
        return f"{self.kind}:{self.value}"


def tokenize(sql: str) -> list[Token]:
    out = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            raise ParseError(f"unexpected character {sql[pos]!r} at {pos}")
        pos = m.end()
        if m.group("dollar") is not None:
            # dollar-quoted body: strip the $tag$ ... $tag$ delimiters
            raw = m.group("dollar")
            ntag = len(m.group("dtag")) + 2
            out.append(Token("dollar_string", raw[ntag:-ntag]))
            continue
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        text = m.group()
        if kind == "ident" and not text.startswith('"'):
            out.append(Token("word", text.lower()))
        elif kind == "ident":
            out.append(Token("word", text[1:-1]))
        else:
            out.append(Token(kind, text))
    return out


class ParseError(ValueError):
    pass


# operator precedence (higher binds tighter)
_PRECEDENCE = {
    "or": 1, "and": 2,
    "=": 4, "<>": 4, "!=": 4, "<": 4, "<=": 4, ">": 4, ">=": 4,
    "+": 6, "-": 6, "||": 6,
    "*": 7, "/": 7, "%": 7,
}

_BIN_NAMES = {
    "=": "equal", "<>": "not_equal", "!=": "not_equal",
    "<": "less_than", "<=": "less_than_or_equal",
    ">": "greater_than", ">=": "greater_than_or_equal",
    "+": "add", "-": "subtract", "*": "multiply", "/": "divide",
    "%": "modulus", "and": "and", "or": "or", "||": "concat",
}


class Parser:
    def __init__(self, sql: str):
        self.tokens = tokenize(sql)
        self.i = 0

    # -- token helpers --------------------------------------------------
    def peek(self, offset: int = 0) -> Token | None:
        j = self.i + offset
        return self.tokens[j] if j < len(self.tokens) else None

    def next(self) -> Token:
        t = self.peek()
        if t is None:
            raise ParseError("unexpected end of input")
        self.i += 1
        return t

    def accept_word(self, *words: str) -> bool:
        t = self.peek()
        if t and t.kind == "word" and t.value in words:
            self.i += 1
            return True
        return False

    def expect_word(self, word: str) -> None:
        t = self.next()
        if t.kind != "word" or t.value != word:
            raise ParseError(f"expected {word.upper()}, got {t.value!r}")

    def accept_op(self, op: str) -> bool:
        t = self.peek()
        if t and t.kind in ("op", "cast") and t.value == op:
            self.i += 1
            return True
        return False

    def expect_op(self, op: str) -> None:
        t = self.next()
        if t.value != op:
            raise ParseError(f"expected {op!r}, got {t.value!r}")

    def ident(self) -> str:
        t = self.next()
        if t.kind != "word":
            raise ParseError(f"expected identifier, got {t.value!r}")
        return t.value

    # -- entry ----------------------------------------------------------
    def parse_statement(self):
        if self.accept_word("explain"):
            return ast.Explain(self.parse_statement())
        if self.accept_word("create"):
            return self._create()
        if self.accept_word("drop"):
            return self._drop()
        if self.accept_word("describe"):
            return ast.DescribeStatement(self.ident())
        if self.accept_word("show"):
            if self.accept_word("parameters") or self.accept_word("all"):
                return ast.ShowParameters()
            if self.accept_word("columns"):
                self.expect_word("from")
                return ast.DescribeStatement(self.ident())
            kind = self.ident()
            if kind == "materialized":
                self.expect_word("views")
                kind = "materialized views"
            return ast.ShowStatement(kind)
        if self.accept_word("alter"):
            if self.accept_word("system"):
                self.expect_word("set")
                return self._set(system=True)
            self.expect_word("materialized")
            self.expect_word("view")
            name = self.ident()
            self.expect_word("set")
            self.expect_word("parallelism")
            self.accept_op("=") or self.accept_word("to")
            t = self.next()
            if t.kind != "number" or not t.value.isdigit():
                raise ParseError("SET PARALLELISM needs an integer")
            return ast.AlterParallelism(name, int(t.value))
        if self.accept_word("set"):
            return self._set(system=False)
        if self.accept_word("insert"):
            self.expect_word("into")
            name, cols, rows = self._dml_values()
            return ast.Insert(name, tuple(cols), tuple(rows))
        if self.accept_word("delete"):
            self.expect_word("from")
            name, cols, rows = self._dml_values()
            return ast.Delete(name, tuple(cols), tuple(rows))
        if self.accept_word("update"):
            # UPDATE t SET col = lit, ... WHERE <full-pk equality> —
            # sugar the engine desugars to the exact-full-row
            # DELETE+INSERT retraction pair
            name = self.ident()
            self.expect_word("set")
            assignments = []
            while True:
                col = self.ident()
                self.expect_op("=")
                assignments.append((col, self._expr()))
                if not self.accept_op(","):
                    break
            self.expect_word("where")
            return ast.Update(name, tuple(assignments), self._expr())
        if self.accept_word("flush"):
            return ast.FlushStatement()
        if self.peek() and self.peek().value == "select":
            return self._select()
        raise ParseError(f"unsupported statement at {self.peek()}")

    def _dml_values(self):
        """Shared INSERT/DELETE tail: ``t [(col,...)] VALUES (...), ...``
        (DELETE retracts by exact full row — see ast.Delete)."""
        name = self.ident()
        cols: list[str] = []
        if self.accept_op("("):
            while True:
                cols.append(self.ident())
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        self.expect_word("values")
        rows = []
        while True:
            self.expect_op("(")
            row = [self._expr()]
            while self.accept_op(","):
                row.append(self._expr())
            self.expect_op(")")
            rows.append(tuple(row))
            if not self.accept_op(","):
                break
        return name, cols, rows

    def _set(self, system: bool):
        name = self.ident()
        while self.accept_op("."):
            name += "." + self.ident()
        if not self.accept_op("="):
            self.expect_word("to")
        t = self.next()
        if t.kind == "number":
            value = float(t.value) if "." in t.value else int(t.value)
        elif t.kind == "string":
            value = t.value[1:-1]
        elif t.kind == "word" and t.value in ("true", "false"):
            value = t.value == "true"
        else:
            value = t.value
        return ast.SetStatement(name, value, system)

    # -- DDL ------------------------------------------------------------
    def _if_not_exists(self) -> bool:
        if self.accept_word("if"):
            self.expect_word("not")
            self.expect_word("exists")
            return True
        return False

    def _create(self):
        is_table = False
        if self.peek() and self.peek().value == "table":
            is_table = True
        if self.accept_word("source") or self.accept_word("table"):
            ine = self._if_not_exists()
            name = self.ident()
            columns: list[ast.ColumnDef] = []
            watermark = None
            primary_key: tuple[str, ...] = ()
            if self.accept_op("("):
                while True:
                    if self.accept_word("watermark"):
                        self.expect_word("for")
                        wcol = self.ident()
                        self.expect_word("as")
                        expr = self._expr()
                        watermark = ast.WatermarkDef(
                            wcol, self._watermark_delay(expr, wcol)
                        )
                    elif self.accept_word("primary"):
                        # table constraint: PRIMARY KEY (col, ...)
                        self.expect_word("key")
                        self.expect_op("(")
                        pk = [self.ident()]
                        while self.accept_op(","):
                            pk.append(self.ident())
                        self.expect_op(")")
                        primary_key = tuple(pk)
                    else:
                        cname = self.ident()
                        ctype = self._type_name()
                        nullable = False
                        if self.accept_word("null"):
                            nullable = True
                        elif self.accept_word("not"):
                            self.expect_word("null")
                        if self.accept_word("primary"):
                            self.expect_word("key")
                            primary_key = (cname,)
                        columns.append(
                            ast.ColumnDef(cname, ctype, nullable)
                        )
                    if not self.accept_op(","):
                        break
                self.expect_op(")")
            options = self._with_options()
            return ast.CreateSource(name, tuple(columns), watermark, options,
                                    ine, is_table, primary_key)
        if self.accept_word("sink"):
            ine = self._if_not_exists()
            name = self.ident()
            query = None
            from_rel = None
            if self.accept_word("as"):
                query = self._select()
            else:
                self.expect_word("from")
                from_rel = self.ident()
            options = self._with_options()
            return ast.CreateSink(name, query, from_rel, options, ine)
        if self.accept_word("materialized"):
            self.expect_word("view")
            ine = self._if_not_exists()
            name = self.ident()
            # WITH (ttl = '<n>', ...) rides between the name and AS
            # (the pushdown plane's expiry-policy surface)
            options = self._with_options()
            self.expect_word("as")
            query = self._select()
            eowc = False
            if self.accept_word("emit"):
                self.expect_word("on")
                self.expect_word("window")
                self.expect_word("close")
                eowc = True
            return ast.CreateMaterializedView(name, query, ine, eowc,
                                              options)
        if self.accept_word("index"):
            # CREATE INDEX name ON mv(col, ...) — a secondary-index MV
            ine = self._if_not_exists()
            name = self.ident()
            self.expect_word("on")
            table = self.ident()
            self.expect_op("(")
            cols = [self.ident()]
            while self.accept_op(","):
                cols.append(self.ident())
            self.expect_op(")")
            return ast.CreateIndex(name, table, tuple(cols), ine)
        if self.accept_word("function"):
            # CREATE FUNCTION f(a type, b type) RETURNS type
            #   LANGUAGE SQL AS $$SELECT <expr>$$
            ine = self._if_not_exists()
            name = self.ident()
            params: list[str] = []
            self.expect_op("(")
            if not (self.peek() and self.peek().value == ")"):
                while True:
                    params.append(self.ident())
                    self._type_name()  # param types are documentation
                    if not self.accept_op(","):
                        break
            self.expect_op(")")
            self.expect_word("returns")
            self._type_name()
            self.expect_word("language")
            lang = self.ident()
            if lang != "sql":
                raise ParseError(
                    f"LANGUAGE {lang} not supported (SQL UDFs only)"
                )
            self.expect_word("as")
            t = self.next()
            if t.kind == "dollar_string":
                body_sql = t.value
            elif t.kind == "string":
                body_sql = t.value[1:-1].replace("''", "'")
            else:
                raise ParseError("expected a quoted function body")
            return ast.CreateFunction(name, tuple(params), body_sql, ine)
        raise ParseError(
            "expected SOURCE, TABLE, INDEX or MATERIALIZED VIEW"
        )

    def _with_options(self) -> dict:
        options: dict = {}
        if self.accept_word("with"):
            self.expect_op("(")
            while True:
                k = self.ident()
                while self.accept_op("."):  # dotted option keys
                    k += "." + self.ident()
                self.expect_op("=")
                v = self.next()
                if v.kind == "string":
                    options[k] = v.value[1:-1].replace("''", "'")
                else:
                    options[k] = v.value
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        return options

    def _watermark_delay(self, expr, wcol: str) -> ast.IntervalLit:
        """WATERMARK FOR c AS c - INTERVAL 'x' => the delay interval."""
        if isinstance(expr, ast.ColumnRef) and expr.name == wcol:
            return ast.IntervalLit(0)
        if (isinstance(expr, ast.BinaryOp) and expr.op == "subtract"
                and isinstance(expr.left, ast.ColumnRef)
                and expr.left.name == wcol
                and isinstance(expr.right, ast.IntervalLit)):
            return expr.right
        raise ParseError("watermark must be `col` or `col - INTERVAL '...'`")

    def _type_name(self) -> str:
        parts = [self.ident()]
        # multi-word types: double precision, timestamp with time zone, …
        while True:
            t = self.peek()
            if t and t.kind == "word" and t.value in (
                "precision", "varying", "with", "without", "time", "zone",
            ):
                parts.append(self.next().value)
            else:
                break
        name = " ".join(parts)
        # parameterized types: VARCHAR(100), NUMERIC(10, 2)
        if name in ("varchar", "char", "character", "character varying",
                    "decimal", "numeric") and self.accept_op("("):
            args = [self._type_param()]
            while self.accept_op(","):
                args.append(self._type_param())
            self.expect_op(")")
            name += "(" + ",".join(args) + ")"
        return name

    def _type_param(self) -> str:
        t = self.next()
        if t.kind != "number" or not t.value.lstrip("-").isdigit():
            raise ParseError(f"expected integer type parameter, got "
                             f"{t.value!r}")
        return t.value

    def _drop(self):
        # source | table | sink | index | materialized view
        kind = self.ident()
        if kind == "materialized":
            self.expect_word("view")
            kind = "materialized view"
        if_exists = False
        if self.accept_word("if"):
            self.expect_word("exists")
            if_exists = True
        return ast.DropStatement(kind, self.ident(), if_exists)

    # -- SELECT ---------------------------------------------------------
    def _select(self) -> ast.Select:
        if self.accept_word("with"):
            # WITH name [(col,...)] AS (select) [, ...] select — CTEs
            # inline as derived tables (the reference's share/DAG dedup
            # merges repeated uses back into one plan; here the DAG
            # builder's shared-source merge plays that role)
            ctes: dict[str, ast.Select] = {}
            while True:
                name = self.ident()
                cols: list[str] = []
                if self.accept_op("("):
                    while True:
                        cols.append(self.ident())
                        if not self.accept_op(","):
                            break
                    self.expect_op(")")
                self.expect_word("as")
                self.expect_op("(")
                sub = self._select()
                self.expect_op(")")
                if cols:
                    sub = _realias(sub, cols)
                ctes[name] = sub
                if not self.accept_op(","):
                    break
            body = self._select()
            return _substitute_ctes(body, ctes)
        self.expect_word("select")
        items = []
        while True:
            if self.accept_op("*"):
                items.append(ast.SelectItem(ast.Star(), None))
            else:
                e = self._expr()
                alias = None
                if self.accept_word("as"):
                    alias = self.ident()
                elif (self.peek() and self.peek().kind == "word"
                      and self.peek().value not in (
                          "from", "where", "group", "having", "order",
                          "limit", "offset", "emit",
                      )):
                    alias = self.ident()
                items.append(ast.SelectItem(e, alias))
            if not self.accept_op(","):
                break
        from_ = None
        if self.accept_word("from"):
            from_ = self._table_expr()
        where = self._expr() if self.accept_word("where") else None
        group_by: list = []
        if self.accept_word("group"):
            self.expect_word("by")
            while True:
                group_by.append(self._expr())
                if not self.accept_op(","):
                    break
        having = self._expr() if self.accept_word("having") else None
        order_by: list[ast.OrderItem] = []
        if self.accept_word("order"):
            self.expect_word("by")
            while True:
                e = self._expr()
                desc = False
                if self.accept_word("desc"):
                    desc = True
                elif self.accept_word("asc"):
                    pass
                order_by.append(ast.OrderItem(e, desc))
                if not self.accept_op(","):
                    break
        limit = offset = None
        if self.accept_word("limit"):
            limit = int(self.next().value)
        if self.accept_word("offset"):
            offset = int(self.next().value)
        return ast.Select(
            tuple(items), from_, where, tuple(group_by), having,
            tuple(order_by), limit, offset,
        )

    def _table_expr(self):
        left = self._table_factor()
        while True:
            kind = None
            if self.accept_op(","):
                # comma join: equi-conditions live in WHERE (the
                # planner mines them — classic implicit-join rewrite)
                right = self._table_factor()
                left = ast.Join(left, right, None, "cross")
                continue
            if self.accept_word("join") or self.accept_word("inner"):
                if self.peek() and self.peek().value == "join":
                    self.next()
                kind = "inner"
            elif self.accept_word("left"):
                self.accept_word("outer")
                self.expect_word("join")
                kind = "left"
            elif self.accept_word("right"):
                self.accept_word("outer")
                self.expect_word("join")
                kind = "right"
            elif self.accept_word("full"):
                self.accept_word("outer")
                self.expect_word("join")
                kind = "full"
            else:
                break
            right = self._table_factor()
            self.expect_word("on")
            on = self._expr()
            if getattr(right, "temporal", False):
                if kind not in ("inner", "left"):
                    raise ParseError(
                        "FOR SYSTEM_TIME joins support INNER/LEFT"
                    )
                kind = "temporal" if kind == "inner" else "temporal_left"
            left = ast.Join(left, right, on, kind)
        return left

    def _table_factor(self):
        t = self.peek()
        if t and t.kind == "op" and t.value == "(":
            # derived table: ( SELECT ... ) [AS] alias [(col, ...)]
            self.expect_op("(")
            select = self._select()
            self.expect_op(")")
            alias = None
            if self.accept_word("as"):
                alias = self.ident()
            elif (self.peek() and self.peek().kind == "word"
                  and self.peek().value not in (
                      "join", "inner", "left", "right", "full", "on",
                      "where", "group", "having", "order", "limit",
                      "offset", "emit",
                  )):
                alias = self.ident()
            if alias is not None and self.accept_op("("):
                # column alias list renames the derived table's output
                cols = [self.ident()]
                while self.accept_op(","):
                    cols.append(self.ident())
                self.expect_op(")")
                select = _realias(select, cols)
            return ast.SubqueryRef(select, alias)
        if t and t.value in ("tumble", "hop"):
            fn = self.next().value
            self.expect_op("(")
            table = ast.TableRef(self.ident())
            self.expect_op(",")
            col = self.ident()
            self.expect_op(",")
            iv1 = self._expr()
            iv2 = None
            if fn == "hop":
                self.expect_op(",")
                iv2 = self._expr()
            self.expect_op(")")
            alias = None
            if self.accept_word("as"):
                alias = self.ident()
            elif (self.peek() and self.peek().kind == "word"
                  and self.peek().value not in (
                      "join", "inner", "left", "right", "full", "on",
                      "where", "group", "having", "order", "limit",
                      "offset", "emit",
                  )):
                alias = self.ident()
            if fn == "tumble":
                return ast.Tumble(table, col, iv1, alias)
            return ast.Hop(table, col, iv1, iv2, alias)
        name = self.ident()
        temporal = False
        if (self.peek() and self.peek().value == "for"
                and self.peek(1) and self.peek(1).value == "system_time"):
            # t FOR SYSTEM_TIME AS OF PROCTIME(): temporal-join build
            self.next()
            self.next()
            self.expect_word("as")
            self.expect_word("of")
            self.expect_word("proctime")
            self.expect_op("(")
            self.expect_op(")")
            temporal = True
        alias = None
        if self.accept_word("as"):
            alias = self.ident()
        elif (self.peek() and self.peek().kind == "word"
              and self.peek().value not in (
                  "join", "inner", "left", "right", "full", "on", "where",
                  "group", "having", "order", "limit", "offset", "emit",
                  "for",
              )):
            alias = self.ident()
        return ast.TableRef(name, alias, temporal)

    # -- expressions ----------------------------------------------------
    def _expr(self, min_prec: int = 0):
        left = self._unary()
        while True:
            t = self.peek()
            if t is None:
                break
            if t.kind == "word" and t.value in ("like", "between", "in",
                                                "is", "not") \
                    and min_prec <= 4:
                parsed = self._word_op(left)
                if parsed is None:
                    break
                left = parsed
                continue
            op = t.value if t.kind == "op" else (
                t.value if t.kind == "word" and t.value in ("and", "or")
                else None
            )
            if op is None or op not in _PRECEDENCE:
                break
            prec = _PRECEDENCE[op]
            if prec < min_prec:
                break
            self.next()
            right = self._expr(prec + 1)
            left = ast.BinaryOp(_BIN_NAMES[op], left, right)
        return left

    def _word_op(self, left):
        """LIKE / BETWEEN / IN / IS [NOT] NULL postfix operators."""
        negate = False
        if self.peek().value == "not":
            nxt = self.peek(1)
            if not (nxt and nxt.kind == "word"
                    and nxt.value in ("like", "between", "in")):
                return None
            self.next()
            negate = True
        w = self.next().value
        if w == "like":
            pat = self._expr(5)
            out = ast.FuncCall("like", (left, pat))
        elif w == "between":
            lo = self._expr(3)  # stop before AND
            self.expect_word("and")
            hi = self._expr(3)
            out = ast.BinaryOp(
                "and",
                ast.BinaryOp("greater_than_or_equal", left, lo),
                ast.BinaryOp("less_than_or_equal", left, hi),
            )
        elif w == "in":
            self.expect_op("(")
            t = self.peek()
            if t and t.kind == "word" and t.value == "select":
                sub = self._select()
                self.expect_op(")")
                return ast.InSubquery(left, sub, negated=negate)
            items = [self._expr()]
            while self.accept_op(","):
                items.append(self._expr())
            self.expect_op(")")
            out = None
            for it in items:
                eq = ast.BinaryOp("equal", left, it)
                out = eq if out is None else ast.BinaryOp("or", out, eq)
        elif w == "is":
            neg_is = self.accept_word("not")
            self.expect_word("null")
            out = ast.FuncCall(
                "is_not_null" if neg_is else "is_null", (left,)
            )
        else:
            raise ParseError(f"unexpected {w}")
        if negate:
            out = ast.UnaryOp("not", out)
        return out

    def _unary(self):
        if self.accept_op("-"):
            return ast.UnaryOp("neg", self._unary())
        if self.accept_word("not"):
            # postgres: NOT binds LOOSER than LIKE/BETWEEN/IN/comparisons
            return ast.UnaryOp("not", self._expr(3))
        return self._postfix(self._primary())

    def _postfix(self, e):
        while True:
            if self.accept_op("::"):
                e = ast.Cast(e, self._type_name())
                continue
            if self.accept_op("["):
                t = self.next()
                if t.kind != "number" or not t.value.isdigit():
                    raise ParseError(
                        "only literal integer array subscripts are "
                        "supported"
                    )
                self.expect_op("]")
                e = ast.FuncCall(
                    "array_index", (e, ast.Literal(int(t.value), "int"))
                )
                continue
            return e

    def _primary(self):
        t = self.next()
        if t.kind == "number":
            if "." in t.value:
                return ast.Literal(float(t.value), "float")
            return ast.Literal(int(t.value), "int")
        if t.kind == "string":
            return ast.Literal(t.value[1:-1].replace("''", "'"), "string")
        if t.kind == "op" and t.value == "(":
            nxt = self.peek()
            if nxt and nxt.kind == "word" and nxt.value == "select":
                sub = self._select()
                self.expect_op(")")
                return ast.ScalarSubquery(sub)
            e = self._expr()
            self.expect_op(")")
            return e
        if t.kind != "word":
            raise ParseError(f"unexpected token {t.value!r}")
        w = t.value
        if w == "interval":
            s = self.next()
            if s.kind != "string":
                raise ParseError("expected INTERVAL 'value'")
            return self._interval(s.value[1:-1])
        if w in ("date", "timestamp") and self.peek() \
                and self.peek().kind == "string":
            # typed literal: DATE '1994-01-01' / TIMESTAMP '… …'
            raw = self.next().value[1:-1]
            return self._datetime_literal(w, raw)
        if w == "exists" and self.peek() \
                and self.peek().value == "(":
            self.expect_op("(")
            sub = self._select()
            self.expect_op(")")
            return ast.ExistsSubquery(sub)
        if w == "substring" and self.accept_op("("):
            # substring(s FROM a [FOR n]) — also accept the plain
            # comma form through the generic call path below is NOT
            # possible once '(' is consumed, so handle both here
            e = self._expr()
            if self.accept_word("from"):
                start = self._expr()
                count = None
                if self.accept_word("for"):
                    count = self._expr()
                self.expect_op(")")
                args = (e, start) if count is None else (e, start, count)
                return ast.FuncCall("substr", args)
            args = [e]
            while self.accept_op(","):
                args.append(self._expr())
            self.expect_op(")")
            return ast.FuncCall("substr", tuple(args))
        if w in ("true", "false"):
            return ast.Literal(w == "true", "bool")
        if w == "null":
            return ast.Literal(None, "null")
        if w == "case":
            conds = []
            while self.accept_word("when"):
                c = self._expr()
                self.expect_word("then")
                r = self._expr()
                conds.append((c, r))
            els = None
            if self.accept_word("else"):
                els = self._expr()
            self.expect_word("end")
            return ast.Case(tuple(conds), els)
        if w == "extract":
            self.expect_op("(")
            part = self.ident()
            self.expect_word("from")
            e = self._expr()
            self.expect_op(")")
            return ast.FuncCall(f"extract_{part}", (e,))
        if w == "cast":
            self.expect_op("(")
            e = self._expr()
            self.expect_word("as")
            tn = self._type_name()
            self.expect_op(")")
            return ast.Cast(e, tn)
        if self.accept_op("("):
            distinct = bool(self.accept_word("distinct"))
            args: list = []
            if self.accept_op("*"):
                args.append(ast.Star())
            elif not (self.peek() and self.peek().value == ")"):
                while True:
                    args.append(self._expr())
                    if not self.accept_op(","):
                        break
            self.expect_op(")")
            if self.accept_word("over"):
                if distinct:
                    raise ParseError(
                        "DISTINCT in window functions is not supported"
                    )
                self.expect_op("(")
                part: list = []
                if self.accept_word("partition"):
                    self.expect_word("by")
                    while True:
                        part.append(self._expr())
                        if not self.accept_op(","):
                            break
                ob: list = []
                if self.accept_word("order"):
                    self.expect_word("by")
                    while True:
                        e = self._expr()
                        desc = bool(self.accept_word("desc"))
                        if not desc:
                            self.accept_word("asc")
                        ob.append(ast.OrderItem(e, desc))
                        if not self.accept_op(","):
                            break
                frame = self._window_frame()
                self.expect_op(")")
                return ast.WindowCall(w, tuple(args), tuple(part),
                                      tuple(ob), frame=frame)
            fc = ast.FuncCall(w, tuple(args), distinct)
            if self.accept_word("filter"):
                self.expect_op("(")
                self.expect_word("where")
                cond = self._expr()
                self.expect_op(")")
                fc = ast.FuncCall(w, tuple(args), distinct,
                                  filter_where=cond)
            return fc
        if self.accept_op("."):
            if self.accept_op("*"):
                return ast.Star(table=w)
            return ast.ColumnRef(self.ident(), table=w)
        return ast.ColumnRef(w)

    def _window_frame(self):
        """ROWS BETWEEN <n> PRECEDING AND CURRENT ROW (the benchmark
        frame shape); returns (preceding, following) or None."""
        if not self.accept_word("rows"):
            return None

        def bound(start: bool) -> int:
            if self.accept_word("current"):
                self.expect_word("row")
                return 0
            if self.accept_word("unbounded"):
                self.expect_word("preceding" if start else "following")
                return -1  # unbounded sentinel
            t = self.next()
            if t.kind != "number":
                raise ParseError(f"expected frame bound, got {t.value!r}")
            n = int(t.value)
            self.expect_word("preceding" if start else "following")
            return n

        self.expect_word("between")
        pre = bound(True)
        self.expect_word("and")
        fol = bound(False)
        return (pre, fol)

    def _datetime_literal(self, kind: str, raw: str):
        """DATE 'Y-m-d' → days since epoch; TIMESTAMP → microseconds."""
        import datetime as _dt
        try:
            if kind == "date":
                d = _dt.date.fromisoformat(raw.strip())
                return ast.Literal(
                    (d - _dt.date(1970, 1, 1)).days, "date"
                )
            ts = _dt.datetime.fromisoformat(raw.strip())
            epoch = _dt.datetime(1970, 1, 1)
            # exact integer microseconds (float total_seconds() rounds)
            return ast.Literal(
                (ts - epoch) // _dt.timedelta(microseconds=1),
                "timestamp",
            )
        except ValueError as e:
            raise ParseError(f"bad {kind} literal {raw!r}: {e}")

    def _interval(self, text: str) -> ast.IntervalLit:
        m = re.match(r"^\s*(\d+)\s*([a-zA-Z]+)?\s*$", text)
        if not m:
            raise ParseError(f"bad interval {text!r}")
        n = int(m.group(1))
        unit = (m.group(2) or "second").lower()
        # also accept the unit as the next word: INTERVAL '10' SECOND
        if m.group(2) is None and self.peek() and self.peek().kind == "word" \
                and self.peek().value in (_INTERVAL_UNITS.keys()
                                          | _INTERVAL_MONTH_UNITS.keys()):
            unit = self.next().value
        if unit in _INTERVAL_MONTH_UNITS:
            return ast.IntervalLit(0, months=n * _INTERVAL_MONTH_UNITS[unit])
        if unit not in _INTERVAL_UNITS:
            raise ParseError(f"unsupported interval unit {unit!r}")
        return ast.IntervalLit(n * _INTERVAL_UNITS[unit])


def _realias(select: ast.Select, cols: list[str]) -> ast.Select:
    """Apply a column alias list to a SELECT's output items."""
    import dataclasses
    items = select.items
    if len(cols) != len(items) or any(
            isinstance(i.expr, ast.Star) for i in items):
        raise ParseError(
            f"column alias list has {len(cols)} names for "
            f"{len(items)} output columns"
        )
    return dataclasses.replace(select, items=tuple(
        ast.SelectItem(i.expr, c) for i, c in zip(items, cols)
    ))


def _substitute_ctes(node, ctes: dict):
    """Deep-rewrite TableRefs naming a CTE into derived tables.

    Covers FROM trees and subqueries inside expressions (IN / EXISTS /
    scalar subqueries) — e.g. TPC-H q15 uses its CTE both in FROM and
    in a scalar subquery."""
    import dataclasses

    def walk(x):
        if isinstance(x, ast.TableRef) and x.name in ctes:
            return ast.SubqueryRef(ctes[x.name], x.alias or x.name)
        if isinstance(x, (ast.Tumble, ast.Hop)):
            return dataclasses.replace(x, table=walk(x.table))
        if isinstance(x, ast.Join):
            return dataclasses.replace(
                x, left=walk(x.left), right=walk(x.right),
                on=walk(x.on) if x.on is not None else None,
            )
        if isinstance(x, ast.Select):
            return dataclasses.replace(
                x,
                items=tuple(
                    ast.SelectItem(walk(i.expr), i.alias)
                    if not isinstance(i.expr, ast.Star) else i
                    for i in x.items
                ),
                from_=walk(x.from_) if x.from_ is not None else None,
                where=walk(x.where) if x.where is not None else None,
                group_by=tuple(walk(g) for g in x.group_by),
                having=walk(x.having) if x.having is not None else None,
                order_by=tuple(
                    ast.OrderItem(walk(o.expr), o.descending)
                    for o in x.order_by
                ),
            )
        if isinstance(x, ast.ScalarSubquery):
            return ast.ScalarSubquery(walk(x.select))
        if isinstance(x, ast.ExistsSubquery):
            return ast.ExistsSubquery(walk(x.select))
        if isinstance(x, ast.InSubquery):
            return ast.InSubquery(walk(x.expr), walk(x.select),
                                  x.negated)
        if isinstance(x, ast.BinaryOp):
            return ast.BinaryOp(x.op, walk(x.left), walk(x.right))
        if isinstance(x, ast.UnaryOp):
            return ast.UnaryOp(x.op, walk(x.operand))
        if isinstance(x, ast.Case):
            return ast.Case(
                tuple((walk(c), walk(r)) for c, r in x.conditions),
                walk(x.else_result) if x.else_result is not None
                else None,
            )
        if isinstance(x, ast.FuncCall):
            return dataclasses.replace(x, args=tuple(
                a if isinstance(a, ast.Star) else walk(a)
                for a in x.args
            ), filter_where=(walk(x.filter_where)
                             if x.filter_where is not None else None))
        if isinstance(x, ast.Cast):
            return dataclasses.replace(x, operand=walk(x.operand))
        return x

    return walk(node)


def parse(sql: str):
    """Parse one or more ;-separated statements."""
    return [stmt for _, stmt in parse_with_text(sql)]


def parse_with_text(sql: str):
    """Parse statements keeping each one's raw SQL text (the durable
    DDL log records the text, not the AST)."""
    out = []
    for part in _split_statements(sql):
        p = Parser(part)
        stmt = p.parse_statement()
        if p.peek() is not None:
            raise ParseError(f"trailing tokens at {p.peek()}")
        out.append((part, stmt))
    return out


def _split_statements(sql: str) -> list[str]:
    # split on ; outside string literals and -- comments
    out: list[str] = []
    cur: list[str] = []
    i, n = 0, len(sql)
    in_str = in_comment = False
    while i < n:
        ch = sql[i]
        if in_comment:
            if ch == "\n":
                in_comment = False
            cur.append(ch)
        elif in_str:
            if ch == "'":
                in_str = False
            cur.append(ch)
        elif ch == "'":
            in_str = True
            cur.append(ch)
        elif ch == "-" and i + 1 < n and sql[i + 1] == "-":
            in_comment = True
            cur.append(ch)
        elif ch == ";":
            stmt = "".join(cur).strip()
            if stmt:
                out.append(stmt)
            cur = []
        else:
            cur.append(ch)
        i += 1
    stmt = "".join(cur).strip()
    if stmt:
        out.append(stmt)
    return out
