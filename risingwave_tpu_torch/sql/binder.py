"""Binder: SQL AST expressions -> typed engine expressions.

Port of ``risingwave_tpu/sql/binder.py``: name resolution against the
in-scope schema, literal typing, DATE/TIMESTAMP literal +- INTERVAL
folding, CASE, LIKE over ``%`` patterns (``_bind_like``), ``to_char``
with a literal format, the ``(regexp_match(s, 'pat'))[2]`` capture,
aggregate-call extraction.

Every function call the binder builds (operators, CAST, ``||``, CASE,
LIKE's rewrites) is resolved against the registry as it is bound, by
name and argument types: a call with no overload raises ``BindError``
at CREATE, where the reference's would fail only when it first runs.
"""

from __future__ import annotations

import datetime as _dt
from dataclasses import dataclass

from risingwave_tpu_torch.common.types import DataType, Schema
from risingwave_tpu_torch.expr import agg as agg_mod
from risingwave_tpu_torch.expr.node import (
    Expr,
    FuncCall as EFuncCall,
    InputRef,
    Literal as ELiteral,
    as_expr,
)
from risingwave_tpu_torch.expr.scalar import LikePattern, RegexpGroup, ToChar
from risingwave_tpu_torch.sql import ast

AGG_NAMES = {"count", "sum", "avg", "min", "max"}


class BindError(ValueError):
    pass


@dataclass
class Scope:
    """Visible columns: (qualifier, name) -> input position."""

    schema: Schema
    qualifiers: tuple  # per-column table qualifier (or None)

    @staticmethod
    def of(schema: Schema, qualifier: str | None = None) -> "Scope":
        return Scope(schema, tuple(qualifier for _ in schema))

    def resolve(self, name: str, table: str | None) -> int:
        hits = [i for i, (f, q) in enumerate(zip(self.schema, self.qualifiers))
                if f.name == name and (table is None or q == table)]
        if not hits:
            raise BindError(f"column {table + '.' if table else ''}{name} "
                            "not found")
        if len(hits) > 1:
            raise BindError(f"column {name} is ambiguous")
        return hits[0]


class Binder:
    """Binds scalar expressions; collects aggregate calls when allowed."""

    def __init__(self, scope: Scope, allow_aggs: bool = False):
        self.scope = scope
        self.allow_aggs = allow_aggs
        self.agg_calls: list[agg_mod.AggCall] = []

    def bind(self, e) -> Expr:
        if isinstance(e, ast.ColumnRef):
            return InputRef(self.scope.resolve(e.name, e.table))
        if isinstance(e, ast.Literal):
            return self._bind_literal(e)
        if isinstance(e, ast.IntervalLit):
            if e.months:
                raise BindError("month/year intervals are supported only in "
                                "date/timestamp literal arithmetic")
            return ELiteral(e.micros, DataType.INTERVAL)
        if isinstance(e, ast.UnaryOp):
            return self._call(e.op, (self.bind(e.operand),))
        if isinstance(e, ast.BinaryOp):
            folded = self._fold_datetime_arith(e)
            if folded is not None:
                return folded
            return self._call(e.op, (self.bind(e.left), self.bind(e.right)))
        if isinstance(e, ast.Cast):
            t = DataType.from_sql(e.type_name)
            return self._call(f"cast_{t.name.lower()}",
                              (self.bind(e.operand),))
        if isinstance(e, ast.Case):
            if e.else_result is None:
                # CASE without ELSE yields NULL, typed as the first THEN
                then0 = self.bind(e.conditions[0][1])
                t = then0.return_field(self.scope.schema).data_type
                out: Expr = ELiteral(None, t)
            else:
                out = self.bind(e.else_result)
            for c, r in reversed(e.conditions):
                out = self._call("case", (self.bind(c), self.bind(r), out))
            return out
        if isinstance(e, ast.FuncCall):
            if e.name in AGG_NAMES:
                return self._bind_agg(e)
            if e.filter_where is not None:
                raise BindError(f"FILTER specified, but {e.name} is not an "
                                "aggregate function")
            if e.name == "like":
                return self._bind_like(e)
            if e.name == "to_char":
                return self._bind_to_char(e)
            if e.name == "array_index":
                return self._bind_array_index(e)
            if e.name == "regexp_match":
                raise BindError("regexp_match is supported only as "
                                "(regexp_match(s, 'pat'))[n]")
            if e.name == "split_part" and len(e.args) == 3 \
                    and isinstance(e.args[2], ast.Literal) \
                    and e.args[2].type_name == "int" \
                    and e.args[2].value == 0:
                # ref split_part.rs: position 0 is an error, and the
                # kernel cannot raise per row
                raise BindError("field position must not be zero")
            args = tuple(self.bind(a) for a in e.args)
            # untyped NULL literals adopt the type of a typed sibling
            typed = [a for a in args
                     if not (isinstance(a, ELiteral) and a.value is None)]
            if typed and len(typed) != len(args):
                t = typed[0].return_field(self.scope.schema).data_type
                args = tuple(ELiteral(None, t) if isinstance(a, ELiteral)
                             and a.value is None else a for a in args)
            return self._call(e.name, args)
        raise BindError(f"cannot bind {e!r} (not ported yet)")

    def _call(self, name: str, args: tuple) -> Expr:
        """A function call resolved against the registry now, by name and
        argument types: no such function or overload raises BindError."""
        call = EFuncCall(name, args)
        try:
            call.return_field(self.scope.schema)
        except KeyError as err:
            raise BindError(err.args[0]) from None
        return call

    @staticmethod
    def _bind_literal(e: ast.Literal) -> Expr:
        if e.type_name == "string":
            return ELiteral(e.value, DataType.VARCHAR)
        if e.type_name == "bool":
            return ELiteral(e.value, DataType.BOOLEAN)
        if e.type_name == "float":
            # PG: a decimal-point literal is NUMERIC when the scaled
            # int64 representation holds it exactly
            v = e.value
            if abs(v) < 9e12 and round(v * 10**6) / 10**6 == v:
                return ELiteral(v, DataType.DECIMAL)
            return ELiteral(v, DataType.FLOAT64)
        if e.type_name == "int":
            return as_expr(e.value)
        if e.type_name == "date":
            return ELiteral(e.value, DataType.DATE)
        if e.type_name == "timestamp":
            return ELiteral(e.value, DataType.TIMESTAMP)
        if e.type_name == "null":
            return ELiteral(None, DataType.INT64)
        raise BindError(f"unsupported literal {e}")

    def _fold_datetime_arith(self, e: ast.BinaryOp):
        """Constant-fold ``DATE/TIMESTAMP literal +- INTERVAL``."""
        if e.op not in ("add", "subtract"):
            return None
        lit, iv = e.left, e.right
        if not (isinstance(lit, ast.Literal)
                and lit.type_name in ("date", "timestamp")
                and isinstance(iv, ast.IntervalLit)):
            return None
        sign = 1 if e.op == "add" else -1
        epoch = _dt.datetime(1970, 1, 1)
        if lit.type_name == "date":
            base = epoch + _dt.timedelta(days=lit.value)
        else:
            base = epoch + _dt.timedelta(microseconds=lit.value)
        if iv.months:
            total = base.year * 12 + (base.month - 1) + sign * iv.months
            y, m = divmod(total, 12)
            for day in (base.day, 30, 29, 28):
                try:
                    base = base.replace(year=y, month=m + 1, day=day)
                    break
                except ValueError:
                    continue
        base = base + _dt.timedelta(microseconds=sign * iv.micros)
        if lit.type_name == "date" and base.time() == _dt.time(0, 0):
            return ELiteral((base.date() - _dt.date(1970, 1, 1)).days,
                            DataType.DATE)
        return ELiteral((base - epoch) // _dt.timedelta(microseconds=1),
                        DataType.TIMESTAMP)

    def _bind_like(self, e: ast.FuncCall) -> Expr:
        """LIKE with a literal ``%``-only pattern: one segment binds to
        ``starts_with`` ('x%'), ``ends_with`` ('%x'), ``contains``
        ('%x%') or ``equal`` ('x'); an interior ``%`` to ``LikePattern``
        (K23f runs both).  ``_`` wildcards are refused."""
        target, pat = e.args
        if not (isinstance(pat, ast.Literal) and pat.type_name == "string"):
            raise BindError("LIKE requires a string literal pattern")
        p = pat.value
        if "_" in p:
            raise BindError("LIKE '_' wildcards not yet supported")
        lhs = self.bind(target)
        body = p.strip("%")
        if "%" in body:
            return LikePattern(lhs, p)
        lit_body = ELiteral(body, DataType.VARCHAR)
        if p.startswith("%") and p.endswith("%"):
            return self._call("contains", (lhs, lit_body))
        if p.endswith("%"):
            return self._call("starts_with", (lhs, lit_body))
        if p.startswith("%"):
            return self._call("ends_with", (lhs, lit_body))
        return self._call("equal", (lhs, lit_body))

    def _bind_to_char(self, e: ast.FuncCall) -> Expr:
        """to_char(ts, 'fmt'): the format compiles at bind time (K23b
        takes the compiled program)."""
        if len(e.args) != 2:
            raise BindError("to_char takes (timestamp, format)")
        fmt = e.args[1]
        if not (isinstance(fmt, ast.Literal) and fmt.type_name == "string"):
            raise BindError("to_char requires a literal format string")
        arg = self.bind(e.args[0])
        t = arg.return_field(self.scope.schema).data_type
        if t == DataType.DATE:
            # DATE is int32 days; the formatter takes int64 microseconds
            arg = self._call("cast_timestamp", (arg,))
        elif t not in (DataType.TIMESTAMP, DataType.TIMESTAMPTZ):
            raise BindError(f"to_char over {t.name} not supported")
        return ToChar(arg, fmt.value)

    def _bind_array_index(self, e: ast.FuncCall) -> Expr:
        """Array subscripts exist only for regexp_match captures:
        ``(regexp_match(s, 'pat'))[n]`` (K23c)."""
        target, idx = e.args
        if not (isinstance(target, ast.FuncCall)
                and target.name == "regexp_match"):
            raise BindError("array subscripts are supported on "
                            "regexp_match only")
        if len(target.args) != 2:
            raise BindError("regexp_match takes (string, pattern)")
        pat = target.args[1]
        if not (isinstance(pat, ast.Literal) and pat.type_name == "string"):
            raise BindError("regexp_match requires a literal pattern")
        arg = self.bind(target.args[0])
        try:
            return RegexpGroup(arg, pat.value, idx.value)
        except ValueError as err:
            raise BindError(str(err))

    def _bind_agg(self, e: ast.FuncCall) -> Expr:
        if not self.allow_aggs:
            raise BindError(f"aggregate {e.name} not allowed here")
        filt = None
        if e.filter_where is not None:
            filt = Binder(self.scope).bind(e.filter_where)
        if e.name == "count" and (not e.args
                                  or isinstance(e.args[0], ast.Star)):
            if e.distinct:
                raise BindError("COUNT(DISTINCT *) is not valid")
            call = agg_mod.AggCall("count_star", None, filter=filt)
        else:
            call = agg_mod.AggCall(e.name, self.bind(e.args[0]),
                                   distinct=e.distinct, filter=filt)
        self.agg_calls.append(call)
        return AggRef(len(self.agg_calls) - 1, call)


@dataclass(frozen=True, eq=False)
class AggRef(Expr):
    """The i-th aggregate output (planner placeholder)."""

    index: int
    call: agg_mod.AggCall

    def return_field(self, schema):
        return self.call.out_field(schema)

    def eval(self, chunk):  # pragma: no cover - replaced by the planner
        raise RuntimeError("AggRef must be rewritten by the planner")
