"""Scalar function registry with signature dispatch.

Port of ``risingwave_tpu/expr/registry.py`` (host-side dispatch only;
the implementations registered here take and return torch columns).

Reference counterpart: ``FUNCTION_REGISTRY`` (src/expr/core/src/sig/mod.rs:39)
populated by the ``#[function("add(int,int)->int")]`` proc-macro
(src/expr/macro/src/lib.rs).  Here the same idea is a decorator::

    @function("add(int64, int64) -> int64")
    def add_i64(a, b): return a + b

Signatures use SQL type names plus the families ``intlike`` (int16/32/64,
serial), ``floatlike`` (float32/64), ``numeric`` (ints+floats+decimal),
``timelike`` (date/time/timestamp/timestamptz/interval), ``any``.
Resolution prefers exact matches over family matches and, like the
reference's casting rules, auto-promotes mixed numeric widths.
"""

from __future__ import annotations

import inspect
import re
from dataclasses import dataclass
from typing import Callable, Sequence

from risingwave_tpu_torch.common.types import (
    DEFAULT_STR_WIDTH,
    DataType,
    Field,
)

_FAMILIES: dict[str, tuple[DataType, ...]] = {
    "intlike": (DataType.INT16, DataType.INT32, DataType.INT64, DataType.SERIAL),
    "floatlike": (DataType.FLOAT32, DataType.FLOAT64),
    "numeric": (
        DataType.INT16,
        DataType.INT32,
        DataType.INT64,
        DataType.SERIAL,
        DataType.FLOAT32,
        DataType.FLOAT64,
        DataType.DECIMAL,
    ),
    "timelike": (
        DataType.DATE,
        DataType.TIME,
        DataType.TIMESTAMP,
        DataType.TIMESTAMPTZ,
        DataType.INTERVAL,
    ),
    "stringlike": (DataType.VARCHAR, DataType.BYTEA),
    "any": tuple(DataType),
}

#: pseudo return types computed from the argument types
_AUTO_RETURNS = ("auto", "same")


def _parse_type(tok: str) -> tuple[str, tuple[DataType, ...]]:
    tok = tok.strip().lower()
    if tok in _FAMILIES:
        return tok, _FAMILIES[tok]
    t = DataType.from_sql(tok) if tok not in ("auto", "same", "boolean") else None
    if tok == "boolean":
        t = DataType.BOOLEAN
    if t is None:
        raise ValueError(f"unknown type {tok!r}")
    return tok, (t,)


_NUMERIC_ORDER = [
    DataType.INT16,
    DataType.INT32,
    DataType.INT64,
    DataType.SERIAL,
    DataType.DECIMAL,
    DataType.FLOAT32,
    DataType.FLOAT64,
]


def promote_numeric(types: Sequence[DataType]) -> DataType:
    """SQL-ish numeric promotion: widest wins; decimal beats ints,
    floats beat decimal (matching the reference's cast lattice)."""
    best = -1
    for t in types:
        if t not in _NUMERIC_ORDER:
            return types[0]
        best = max(best, _NUMERIC_ORDER.index(t))
    return _NUMERIC_ORDER[best]


@dataclass(frozen=True)
class FuncSig:
    name: str
    arg_matchers: tuple[tuple[str, tuple[DataType, ...]], ...]
    ret: str  # sql type name or "auto"/"same"/"same_branch"
    impl: Callable
    #: impl declares a trailing ``fields`` kwarg for logical-type context
    takes_fields: bool = False
    #: impl handles NULL masks itself (receives NCol args as-is):
    #: Kleene AND/OR, IS NULL, COALESCE, CASE
    null_aware: bool = False
    #: result can never be NULL regardless of inputs (IS NULL, count)
    never_null: bool = False

    def call(self, cols: Sequence, arg_fields: Sequence[Field]):
        """Evaluate with SQL null semantics.

        Strict functions (the default, matching the reference's
        #[function] strictness) see only payloads; the result's null
        mask is the OR of the argument masks — one fused ``where``-free
        mask op, so non-nullable plans pay nothing."""
        from risingwave_tpu_torch.common.chunk import make_col, split_col

        if self.null_aware:
            if self.takes_fields:
                return self.impl(*cols, fields=list(arg_fields))
            return self.impl(*cols)
        datas = []
        null = None
        for c in cols:
            d, n = split_col(c)
            datas.append(d)
            if n is not None:
                null = n if null is None else (null | n)
        if self.takes_fields:
            out = self.impl(*datas, fields=list(arg_fields))
        else:
            out = self.impl(*datas)
        if self.never_null:
            return out
        return make_col(out, null)

    def matches(self, arg_fields: Sequence[Field]) -> int:
        """Score the match: -1 no match; higher = more specific."""
        if len(arg_fields) != len(self.arg_matchers):
            return -1
        score = 0
        for f, (tok, accepted) in zip(arg_fields, self.arg_matchers):
            if f.data_type not in accepted:
                return -1
            score += 2 if len(accepted) == 1 else (1 if tok != "any" else 0)
        return score

    def return_field(self, arg_fields: Sequence[Field]) -> Field:
        base = self._base_return_field(arg_fields)
        if self.never_null:
            return base.with_nullable(False) if base.nullable else base
        if any(f.nullable for f in arg_fields) and not base.nullable:
            return base.with_nullable()
        return base

    def _base_return_field(self, arg_fields: Sequence[Field]) -> Field:
        if self.ret == "same":
            return Field("?expr", arg_fields[0].data_type,
                         str_width=arg_fields[0].str_width,
                         decimal_scale=arg_fields[0].decimal_scale)
        if self.ret == "same_branch":  # CASE: type of the THEN/ELSE branches
            b = arg_fields[1:]
            if all(f.data_type == b[0].data_type for f in b):
                return Field("?expr", b[0].data_type,
                             str_width=max(f.str_width for f in b),
                             decimal_scale=b[0].decimal_scale)
            return Field("?expr", promote_numeric([f.data_type for f in b]))
        if self.ret == "auto":
            return Field("?expr", promote_numeric([f.data_type for f in arg_fields]))
        _, accepted = _parse_type(self.ret)
        t = accepted[0]
        if t in (DataType.VARCHAR, DataType.BYTEA):
            # device width of a produced string: concat sums its inputs;
            # everything else is bounded by the widest string argument
            str_widths = [f.str_width for f in arg_fields
                          if f.data_type in (DataType.VARCHAR,
                                             DataType.BYTEA)]
            if self.name == "concat":
                width = sum(str_widths)
            else:
                width = max(str_widths, default=DEFAULT_STR_WIDTH)
            return Field("?expr", t, str_width=width)
        return Field("?expr", t)


_SIG_RE = re.compile(r"^\s*(\w+)\s*\(([^)]*)\)\s*->\s*([\w ]+)\s*$")


class _Registry:
    def __init__(self):
        self._by_name: dict[str, list[FuncSig]] = {}

    def register(self, spec: str, impl: Callable,
                 null_aware: bool = False,
                 never_null: bool = False) -> FuncSig:
        m = _SIG_RE.match(spec)
        if not m:
            raise ValueError(f"bad signature {spec!r}")
        name, args, ret = m.group(1), m.group(2), m.group(3)
        matchers = tuple(
            _parse_type(tok) for tok in args.split(",") if tok.strip()
        )
        takes_fields = "fields" in inspect.signature(impl).parameters
        sig = FuncSig(name, matchers, ret.strip().lower(), impl,
                      takes_fields, null_aware, never_null)
        self._by_name.setdefault(name, []).append(sig)
        return sig

    def resolve(self, name: str, arg_fields: Sequence[Field]) -> FuncSig:
        cands = self._by_name.get(name)
        if not cands:
            raise KeyError(f"no function named {name!r}")
        best: FuncSig | None = None
        best_score = -1
        for sig in cands:
            s = sig.matches(arg_fields)
            if s > best_score:
                best, best_score = sig, s
        if best is None or best_score < 0:
            types = [f.data_type.name for f in arg_fields]
            raise KeyError(f"no overload {name}({', '.join(types)})")
        return best

    def names(self) -> list[str]:
        return sorted(self._by_name)

    def __len__(self) -> int:
        return sum(len(v) for v in self._by_name.values())


FUNCTION_REGISTRY = _Registry()


def function(spec: str, null_aware: bool = False, never_null: bool = False):
    """Decorator mirroring the reference's ``#[function(...)]`` macro.

    ``null_aware`` impls receive NCol arguments and own their null
    semantics; ``never_null`` marks results that cannot be NULL."""

    def deco(fn: Callable) -> Callable:
        FUNCTION_REGISTRY.register(spec, fn, null_aware, never_null)
        return fn

    return deco
