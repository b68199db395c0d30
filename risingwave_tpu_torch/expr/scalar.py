"""Scalar functions: the part of the reference's ``expr/scalar.py`` that
the ported plans reach.

Port of ``risingwave_tpu/expr/scalar.py``: integer/timestamp
arithmetic, comparisons (strings too), boolean logic, IS [NOT] NULL,
COALESCE and CASE, ``tumble_start`` (:423), NUMERIC multiply (:137),
integer/decimal coercion, and the string and calendar functions of
Nexmark q10, q21 and q22: ``lower``/``upper``, ``split_part``,
``to_char`` (``ToChar``) and the ``regexp_match`` capture
(``RegexpGroup``).  Every implementation takes and returns whole torch
columns; the string and calendar arithmetic runs in the K23 kernels
(``expr/strings.py``).  NUMERIC divide and the other string functions
(``replace``, LIKE, ``substr``, ``trim``, ``concat``, ``extract``) are
not ported yet: they are not registered, and the binder refuses them.

torch's ``%`` and ``//`` on integer tensors floor like ``jnp``'s, so
``ts - ts % size`` gives the same window start for negative times.
"""

from __future__ import annotations

import re
from typing import Sequence

import torch

from risingwave_tpu_torch.common.chunk import NCol, StrCol, make_col, split_col
from risingwave_tpu_torch.common.types import (
    DEFAULT_DECIMAL_SCALE,
    DataType,
    Field,
)
from risingwave_tpu_torch.expr.node import Expr
from risingwave_tpu_torch.expr.registry import function, promote_numeric
from risingwave_tpu_torch.expr.strings import (
    pad_bytes,
    regexp_group,
    str_case_map,
    str_cmp,
    str_split_part,
    to_char,
)

_SCALE = 10**DEFAULT_DECIMAL_SCALE


def coerce(col, field: Field, target: DataType):
    """Cast a column from its logical type to ``target`` (integral
    widening, integer -> DECIMAL and the DECIMAL rescale to the engine
    scale; other casts are not ported yet)."""
    t = field.data_type
    if t == target and not (
        t == DataType.DECIMAL and field.decimal_scale != DEFAULT_DECIMAL_SCALE
    ):
        return col
    if t == DataType.DECIMAL and target == DataType.DECIMAL:
        # a non-default-scale column rescales to the engine scale, which
        # the arithmetic below assumes (floor division when narrowing)
        diff = DEFAULT_DECIMAL_SCALE - field.decimal_scale
        if diff > 0:
            return col * (10**diff)
        return col // (10 ** (-diff))
    if t.is_integral and t != DataType.DECIMAL:
        if target == DataType.DECIMAL:
            return col.to(torch.int64) * _SCALE
        if target.is_integral:
            return col.to(target.physical_dtype)
        if target in (DataType.FLOAT32, DataType.FLOAT64):
            return col.to(target.physical_dtype)
    raise NotImplementedError(f"cast {t.name} -> {target.name} is not "
                              "ported yet")


def _promote_args(cols, fields: Sequence[Field]):
    target = promote_numeric([f.data_type for f in fields])
    return [coerce(c, f, target) for c, f in zip(cols, fields)], target


@function("add(numeric, numeric) -> auto")
def _add(a, b, fields: Sequence[Field]):
    (a, b), _ = _promote_args((a, b), fields)
    return a + b


@function("subtract(numeric, numeric) -> auto")
def _sub(a, b, fields: Sequence[Field]):
    (a, b), _ = _promote_args((a, b), fields)
    return a - b


@function("subtract(timelike, timelike) -> interval")
def _sub_time(a, b):
    return (a - b).to(torch.int64)


@function("add(timestamp, interval) -> timestamp")
@function("add(timestamptz, interval) -> timestamptz")
def _add_ts_iv(a, b):
    return a + b


@function("subtract(timestamp, interval) -> timestamp")
@function("subtract(timestamptz, interval) -> timestamptz")
def _sub_ts_iv(a, b):
    return a - b


@function("multiply(numeric, numeric) -> auto")
def _mul(a, b, fields: Sequence[Field]):
    (a, b), t = _promote_args((a, b), fields)
    if t == DataType.DECIMAL:
        # via float64, in the reference's order: (a * b) / scale, then
        # round half to even (int64 products of scaled operands overflow)
        prod = a.to(torch.float64) * b.to(torch.float64) / _SCALE
        return torch.round(prod).to(torch.int64)
    return a * b


@function("divide(numeric, numeric) -> auto")
def _div(a, b, fields: Sequence[Field]):
    (a, b), t = _promote_args((a, b), fields)
    if t == DataType.DECIMAL or a.dtype.is_floating_point:
        raise NotImplementedError("NUMERIC/float divide is not ported yet")
    safe = torch.where(b == 0, torch.ones_like(b), b)
    return torch.where(b != 0, a // safe, torch.zeros_like(a))


@function("modulus(numeric, numeric) -> auto")
def _mod(a, b, fields: Sequence[Field]):
    (a, b), _ = _promote_args((a, b), fields)
    safe = torch.where(b == 0, torch.ones_like(b), b)
    return torch.where(b != 0, a % safe, torch.zeros_like(a))


@function("neg(numeric) -> same")
def _neg(a):
    return -a


def _make_cmp(name: str, op, str_op: str):
    @function(f"{name}(numeric, numeric) -> boolean")
    def _cmp(a, b, fields: Sequence[Field]):
        (a, b), _ = _promote_args((a, b), fields)
        return op(a, b)

    @function(f"{name}(timelike, timelike) -> boolean")
    @function(f"{name}(boolean, boolean) -> boolean")
    def _cmp_t(a, b):
        return op(a, b)

    @function(f"{name}(stringlike, stringlike) -> boolean")
    def _cmp_s(a: StrCol, b: StrCol):
        return str_cmp(a, b, str_op)

    return _cmp


_make_cmp("equal", lambda a, b: a == b, "eq")
_make_cmp("not_equal", lambda a, b: a != b, "ne")
_make_cmp("less_than", lambda a, b: a < b, "lt")
_make_cmp("less_than_or_equal", lambda a, b: a <= b, "le")
_make_cmp("greater_than", lambda a, b: a > b, "gt")
_make_cmp("greater_than_or_equal", lambda a, b: a >= b, "ge")


def _known(d, n, value: bool):
    """Rows where a nullable boolean is known to equal ``value``."""
    hit = d if value else ~d
    return hit if n is None else hit & ~n


@function("and(boolean, boolean) -> boolean", null_aware=True)
def _and(a, b):
    """Kleene AND: FALSE dominates NULL."""
    ad, an = split_col(a)
    bd, bn = split_col(b)
    if an is None and bn is None:
        return ad & bd
    some_null = (an if an is not None else torch.zeros_like(ad)) | (
        bn if bn is not None else torch.zeros_like(bd))
    null = some_null & ~_known(ad, an, False) & ~_known(bd, bn, False)
    return NCol(ad & bd & ~null, null)


@function("or(boolean, boolean) -> boolean", null_aware=True)
def _or(a, b):
    """Kleene OR: TRUE dominates NULL."""
    ad, an = split_col(a)
    bd, bn = split_col(b)
    if an is None and bn is None:
        return ad | bd
    a_true, b_true = _known(ad, an, True), _known(bd, bn, True)
    some_null = (an if an is not None else torch.zeros_like(ad)) | (
        bn if bn is not None else torch.zeros_like(bd))
    null = some_null & ~a_true & ~b_true
    return NCol((a_true | b_true) & ~null, null)


@function("not(boolean) -> boolean")
def _not(a):
    return ~a


def _row_tensor(d) -> torch.Tensor:
    """A [cap] tensor of a column payload (a string's lengths)."""
    return d.lens if isinstance(d, StrCol) else d


@function("is_null(any) -> boolean", null_aware=True, never_null=True)
def _is_null(a):
    d, n = split_col(a)
    if n is None:
        return torch.zeros_like(_row_tensor(d), dtype=torch.bool)
    return n


@function("is_not_null(any) -> boolean", null_aware=True, never_null=True)
def _is_not_null(a):
    d, n = split_col(a)
    if n is None:
        return torch.ones_like(_row_tensor(d), dtype=torch.bool)
    return ~n


def _pick(take_a: torch.Tensor, a, b):
    """Per row ``a`` where ``take_a`` else ``b``; strings at the wider
    of the two widths (the narrower zero-padded)."""
    if isinstance(a, StrCol):
        w = max(a.data.shape[1], b.data.shape[1])
        return StrCol(torch.where(take_a[:, None], pad_bytes(a.data, w),
                                  pad_bytes(b.data, w)),
                      torch.where(take_a, a.lens, b.lens))
    return torch.where(take_a, a, b)


@function("coalesce(any, any) -> same", null_aware=True)
def _coalesce(a, b):
    ad, an = split_col(a)
    bd, bn = split_col(b)
    if an is None:
        return a
    null = (an & bn) if bn is not None else None
    return make_col(_pick(~an, ad, bd), null)


@function("case(boolean, any, any) -> same_branch", null_aware=True)
def _case(c, t, e, fields: Sequence[Field]):
    """CASE WHEN c THEN t ELSE e: a NULL condition selects the ELSE
    branch; branch NULLs flow through to the chosen side."""
    cd, cn = split_col(c)
    take_then = cd if cn is None else (cd & ~cn)
    td, tn = split_col(t)
    ed, en = split_col(e)
    if not isinstance(td, StrCol) \
            and fields[1].data_type != fields[2].data_type:
        target = promote_numeric([fields[1].data_type, fields[2].data_type])
        td = coerce(td, fields[1], target)
        ed = coerce(ed, fields[2], target)
    data = _pick(take_then, td, ed)
    if tn is None and en is None:
        return data
    zeros = torch.zeros_like(take_then)
    return NCol(data, torch.where(take_then,
                                  tn if tn is not None else zeros,
                                  en if en is not None else zeros))


@function("tumble_start(timestamp, interval) -> same")
@function("tumble_start(timestamptz, interval) -> same")
def _tumble_start(ts, size):
    return ts - ts % size


# ---------------------------------------------------------------------------
# strings (kernels K23a and K23d, ``expr/strings.py``)


@function("lower(stringlike) -> same")
def _lower(a: StrCol):
    return str_case_map(a, upper=False)


@function("upper(stringlike) -> same")
def _upper(a: StrCol):
    return str_case_map(a, upper=True)


@function("split_part(stringlike, stringlike, int) -> same")
@function("split_part(stringlike, stringlike, bigint) -> same")
def _split_part(a: StrCol, delim: StrCol, n):
    """1-based; a negative n counts from the end; out of range is the
    empty string (ref split_part.rs)."""
    return str_split_part(a, delim, n)


# ---------------------------------------------------------------------------
# to_char (kernel K23b): PG patterns compiled once per literal format at
# bind time, so the kernel is a fixed-width byte construction and the
# output width is static.  A copy of the reference's table.

_TO_CHAR_FIELDS = {
    # pattern -> (component, digit width); longest-first matching
    "HH24": ("hour24", 2), "hh24": ("hour24", 2),
    "HH12": ("hour12", 2), "hh12": ("hour12", 2),
    "YYYY": ("year", 4), "yyyy": ("year", 4),
    "AM": ("meridiem_upper", 2), "PM": ("meridiem_upper", 2),
    "am": ("meridiem_lower", 2), "pm": ("meridiem_lower", 2),
    "HH": ("hour12", 2), "hh": ("hour12", 2),
    "MI": ("minute", 2), "mi": ("minute", 2),
    "SS": ("second", 2), "ss": ("second", 2),
    "YY": ("year2", 2), "yy": ("year2", 2),
    "MM": ("month", 2), "mm": ("month", 2),
    "DD": ("day", 2), "dd": ("day", 2),
    "MS": ("milli", 3), "ms": ("milli", 3),
    "US": ("micro", 6), "us": ("micro", 6),
}


def compile_to_char_pattern(fmt: str) -> list:
    """[(kind, payload)]: ("lit", bytes) | ("field", (component, width))
    (a copy of the reference's compiler, longest pattern first)."""
    segs: list = []
    i = 0
    keys = sorted(_TO_CHAR_FIELDS, key=len, reverse=True)
    lit: list[int] = []
    while i < len(fmt):
        hit = next((k for k in keys if fmt.startswith(k, i)), None)
        if hit is None:
            lit.extend(fmt[i].encode("utf-8"))
            i += 1
            continue
        if lit:
            segs.append(("lit", bytes(lit)))
            lit = []
        segs.append(("field", _TO_CHAR_FIELDS[hit]))
        i += len(hit)
    if lit:
        segs.append(("lit", bytes(lit)))
    return segs


class ToChar(Expr):
    """Bound ``to_char(ts, 'literal fmt')`` expression node."""

    def __init__(self, arg: Expr, fmt: str):
        self.arg = arg
        self.fmt = fmt
        self.segs = compile_to_char_pattern(fmt)
        self.width = sum(len(p) if k == "lit" else p[1]
                         for k, p in self.segs)

    def return_field(self, schema) -> Field:
        f = self.arg.return_field(schema)
        return Field("to_char", DataType.VARCHAR,
                     str_width=max(self.width, 1), nullable=f.nullable)

    def return_type(self, schema):
        return DataType.VARCHAR

    def eval(self, chunk):
        col, null = split_col(self.arg.eval(chunk))
        return make_col(to_char(col, self.segs), null)

    def __repr__(self):
        return f"to_char({self.arg!r}, {self.fmt!r})"


# ---------------------------------------------------------------------------
# regexp_match (kernel K23c): the restricted pattern family, compiled at
# bind time.  A copy of the reference's family.

_RX_FAMILY = re.compile(
    # (&|^) prefix-guard, a literal, then a ([^X]*) capture
    r"^(?:\((?P<guard>[^)|])\|\^\)|\(\^\|(?P<guard2>[^)|])\))?"
    r"(?P<lit>[A-Za-z0-9_=:/.\-]+)"
    r"\(\[\^(?P<stop>.)\]\*\)$"
)


class RegexpGroup(Expr):
    """``(regexp_match(s, 'pat'))[2]`` for the pattern family
    ``(&|^)literal([^X]*)``: the capture after the literal, which sits at
    the string's start or after the guard character; NULL when unmatched.

    Ref: src/expr/impl/src/scalar/regexp.rs (a backtracking engine for
    full regexes; this subset runs as one byte kernel, K23c)."""

    def __init__(self, arg: Expr, pattern: str, group: int):
        m = _RX_FAMILY.match(pattern)
        if m is None:
            raise ValueError(
                f"regexp_match pattern {pattern!r} outside the "
                "supported (&|^)literal([^X]*) family")
        if group != 2:
            raise ValueError("only capture group [2] is supported")
        self.arg = arg
        self.pattern = pattern
        self.guard = m.group("guard") or m.group("guard2")
        self.lit = m.group("lit")
        self.stop = m.group("stop")
        #: the literal's bytes per device (uploaded once)
        self._lit_bytes: dict = {}

    def return_field(self, schema) -> Field:
        f = self.arg.return_field(schema)
        return Field("regexp_match", DataType.VARCHAR,
                     str_width=f.str_width, nullable=True)

    def return_type(self, schema):
        return DataType.VARCHAR

    def eval(self, chunk):
        s, s_null = split_col(self.arg.eval(chunk))
        dev = s.data.device
        lit = self._lit_bytes.get(dev)
        if lit is None:
            lit = torch.tensor(list(self.lit.encode("utf-8")),
                               dtype=torch.uint8, device=dev)
            self._lit_bytes[dev] = lit
        guard = -1 if self.guard is None else ord(self.guard)
        out, found = regexp_group(s, lit, guard, ord(self.stop))
        null = ~found if s_null is None else (~found | s_null)
        return NCol(out, null)

    def __repr__(self):
        return f"regexp_match({self.arg!r}, {self.pattern!r})[2]"
