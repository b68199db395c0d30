"""Scalar functions: the port of the reference's ``expr/scalar.py``.

Port of ``risingwave_tpu/expr/scalar.py``, its whole registry: the
casts (``coerce`` :35, ``cast_*`` :77-96), arithmetic with the NUMERIC
and float divide (``_div`` :150), comparisons (strings too), boolean
logic, IS [NOT] NULL, COALESCE and CASE, the math functions (:173-215,
:452-502), ``tumble_start``, ``extract_*`` and ``date_trunc_*``, and the
string functions: ``lower``/``upper``, ``split_part``, ``replace``,
``substr``, ``trim``/``ltrim``/``rtrim``, ``concat`` (also ``||``),
``starts_with``/``ends_with``/``contains``, the byte lengths, the LIKE
of ``%`` patterns (``LikePattern``), ``to_char`` (``ToChar``) and the
``regexp_match`` capture (``RegexpGroup``).  Every implementation takes
and returns whole torch columns.

The string walks and the calendar run in the K23 kernels
(``expr/strings.py``); the casts and the elementwise math stay plain
PyTorch: in the JAX package each is one ``jnp`` op that XLA fuses into
its neighbours, not a loop of its own.  XLA converts float to int
saturating (NaN to 0), which ``_to_int`` repeats; its ``sqrt``, ``exp``,
``log`` and ``pow`` may differ from torch's in the last bits.

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
    extract,
    like_match,
    like_refusal,
    pad_bytes,
    regexp_group,
    str_case_map,
    str_cmp,
    str_concat,
    str_match,
    str_replace,
    str_split_part,
    str_substr,
    str_trim,
    to_char,
    to_char_refusal,
)

_SCALE = 10**DEFAULT_DECIMAL_SCALE
_US_PER_DAY = 86_400_000_000


def _to_int(col: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``col`` converted to an integer dtype as XLA converts: a float
    saturates at the type's range and NaN becomes 0 (torch's own
    conversion is undefined there)."""
    if not col.dtype.is_floating_point:
        return col.to(dtype)
    info = torch.iinfo(dtype)
    hi = col >= float(info.max)
    lo = col <= float(info.min)
    safe = torch.where(hi | lo | torch.isnan(col), 0, col).to(dtype)
    return torch.where(hi, info.max, torch.where(lo, info.min, safe))


def coerce(col, field: Field, target: DataType):
    """Cast a column from its logical type to ``target`` (the
    reference's ``coerce``; a string column raises ``TypeError``)."""
    t = field.data_type
    if t == target and not (
        t == DataType.DECIMAL and field.decimal_scale != DEFAULT_DECIMAL_SCALE
    ):
        return col
    if isinstance(col, StrCol):
        raise TypeError(f"cannot cast string column to {target}")
    pdt = target.physical_dtype
    if t == DataType.DECIMAL:
        if target == DataType.DECIMAL:
            # a non-default-scale column rescales to the engine scale,
            # which the arithmetic assumes (floor division when narrowing)
            diff = DEFAULT_DECIMAL_SCALE - field.decimal_scale
            if diff > 0:
                return col * (10**diff)
            return col // (10 ** (-diff))
        if target in (DataType.FLOAT32, DataType.FLOAT64):
            return col.to(pdt) / torch.tensor(float(10**field.decimal_scale),
                                              dtype=pdt)
        if target.is_integral:
            return (col // (10**field.decimal_scale)).to(pdt)
        raise TypeError(f"decimal -> {target}?")
    if target == DataType.DECIMAL:
        if t.is_integral:
            return col.to(torch.int64) * _SCALE
        # float -> decimal: round half to even at the engine scale
        return _to_int(torch.round(col.to(torch.float64) * _SCALE),
                       torch.int64)
    if target == DataType.BOOLEAN:
        return col != 0
    if t == DataType.DATE and target in (DataType.TIMESTAMP,
                                         DataType.TIMESTAMPTZ):
        # DATE is int32 days since the epoch; timestamps int64 us
        return col.to(torch.int64) * _US_PER_DAY
    if t in (DataType.TIMESTAMP, DataType.TIMESTAMPTZ) \
            and target == DataType.DATE:
        return (col // _US_PER_DAY).to(torch.int32)
    if pdt.is_floating_point:
        return col.to(pdt)
    return _to_int(col, pdt)


def _mk_cast(target: DataType):
    def _cast(a, fields: Sequence[Field]):
        return coerce(a, fields[0], target)

    return _cast


for _t in (DataType.INT16, DataType.INT32, DataType.INT64, DataType.FLOAT32,
           DataType.FLOAT64, DataType.DECIMAL, DataType.BOOLEAN,
           DataType.TIMESTAMP, DataType.TIMESTAMPTZ, DataType.DATE):
    function(f"cast_{_t.name.lower()}(any) -> {_t.value}")(_mk_cast(_t))


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
    """DECIMAL through float64, rounded half to even at the engine scale
    (0 where the divisor is 0); float IEEE; integer floor (0 for 0)."""
    (a, b), t = _promote_args((a, b), fields)
    if t == DataType.DECIMAL:
        safe = torch.where(b == 0, torch.ones_like(b), b)
        q = a.to(torch.float64) / safe.to(torch.float64)
        return torch.where(b != 0, _to_int(torch.round(q * _SCALE),
                                           torch.int64),
                           torch.zeros_like(a))
    if a.dtype.is_floating_point:
        return a / b
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


@function("abs(numeric) -> same")
def _abs(a):
    return torch.abs(a)


@function("round(floatlike) -> same")
def _round(a):
    return torch.round(a)


@function("round(numeric) -> same")
def _round_dec(a, fields: Sequence[Field]):
    if fields[0].data_type == DataType.DECIMAL:
        s = 10**fields[0].decimal_scale
        # half away from zero (floor division alone biases negatives)
        return torch.sign(a) * ((torch.abs(a) + s // 2) // s * s)
    return torch.round(a)


@function("round(numeric, int) -> same")
@function("round(numeric, bigint) -> same")
def _round_dec_n(a, n, fields: Sequence[Field]):
    """round(x, n): n decimal places.  DECIMAL keeps its storage scale
    with the value rounded to n places; floats round through a scale."""
    if fields[0].data_type == DataType.DECIMAL:
        shift = torch.clamp(fields[0].decimal_scale - n.to(torch.int64),
                            min=0)
        p = torch.pow(10, shift)
        return torch.sign(a) * ((torch.abs(a) + p // 2) // p * p)
    if not a.dtype.is_floating_point:
        return a  # rounding an integer to >= 0 places is the identity
    p = torch.pow(10.0, n.to(torch.float64))
    return torch.round(a * p) / p


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


# ---------------------------------------------------------------------------
# temporal: microsecond functions are registered for the microsecond types
# only (DATE is int32 days and must not match them)

_US = {"second": 1_000_000, "minute": 60_000_000, "hour": 3_600_000_000,
       "day": _US_PER_DAY}


@function("extract_epoch(timestamp) -> bigint")
@function("extract_epoch(timestamptz) -> bigint")
def _extract_epoch(a):
    return extract(a, "epoch")


@function("extract_epoch(date) -> bigint")
def _extract_epoch_date(a):
    return extract(a, "epoch", date=True)


def _us_trunc(unit: str):
    def impl(a):
        return a - a % _US[unit]

    return impl


for _unit in ("second", "minute", "hour", "day"):
    _impl = _us_trunc(_unit)
    function(f"date_trunc_{_unit}(timestamp) -> same")(_impl)
    function(f"date_trunc_{_unit}(timestamptz) -> same")(_impl)


@function("tumble_start(timestamp, interval) -> same")
@function("tumble_start(timestamptz, interval) -> same")
def _tumble_start(ts, size):
    return ts - ts % size


def _mk_extract(part: str, date: bool):
    def impl(a):
        return extract(a, part, date=date)

    return impl


# extract(part FROM x): kernel K23h (the calendar of _civil_from_ts)
for _part in ("year", "month", "day", "hour", "minute", "second", "dow",
              "doy"):
    function(f"extract_{_part}(timestamp) -> bigint")(
        _mk_extract(_part, False))
    function(f"extract_{_part}(timestamptz) -> bigint")(
        _mk_extract(_part, False))
    function(f"extract_{_part}(date) -> bigint")(_mk_extract(_part, True))


# ---------------------------------------------------------------------------
# math (elementwise, plain PyTorch)


def _f64(a, field: Field):
    return coerce(a, field, DataType.FLOAT64)


@function("sqrt(numeric) -> double precision")
def _sqrt(a, fields: Sequence[Field]):
    return torch.sqrt(_f64(a, fields[0]))


@function("power(numeric, numeric) -> double precision")
def _power(a, b, fields: Sequence[Field]):
    return torch.pow(_f64(a, fields[0]), _f64(b, fields[1]))


@function("exp(numeric) -> double precision")
def _exp(a, fields: Sequence[Field]):
    return torch.exp(_f64(a, fields[0]))


@function("ln(numeric) -> double precision")
def _ln(a, fields: Sequence[Field]):
    return torch.log(_f64(a, fields[0]))


@function("log10(numeric) -> double precision")
def _log10(a, fields: Sequence[Field]):
    return torch.log10(_f64(a, fields[0]))


@function("floor(floatlike) -> same")
def _floor(a):
    return torch.floor(a)


@function("ceil(floatlike) -> same")
def _ceil(a):
    return torch.ceil(a)


@function("sign(numeric) -> int")
def _sign(a):
    return _to_int(torch.sign(a), torch.int32)


@function("greatest(numeric, numeric) -> auto")
def _greatest(a, b, fields: Sequence[Field]):
    (a, b), _ = _promote_args((a, b), fields)
    return torch.maximum(a, b)


@function("least(numeric, numeric) -> auto")
def _least(a, b, fields: Sequence[Field]):
    (a, b), _ = _promote_args((a, b), fields)
    return torch.minimum(a, b)


# ---------------------------------------------------------------------------
# strings (kernels K23a, K23d-g, ``expr/strings.py``)


@function("char_length(stringlike) -> int")
def _char_length(a: StrCol):
    # byte length, as the reference's (full UTF-8 counting is not there)
    return a.lens


@function("octet_length(stringlike) -> int")
def _octet_length(a: StrCol):
    return a.lens


@function("length(stringlike) -> int")
def _length(a: StrCol):
    return a.lens


@function("concat(stringlike, stringlike) -> character varying")
def _concat(a: StrCol, b: StrCol):
    return str_concat(a, b)


@function("substr(stringlike, int) -> same")
@function("substr(stringlike, bigint) -> same")
def _substr2(a: StrCol, start):
    return str_substr(a, start)


@function("substr(stringlike, int, int) -> same")
@function("substr(stringlike, bigint, bigint) -> same")
def _substr3(a: StrCol, start, count):
    return str_substr(a, start, count)


@function("trim(stringlike) -> same")
def _trim(a: StrCol):
    return str_trim(a, "trim")


@function("ltrim(stringlike) -> same")
def _ltrim(a: StrCol):
    return str_trim(a, "ltrim")


@function("rtrim(stringlike) -> same")
def _rtrim(a: StrCol):
    return str_trim(a, "rtrim")


@function("starts_with(stringlike, stringlike) -> boolean")
def _starts_with(a: StrCol, p: StrCol):
    return str_match(a, p, "starts_with")


@function("ends_with(stringlike, stringlike) -> boolean")
def _ends_with(a: StrCol, p: StrCol):
    return str_match(a, p, "ends_with")


@function("contains(stringlike, stringlike) -> boolean")
def _contains(a: StrCol, p: StrCol):
    return str_match(a, p, "contains")


@function("replace(stringlike, stringlike, stringlike) -> same")
def _replace(a: StrCol, frm: StrCol, to: StrCol):
    """Greedy leftmost matches of ``frm`` rewritten to ``to``; the output
    is clamped at the input's width, as the reference's (ref
    replace.rs)."""
    return str_replace(a, frm, to)


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

    def cuda_refusal(self) -> str | None:
        return to_char_refusal(tuple(self.segs))

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


# ---------------------------------------------------------------------------
# LIKE over '%' patterns (kernel K23f), compiled at bind time


class LikePattern(Expr):
    """General ``%``-wildcard LIKE, compiled at bind time into its
    non-empty segments and two anchors; K23f runs the reference's
    leftmost-first sequential segment search (ref like.rs walks a byte
    DP; for ``%``-only patterns the two agree).  ``_`` wildcards are
    refused, as in the reference."""

    def __init__(self, arg: Expr, pattern: str):
        if "_" in pattern:
            raise ValueError("LIKE '_' wildcards not supported")
        self.arg = arg
        self.pattern = pattern
        self.segs = tuple(x.encode("utf-8") for x in pattern.split("%")
                          if x != "")
        self.anchor_start = not pattern.startswith("%")
        self.anchor_end = not pattern.endswith("%")

    def return_field(self, schema) -> Field:
        f = self.arg.return_field(schema)
        return Field("like", DataType.BOOLEAN, nullable=f.nullable)

    def return_type(self, schema):
        return DataType.BOOLEAN

    def cuda_refusal(self) -> str | None:
        return like_refusal(self.segs)

    def eval(self, chunk):
        a, null = split_col(self.arg.eval(chunk))
        return make_col(like_match(a, self.segs, self.anchor_start,
                                   self.anchor_end), null)

    def __repr__(self):
        return f"like({self.arg!r}, {self.pattern!r})"
