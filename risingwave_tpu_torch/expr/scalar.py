"""Scalar functions: the part of the reference's ``expr/scalar.py`` that
the ported plans reach.

Port of ``risingwave_tpu/expr/scalar.py``: integer/timestamp
arithmetic, comparisons, boolean logic, ``tumble_start`` (:423),
NUMERIC multiply (:137) and integer/decimal coercion.  Every
implementation takes and returns whole torch columns.  NUMERIC divide
and the string functions are not ported yet and raise.

torch's ``%`` and ``//`` on integer tensors floor like ``jnp``'s, so
``ts - ts % size`` gives the same window start for negative times.
"""

from __future__ import annotations

from typing import Sequence

import torch

from risingwave_tpu_torch.common.chunk import NCol, split_col
from risingwave_tpu_torch.common.types import (
    DEFAULT_DECIMAL_SCALE,
    DataType,
    Field,
)
from risingwave_tpu_torch.expr.registry import function, promote_numeric

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


def _make_cmp(name: str, op):
    @function(f"{name}(numeric, numeric) -> boolean")
    def _cmp(a, b, fields: Sequence[Field]):
        (a, b), _ = _promote_args((a, b), fields)
        return op(a, b)

    @function(f"{name}(timelike, timelike) -> boolean")
    @function(f"{name}(boolean, boolean) -> boolean")
    def _cmp_t(a, b):
        return op(a, b)

    return _cmp


_make_cmp("equal", lambda a, b: a == b)
_make_cmp("not_equal", lambda a, b: a != b)
_make_cmp("less_than", lambda a, b: a < b)
_make_cmp("less_than_or_equal", lambda a, b: a <= b)
_make_cmp("greater_than", lambda a, b: a > b)
_make_cmp("greater_than_or_equal", lambda a, b: a >= b)


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


@function("tumble_start(timestamp, interval) -> same")
@function("tumble_start(timestamptz, interval) -> same")
def _tumble_start(ts, size):
    return ts - ts % size
