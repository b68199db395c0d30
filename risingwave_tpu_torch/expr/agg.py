"""Aggregate functions as primitive scatter states.

Port of ``risingwave_tpu/expr/agg.py`` (:79-219): an aggregate is one or
more primitive states, each updated by one scatter over the chunk's
slot vector — ``add`` states (count, sum) are retractable through the
changelog sign, ``min``/``max`` states are monotone monoids exact for
append-only input.  ``lift`` maps (value column, signs) to each row's
contribution; ``output`` turns the states into the SQL result at flush.

Ported: count, count(*), sum, sum0, avg (a sum and a count state,
``_out_avg``), min, max.  The packed string min/max are not ported yet
(``AggCall.spec`` raises).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from risingwave_tpu_torch.common.types import DataType, Field
from risingwave_tpu_torch.expr.node import Expr


@dataclass(frozen=True)
class PrimState:
    """One scatter-updatable state tensor of a (possibly composite) agg."""

    mode: str  # "add" | "min" | "max"
    #: state dtype given the input column dtype
    dtype: Callable[[torch.dtype], torch.dtype]
    #: identity element (a python scalar)
    init: Callable[[torch.dtype], object]
    #: (value_col, signs) -> per-row contribution
    lift: Callable


def _sum_dtype(d: torch.dtype) -> torch.dtype:
    # sum of int16/int32 widens to int64 (SQL sum semantics)
    if not d.is_floating_point and d != torch.bool:
        return torch.int64
    return d


_ADD_COUNT = PrimState(
    "add", lambda d: torch.int64, lambda d: 0,
    lambda col, signs: signs.to(torch.int64),
)

_ADD_SUM = PrimState(
    "add", _sum_dtype, lambda d: 0,
    lambda col, signs: col.to(_sum_dtype(col.dtype))
    * signs.to(_sum_dtype(col.dtype)),
)


def _minmax_init(mode: str):
    def init(d: torch.dtype):
        if d.is_floating_point:
            return float("inf") if mode == "min" else float("-inf")
        info = torch.iinfo(d)
        return info.max if mode == "min" else info.min

    return init


def _minmax_lift(mode: str):
    def lift(col, signs):
        # deletes must not feed min/max; the executor counts them
        neutral = torch.full_like(col, _minmax_init(mode)(col.dtype))
        return torch.where(signs > 0, col, neutral)

    return lift


_MIN = PrimState("min", lambda d: d, _minmax_init("min"), _minmax_lift("min"))
_MAX = PrimState("max", lambda d: d, _minmax_init("max"), _minmax_lift("max"))


@dataclass(frozen=True)
class AggSpec:
    """A SQL aggregate = primitive states + an output combiner."""

    name: str
    states: tuple[PrimState, ...]
    #: (state_cols, group_count, out_field) -> output column
    output: Callable
    retractable: bool
    return_type: Callable[[DataType | None], DataType]


def _out_first(states, count, out_field):
    return states[0]


def _out_avg(states, count, out_field):
    """sum / count: float64 for integer and float input; a DECIMAL sum
    divided with truncation toward zero (floor division would bias a
    negative sum); 0 for an empty group."""
    s, c = states
    safe = torch.where(c == 0, torch.ones_like(c), c)
    if out_field.data_type == DataType.DECIMAL:
        q = torch.sign(s) * (torch.abs(s) // safe)
        return torch.where(c != 0, q, torch.zeros_like(q))
    q = s / safe.to(torch.float64)
    return torch.where(c != 0, q, torch.zeros_like(q))


def _avg_type(t):
    return DataType.DECIMAL if t == DataType.DECIMAL else DataType.FLOAT64


def _sum_type(t):
    return DataType.INT64 if t in (DataType.INT16, DataType.INT32) else t


AGG_REGISTRY: dict[str, AggSpec] = {
    "count": AggSpec("count", (_ADD_COUNT,), _out_first, True,
                     lambda t: DataType.INT64),
    "count_star": AggSpec("count_star", (_ADD_COUNT,), _out_first, True,
                          lambda t: DataType.INT64),
    "sum": AggSpec("sum", (_ADD_SUM,), _out_first, True, _sum_type),
    "sum0": AggSpec("sum0", (_ADD_SUM,), _out_first, True, _sum_type),
    "avg": AggSpec("avg", (_ADD_SUM, _ADD_COUNT), _out_avg, True, _avg_type),
    "min": AggSpec("min", (_MIN,), _out_first, False, lambda t: t),
    "max": AggSpec("max", (_MAX,), _out_first, False, lambda t: t),
}


@dataclass(frozen=True)
class AggCall:
    """One aggregate call in a plan: kind + input expression."""

    kind: str
    arg: Expr | None = None
    alias: str | None = None
    distinct: bool = False
    filter: Expr | None = None

    def spec(self) -> AggSpec:
        if self.kind not in AGG_REGISTRY:
            raise NotImplementedError(
                f"aggregate {self.kind} is not ported yet")
        return AGG_REGISTRY[self.kind]

    def out_field(self, input_schema) -> Field:
        spec = self.spec()
        if self.arg is None:
            in_t, scale, nullable = None, 6, False
        else:
            f = self.arg.return_field(input_schema)
            in_t, scale = f.data_type, f.decimal_scale
            nullable = (f.nullable or self.filter is not None) \
                and self.kind not in ("count", "count_star")
        return Field(self.alias or self.kind, spec.return_type(in_t),
                     decimal_scale=scale, nullable=nullable)

