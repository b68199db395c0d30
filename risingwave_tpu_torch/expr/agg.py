"""Aggregate functions as primitive scatter states.

Port of ``risingwave_tpu/expr/agg.py`` (:79-219): an aggregate is one or
more primitive states, each updated by one scatter over the chunk's
slot vector — ``add`` states (count, sum) are retractable through the
changelog sign, ``min``/``max`` states are monotone monoids exact for
append-only input.  ``lift`` maps (value column, signs) to each row's
contribution; ``output`` turns the states into the SQL result at flush.

Ported: count, count(*), sum, sum0, avg (a sum and a count state,
``_out_avg``), min, max, and min/max over strings of at most 8 bytes
(``min_str``/``max_str`` :115-160, :223-226; the planner rewrites
``min``/``max`` over a short VARCHAR to them): each string packs
big-endian into one int64 whose signed order is the byte order
(``pack_str8``), so the aggregation kernels see an int64 min/max state;
the output unpacks it with the length at the last nonzero byte.  The
pack and unpack are plain PyTorch ops, as the reference's are one fused
expression each.
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


# -- min/max over short strings: an order-preserving int64 packing ----------

_INT64_MIN = -(1 << 63)


def pack_str8(col) -> torch.Tensor:
    """A copy of the reference's ``_pack_str8`` (expr/agg.py:131): a
    ``StrCol`` of width <= 8 packed big-endian (bytes at and past the
    length as 0) into int64 [cap], the sign bit flipped so that signed
    order is byte order.  Built as eight little-endian bytes viewed as
    one int64 (no shift overflows)."""
    data, lens = col.data, col.lens
    cap, w = data.shape
    j = torch.arange(w, device=data.device)
    be = torch.zeros((cap, 8), dtype=torch.uint8, device=data.device)
    be[:, :w] = torch.where(j[None, :] < lens[:, None], data,
                            torch.zeros_like(data))
    return be.flip(1).contiguous().view(torch.int64).reshape(cap) ^ _INT64_MIN


def _minmax_str_lift(mode: str):
    def lift(col, signs):
        packed = pack_str8(col)
        neutral = torch.full_like(packed, _minmax_init(mode)(torch.int64))
        return torch.where(signs > 0, packed, neutral)

    return lift


def _out_minmax_str(states, count, out_field):
    """A copy of the reference's ``_out_minmax_str`` (:145): the packed
    state back to an 8-byte ``StrCol``, the length at its last nonzero
    byte (an all-zero state is the empty string)."""
    from risingwave_tpu_torch.common.chunk import StrCol

    v = (states[0] ^ _INT64_MIN).contiguous()
    bytes_ = v.view(torch.uint8).reshape(-1, 8).flip(1).contiguous()
    pos = torch.arange(1, 9, dtype=torch.int32, device=v.device)
    lens = torch.where(bytes_ != 0, pos, torch.zeros_like(pos)).amax(1)
    return StrCol(bytes_, lens.to(torch.int32))


_MIN_STR = PrimState("min", lambda d: torch.int64, _minmax_init("min"),
                     _minmax_str_lift("min"))
_MAX_STR = PrimState("max", lambda d: torch.int64, _minmax_init("max"),
                     _minmax_str_lift("max"))


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
    # min/max over strings of <= 8 device bytes (a planner rewrite)
    "min_str": AggSpec("min_str", (_MIN_STR,), _out_minmax_str, False,
                       lambda t: DataType.VARCHAR),
    "max_str": AggSpec("max_str", (_MAX_STR,), _out_minmax_str, False,
                       lambda t: DataType.VARCHAR),
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
        t = spec.return_type(in_t)
        # the packed string min/max emits a fixed 8-byte column
        kw = {"str_width": 8} if t.is_string else {}
        return Field(self.alias or self.kind, t, decimal_scale=scale,
                     nullable=nullable, **kw)

