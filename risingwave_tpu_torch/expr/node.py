"""Expression AST.

Port of ``risingwave_tpu/expr/node.py``.  ``Expr.eval(chunk)`` returns a
torch column on the chunk's device; ``FuncCall`` dispatches through the
function registry (``expr/registry.py``) to the implementations in
``expr/scalar.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from risingwave_tpu_torch.common.chunk import Chunk, NCol, StrCol, encode_strings
from risingwave_tpu_torch.common.types import (
    DEFAULT_DECIMAL_SCALE,
    DEFAULT_STR_WIDTH,
    DataType,
    Field,
    Schema,
)


class Expr:
    """Base expression node; subclasses are immutable."""

    def return_field(self, schema: Schema) -> Field:
        raise NotImplementedError

    def eval(self, chunk: Chunk):
        """Evaluate to a column ([cap] tensor, StrCol or NCol)."""
        raise NotImplementedError

    def return_type(self, schema: Schema) -> DataType:
        return self.return_field(schema).data_type

    def _f(self, name: str, *others: "Expr | Any") -> "FuncCall":
        return FuncCall(name, (self, *[as_expr(o) for o in others]))

    def __add__(self, o):
        return self._f("add", o)

    def __sub__(self, o):
        return self._f("subtract", o)

    def __mul__(self, o):
        return self._f("multiply", o)

    def __truediv__(self, o):
        return self._f("divide", o)

    def __mod__(self, o):
        return self._f("modulus", o)

    def __neg__(self):
        return self._f("neg")

    def __eq__(self, o):  # type: ignore[override]
        return self._f("equal", o)

    def __ne__(self, o):  # type: ignore[override]
        return self._f("not_equal", o)

    def __lt__(self, o):
        return self._f("less_than", o)

    def __le__(self, o):
        return self._f("less_than_or_equal", o)

    def __gt__(self, o):
        return self._f("greater_than", o)

    def __ge__(self, o):
        return self._f("greater_than_or_equal", o)

    def __and__(self, o):
        return self._f("and", o)

    def __or__(self, o):
        return self._f("or", o)

    def __invert__(self):
        return self._f("not")

    def __hash__(self):
        return object.__hash__(self)


@dataclass(frozen=True, eq=False)
class InputRef(Expr):
    """Column reference by position."""

    index: int

    def return_field(self, schema: Schema) -> Field:
        return schema[self.index]

    def eval(self, chunk: Chunk):
        return chunk.column(self.index)

    def __repr__(self):
        return f"${self.index}"


@dataclass(frozen=True, eq=False)
class Literal(Expr):
    """Constant, broadcast to the chunk capacity.

    A VARCHAR literal is encoded and uploaded once per device and
    returned as a stride-0 view of that one row (``expand``): no
    per-chunk host copy, and the string kernels read it as one row."""

    value: Any
    data_type: DataType
    #: the encoded string row per device (bytes [1, w], lens [1])
    _rows: dict = field(default_factory=dict, init=False, repr=False)

    def return_field(self, schema: Schema) -> Field:
        return Field("?const", self.data_type, nullable=self.value is None)

    def eval(self, chunk: Chunk):
        cap, dev = chunk.capacity, chunk.device
        t = self.data_type
        if self.value is None:
            if t.is_string:
                data = StrCol(
                    torch.zeros((cap, DEFAULT_STR_WIDTH), dtype=torch.uint8,
                                device=dev),
                    torch.zeros(cap, dtype=torch.int32, device=dev))
            else:
                data = torch.zeros(cap, dtype=t.physical_dtype, device=dev)
            return NCol(data, torch.ones(cap, dtype=torch.bool, device=dev))
        if t.is_string:
            row = self._rows.get(dev)
            if row is None:
                data, lens = encode_strings([self.value], DEFAULT_STR_WIDTH)
                row = (torch.from_numpy(data).to(dev),
                       torch.from_numpy(lens).to(dev))
                self._rows[dev] = row
            return StrCol(row[0].expand(cap, -1), row[1].expand(cap))
        if t == DataType.DECIMAL:
            v = int(round(float(self.value) * 10**DEFAULT_DECIMAL_SCALE))
            return torch.full((cap,), v, dtype=torch.int64, device=dev)
        return torch.full((cap,), self.value, dtype=t.physical_dtype,
                          device=dev)

    def __repr__(self):
        return f"{self.value}:{self.data_type.name.lower()}"


@dataclass(frozen=True, eq=False)
class FuncCall(Expr):
    """Scalar function application, resolved via the registry."""

    name: str
    args: tuple[Expr, ...]

    def _resolve(self, schema: Schema):
        from risingwave_tpu_torch.expr import scalar  # noqa: F401 registers
        from risingwave_tpu_torch.expr.registry import FUNCTION_REGISTRY

        arg_fields = [a.return_field(schema) for a in self.args]
        return FUNCTION_REGISTRY.resolve(self.name, arg_fields), arg_fields

    def return_field(self, schema: Schema) -> Field:
        sig, arg_fields = self._resolve(schema)
        return sig.return_field(arg_fields)

    def eval(self, chunk: Chunk):
        sig, arg_fields = self._resolve(chunk.schema)
        cols = [a.eval(chunk) for a in self.args]
        return sig.call(cols, arg_fields)

    def __repr__(self):
        return f"{self.name}({', '.join(map(repr, self.args))})"


def cuda_refusal(e: Expr) -> str | None:
    """Why the card's kernels cannot evaluate ``e`` or one of its
    sub-expressions, or None (a node with a compiled program names its
    own limits: ``LikePattern``, ``ToChar``)."""
    why = e.cuda_refusal() if hasattr(e, "cuda_refusal") else None
    if why is not None:
        return why
    subs = getattr(e, "args", ()) if isinstance(e, FuncCall) \
        else (getattr(e, "arg", None),)
    for sub in subs:
        if isinstance(sub, Expr):
            why = cuda_refusal(sub)
            if why is not None:
                return why
    return None


def as_expr(v: Any) -> Expr:
    """Coerce python values to Literal exprs."""
    if isinstance(v, Expr):
        return v
    if isinstance(v, bool):
        return Literal(v, DataType.BOOLEAN)
    if isinstance(v, int):
        return Literal(v, DataType.INT64 if abs(v) > 2**31 - 1
                       else DataType.INT32)
    if isinstance(v, float):
        return Literal(v, DataType.FLOAT64)
    if isinstance(v, str):
        return Literal(v, DataType.VARCHAR)
    if isinstance(v, np.integer):
        return as_expr(int(v))
    if isinstance(v, np.floating):
        return as_expr(float(v))
    raise TypeError(f"cannot coerce {v!r} to Expr")


