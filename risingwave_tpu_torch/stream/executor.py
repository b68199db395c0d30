"""Executor protocol + stateless executors.

Port of ``risingwave_tpu/stream/executor.py`` (:79-200).  An executor is
a pair of transition functions over device state, run eagerly:

- ``init_state(device) -> state``
- ``apply(state, chunk) -> (state, chunk | None)``   per chunk
- ``flush(state, epoch) -> (state, chunk | None)``   at a barrier

Filtering never compacts: it narrows the validity mask, so every kernel
sees fixed shapes.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch

from risingwave_tpu_torch.common.chunk import (
    Chunk,
    NCol,
    OP_DELETE,
    OP_INSERT,
    OP_UPDATE_DELETE,
    OP_UPDATE_INSERT,
    StrCol,
    conform_col,
    split_col,
)
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.expr.node import Expr


class Executor:
    """Base executor."""

    #: does apply() return a chunk?
    emits_on_apply: bool = True
    #: does flush() return a chunk?
    emits_on_flush: bool = False

    def __init__(self, in_schema: Schema):
        self.in_schema = in_schema

    @property
    def out_schema(self) -> Schema:
        return self.in_schema

    def init_state(self, device) -> Any:
        return ()

    def apply(self, state, chunk: Chunk):
        raise NotImplementedError

    def flush(self, state, epoch):
        return state, None

    def on_watermark(self, state, watermark):
        return state

    def __repr__(self) -> str:
        return type(self).__name__


class ProjectExecutor(Executor):
    """Evaluate expressions into a new chunk."""

    def __init__(self, in_schema: Schema, exprs: Sequence[tuple[str, Expr]]):
        super().__init__(in_schema)
        self.exprs = tuple(exprs)
        fields = []
        for name, e in self.exprs:
            f = e.return_field(in_schema)
            fields.append(Field(name, f.data_type, str_width=f.str_width,
                                decimal_scale=f.decimal_scale,
                                nullable=f.nullable))
        self._out_schema = Schema(tuple(fields))

    @property
    def out_schema(self) -> Schema:
        return self._out_schema

    def apply(self, state, chunk: Chunk):
        cols = [conform_col(e.eval(chunk), f.nullable, chunk.capacity)
                for (_, e), f in zip(self.exprs, self._out_schema)]
        return state, chunk.with_columns(cols, self._out_schema)


class HopWindowExecutor(Executor):
    """Append ``window_start``/``window_end`` for the windows of each row.

    TUMBLE (size == slide) appends the two columns without expanding
    rows.  HOP with k = size/slide > 1 expands each row into k copies.
    """

    def __init__(self, in_schema: Schema, ts_col: int, slide_us: int,
                 size_us: int, window_col: str = "window_start"):
        super().__init__(in_schema)
        if size_us % slide_us:
            raise ValueError("hop size must be a multiple of slide")
        self.ts_col = ts_col
        self.slide_us = slide_us
        self.size_us = size_us
        self.k = size_us // slide_us
        self._out_schema = Schema(
            in_schema.fields + (Field(window_col, DataType.TIMESTAMP),
                                Field("window_end", DataType.TIMESTAMP)))

    @property
    def out_schema(self) -> Schema:
        return self._out_schema

    def apply(self, state, chunk: Chunk):
        cap, k = chunk.capacity, self.k

        def rep(c):
            if isinstance(c, NCol):
                return NCol(rep(c.data), rep(c.null))
            if isinstance(c, StrCol):
                return StrCol(rep(c.data), rep(c.lens))
            return torch.repeat_interleave(c, k, dim=0)

        ts = chunk.column(self.ts_col)
        ws0 = ts - ts % self.slide_us            # latest window start
        if k == 1:
            return state, Chunk(
                chunk.columns + (ws0, ws0 + self.size_us),
                chunk.ops, chunk.valid, self._out_schema)
        offs = (torch.arange(k, dtype=torch.int64, device=ts.device)
                * self.slide_us).repeat(cap)
        ws = rep(ws0) - offs
        cols = tuple(rep(c) for c in chunk.columns) + (ws, ws + self.size_us)
        return state, Chunk(cols, rep(chunk.ops), rep(chunk.valid),
                            self._out_schema)


class FilterExecutor(Executor):
    """Narrow visibility by a predicate; an Update pair split by the
    predicate degrades to a plain Insert/Delete of the surviving side."""

    def __init__(self, in_schema: Schema, predicate: Expr):
        super().__init__(in_schema)
        self.predicate = predicate

    def apply(self, state, chunk: Chunk):
        keep, null = split_col(self.predicate.eval(chunk))
        if null is not None:
            keep = keep & ~null
        keep = keep & chunk.valid
        is_ud = chunk.ops == OP_UPDATE_DELETE
        is_ui = chunk.ops == OP_UPDATE_INSERT
        partner_of_ud = torch.roll(keep, -1)
        partner_of_ui = torch.roll(keep, 1)
        ops = chunk.ops
        ops = torch.where(is_ud & keep & ~partner_of_ud,
                          torch.full_like(ops, OP_DELETE), ops)
        ops = torch.where(is_ui & keep & ~partner_of_ui,
                          torch.full_like(ops, OP_INSERT), ops)
        return state, Chunk(chunk.columns, ops, keep, chunk.schema)
