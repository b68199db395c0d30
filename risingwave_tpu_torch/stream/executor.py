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

import ctypes
from typing import Any, Sequence

import torch

from risingwave_tpu_torch import kernels
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
from risingwave_tpu_torch.expr.node import Expr, cuda_refusal


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

    def cuda_refusal(self) -> str | None:
        for _, e in self.exprs:
            why = cuda_refusal(e)
            if why is not None:
                return why
        return None

    def apply(self, state, chunk: Chunk):
        cols = [conform_col(e.eval(chunk), f.nullable, chunk.capacity)
                for (_, e), f in zip(self.exprs, self._out_schema)]
        return state, chunk.with_columns(cols, self._out_schema)


def _planes(col) -> list[torch.Tensor]:
    """The row-major tensors (payloads, null planes, string bytes and
    lengths) that make up a column value."""
    if isinstance(col, NCol):
        return _planes(col.data) + [col.null]
    if isinstance(col, StrCol):
        return [col.data, col.lens]
    return [col]


def _rebuild(col, planes):
    """``col``'s structure over the next tensors of ``planes``."""
    if isinstance(col, NCol):
        data = _rebuild(col.data, planes)
        return NCol(data, next(planes))
    if isinstance(col, StrCol):
        return StrCol(next(planes), next(planes))
    return next(planes)


def hop_window_plain(columns, ops, valid, ts, k: int, slide: int,
                     size: int):
    """Plain PyTorch version of kernel K10: (columns, ops, valid,
    window_start, window_end), each row repeated k times (k == 1 keeps
    the chunk's own tensors)."""
    ws0 = ts - ts % slide                 # latest window start (floor mod)
    if k == 1:
        return columns, ops, valid, ws0, ws0 + size
    offs = (torch.arange(k, dtype=torch.int64, device=ts.device)
            * slide).repeat(ts.shape[0])
    ws = torch.repeat_interleave(ws0, k, dim=0) - offs
    planes = iter([torch.repeat_interleave(p, k, dim=0)
                   for c in columns for p in _planes(c)])
    cols = tuple(_rebuild(c, planes) for c in columns)
    return (cols, torch.repeat_interleave(ops, k, dim=0),
            torch.repeat_interleave(valid, k, dim=0), ws, ws + size)


def hop_window_cuda(columns, ops, valid, ts, k: int, slide: int, size: int):
    """Kernel K10 (``csrc/hop_window.cu``): one launch."""
    cap = ts.shape[0]
    dev = ts.device
    ts = ts.contiguous()
    pc = kernels.RwCols()
    outs, keep = [], [ts]
    if k > 1:
        ins = [p for c in columns for p in _planes(c)] + [ops, valid]
        if len(ins) > kernels.MAX_COLS:
            raise ValueError(f"more than {kernels.MAX_COLS} column planes")
        for j, p in enumerate(ins):
            p = p.contiguous()
            o = torch.empty((cap * k,) + tuple(p.shape[1:]), dtype=p.dtype,
                            device=dev)
            keep += [p, o]
            outs.append(o)
            pc.width[j] = p.element_size() * (p[0].numel() if p.dim() > 1
                                              else 1)
            pc.in_data[j], pc.st_data[j] = p.data_ptr(), o.data_ptr()
        pc.n = len(ins)
    kernels.require_cuda("hop_window", *keep)
    ws = torch.empty(cap * k, dtype=torch.int64, device=dev)
    we = torch.empty(cap * k, dtype=torch.int64, device=dev)
    fn = kernels.entry("hop_window", "rw_hop_window", [
        kernels.RwCols, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p])
    kernels.count_launch("hop_window")
    kernels.check(fn(pc, ts.data_ptr(), cap, k, slide, size, ws.data_ptr(),
                     we.data_ptr(), kernels.stream_ptr(dev)), "hop_window")
    if k == 1:
        return columns, ops, valid, ws, we
    planes = iter(outs)
    cols = tuple(_rebuild(c, planes) for c in columns)
    return cols, next(planes), next(planes), ws, we


def hop_window(columns, ops, valid, ts, k: int, slide: int, size: int):
    """Window assignment of a chunk; CUDA tensors launch kernel K10."""
    impl = hop_window_cuda if ts.device.type == "cuda" else hop_window_plain
    return impl(columns, ops, valid, ts, k, slide, size)


class HopWindowExecutor(Executor):
    """Append ``window_start``/``window_end`` for the windows of each row.

    TUMBLE (size == slide) appends the two columns without expanding
    rows.  HOP with k = size/slide > 1 expands each row into k copies
    (kernel K10 on the card).
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
        cols, ops, valid, ws, we = hop_window(
            chunk.columns, chunk.ops, chunk.valid, chunk.column(self.ts_col),
            self.k, self.slide_us, self.size_us)
        return state, Chunk(tuple(cols) + (ws, we), ops, valid,
                            self._out_schema)


class FilterExecutor(Executor):
    """Narrow visibility by a predicate; an Update pair split by the
    predicate degrades to a plain Insert/Delete of the surviving side."""

    def __init__(self, in_schema: Schema, predicate: Expr):
        super().__init__(in_schema)
        self.predicate = predicate
        # resolve the predicate's calls now: a bad one fails CREATE, not
        # every tick of every job
        predicate.return_field(in_schema)

    def cuda_refusal(self) -> str | None:
        return cuda_refusal(self.predicate)

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
