"""Chunk-local partial aggregation (phase 1 of two-phase aggregation).

Port of ``risingwave_tpu/stream/partial_agg.py``: ``TWO_PHASE_KINDS``,
``translated_global_calls`` (:39-52) and ``PartialAggExecutor`` (:55-204).
The pane rewrite of HOP aggregations (``sql/planner.py``) uses the first
two; the sharded job (``stream/sharded.py``) puts the executor before its
hash exchange, so that each chunk's duplicate keys collapse into one
partial row before they cross lanes.

``PartialAggExecutor.apply`` is stateless: the keys' 64-bit hash (kernel
A), invalid rows keyed ``~0`` so they sort last, a stable sort by the
unsigned hash (``torch.sort`` of the int64 pattern with its sign bit
flipped: unsigned order is signed order after ``^ INT64_MIN``), then K22c
(``csrc/partial_agg.cu``): segments split on full key equality and on a
change of validity, each aggregate reduced per segment (a signed count, a
signed sum, min or max with NULLs skipped) and broadcast back to the
segment's rows, and only a segment's first row valid.  Every row of the
output carries its sorted key and its segment's partials, invalid rows
included, as the reference's does.  ``partial_agg_plain`` is K22c's plain
version.  Integer partials are exact; a float sum adds its segment's rows
serially in sorted order (the plain version through ``index_add_``, whose
order on the card is not fixed).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from risingwave_tpu_torch import kernels
from risingwave_tpu_torch.common.chunk import (
    Chunk,
    NCol,
    StrCol,
    conform_col,
    split_col,
)
from risingwave_tpu_torch.common.hash import (
    hash64_columns,
    key_leaves,
    leaf_width,
)
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.expr.agg import AggCall
from risingwave_tpu_torch.expr.node import Expr, InputRef
from risingwave_tpu_torch.state.hash_table import gather_key, keys_equal
from risingwave_tpu_torch.stream.executor import Executor

#: aggs decomposable into ONE signed/monoid partial column
TWO_PHASE_KINDS = {"count", "count_star", "sum", "sum0", "min", "max"}

INT64_MIN = -(1 << 63)


def translated_global_calls(aggs: Sequence[AggCall], n_keys: int):
    """Global-phase calls reading the partial columns (same output
    arity and order as the original calls)."""
    combine = {"count": "sum0", "count_star": "sum0", "sum": "sum",
               "sum0": "sum0", "min": "min", "max": "max"}
    return [AggCall(combine[a.kind], InputRef(n_keys + i), a.alias or a.kind)
            for i, a in enumerate(aggs)]


#: K22c's codes (``PAGG_*`` in the source)
_KIND = {"count": 0, "count_star": 0, "sum": 1, "sum0": 1, "min": 2,
         "max": 3}
_DTYPE = {torch.int64: 0, torch.int32: 1, torch.int16: 2, torch.float32: 3,
          torch.float64: 4}
MAX_AGGS = 16


def _part_dtype(kind: str, dtype: torch.dtype) -> torch.dtype:
    if kind in ("count", "count_star"):
        return torch.int64
    if kind in ("sum", "sum0") and not dtype.is_floating_point:
        return torch.int64
    return dtype


def _identity(kind: str, dtype: torch.dtype):
    if dtype.is_floating_point:
        return float("inf") if kind == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if kind == "min" else info.min


def _sort_col(c, order: torch.Tensor):
    return gather_key(c, order)


def partial_agg_plain(key_cols: list, args: list, kinds: list[str],
                      nullable: list[bool], valid: torch.Tensor,
                      signs: torch.Tensor, order: torch.Tensor):
    """Plain PyTorch version of K22c: (sorted keys, partials, valid_out)
    over the rows in ``order``."""
    cap = valid.shape[0]
    dev = valid.device
    valid_s = valid[order]
    signs_s = signs[order]
    sorted_keys = [_sort_col(c, order) for c in key_cols]
    same = torch.ones(cap, dtype=torch.bool, device=dev)
    cur = torch.arange(1, cap, device=dev)
    prev = torch.arange(0, cap - 1, device=dev)
    for c in sorted_keys:
        same[1:] &= keys_equal(gather_key(c, cur), gather_key(c, prev))
    same[1:] &= valid_s[1:] == valid_s[:-1]
    is_new = ~same
    is_new[0] = True
    seg = torch.cumsum(is_new.to(torch.int64), 0) - 1
    parts = []
    for arg, kind, out_nullable in zip(args, kinds, nullable):
        if arg is None:
            col_s, null_s = None, None
        else:
            col_s, null_s = split_col(_sort_col(arg, order))
        eff = signs_s if null_s is None else torch.where(
            null_s, torch.zeros_like(signs_s), signs_s)
        if kind in ("count", "count_star"):
            part = torch.zeros(cap, dtype=torch.int64, device=dev).index_add_(
                0, seg, eff.to(torch.int64))
        elif kind in ("sum", "sum0"):
            dt = _part_dtype(kind, col_s.dtype)
            payload = col_s.to(dt) if null_s is None else torch.where(
                null_s, torch.zeros((), dtype=dt, device=dev), col_s.to(dt))
            part = torch.zeros(cap, dtype=dt, device=dev).index_add_(
                0, seg, payload * eff.to(dt))
        else:
            ident = _identity(kind, col_s.dtype)
            masked = col_s if null_s is None else torch.where(
                null_s, torch.full_like(col_s, ident), col_s)
            part = torch.full((cap,), ident, dtype=col_s.dtype,
                              device=dev).scatter_reduce_(
                0, seg, masked, "amin" if kind == "min" else "amax")
        part = part[seg]
        if out_nullable:
            nn = torch.zeros(cap, dtype=torch.int64, device=dev).index_add_(
                0, seg, eff.abs().to(torch.int64))[seg]
            part = NCol(part, nn == 0)
        parts.append(part)
    return sorted_keys, parts, is_new & valid_s


class _Aggs(ctypes.Structure):
    """Mirror of ``struct RwPartialAggs`` in ``csrc/partial_agg.cu``."""

    _fields_ = [
        ("n", ctypes.c_int),
        ("kind", ctypes.c_int * MAX_AGGS),
        ("dtype", ctypes.c_int * MAX_AGGS),
        ("arg", ctypes.c_void_p * MAX_AGGS),
        ("arg_null", ctypes.c_void_p * MAX_AGGS),
        ("out", ctypes.c_void_p * MAX_AGGS),
        ("out_null", ctypes.c_void_p * MAX_AGGS),
    ]


def _sorted_col_like(col):
    """Empty output column of ``col``'s structure (the sorted keys)."""
    if isinstance(col, NCol):
        return NCol(_sorted_col_like(col.data), torch.empty_like(col.null))
    if isinstance(col, StrCol):
        return StrCol(torch.empty_like(col.data), torch.empty_like(col.lens))
    return torch.empty_like(col)


def partial_agg_cuda(key_cols: list, args: list, kinds: list[str],
                     nullable: list[bool], valid: torch.Tensor,
                     signs: torch.Tensor, order: torch.Tensor):
    """K22c: two launches over the rows in ``order`` (the stable sort's
    permutation); the same outputs as ``partial_agg_plain``."""
    if len(kinds) > MAX_AGGS:
        raise ValueError(f"K22c takes at most {MAX_AGGS} aggregates")
    cap = valid.shape[0]
    dev = valid.device
    sorted_keys = [_sorted_col_like(c) for c in key_cols]
    cols = kernels.RwCols()
    ins, outs = key_leaves(key_cols), key_leaves(sorted_keys)
    cols.n = len(ins)
    keep = []
    for k, ((d, n, kind), (sd, sn, _)) in enumerate(zip(ins, outs)):
        d = d.contiguous()
        nu8 = None if n is None else n.contiguous().view(torch.uint8)
        snu8 = None if sn is None else sn.view(torch.uint8)
        keep += [t for t in (d, nu8, sd, snu8) if t is not None]
        cols.width[k] = leaf_width(d)
        cols.kind[k] = kind
        cols.in_data[k], cols.st_data[k] = d.data_ptr(), sd.data_ptr()
        cols.in_null[k], cols.st_null[k] = kernels.ptr(nu8), kernels.ptr(snu8)
    aggs = _Aggs()
    aggs.n = len(kinds)
    parts = []
    for k, (arg, kind, out_nullable) in enumerate(zip(args, kinds, nullable)):
        data, null = (None, None) if arg is None else split_col(arg)
        if data is not None and data.dtype not in _DTYPE:
            raise NotImplementedError(f"K22c: {kind} over {data.dtype}")
        dt = torch.int64 if data is None else _part_dtype(kind, data.dtype)
        out = torch.empty(cap, dtype=dt, device=dev)
        out_null = torch.empty(cap, dtype=torch.bool, device=dev) \
            if out_nullable else None
        data = None if data is None else data.contiguous()
        nu8 = None if null is None else null.contiguous().view(torch.uint8)
        onu8 = None if out_null is None else out_null.view(torch.uint8)
        keep += [t for t in (data, nu8, out, onu8) if t is not None]
        aggs.kind[k] = _KIND[kind]
        aggs.dtype[k] = 0 if data is None else _DTYPE[data.dtype]
        aggs.arg[k], aggs.arg_null[k] = kernels.ptr(data), kernels.ptr(nu8)
        aggs.out[k], aggs.out_null[k] = out.data_ptr(), kernels.ptr(onu8)
        parts.append(out if out_null is None else NCol(out, out_null))
    order = order.contiguous()
    valid_u8 = valid.contiguous().view(torch.uint8)
    signs = signs.to(torch.int32).contiguous()
    is_new = torch.empty(cap, dtype=torch.uint8, device=dev)
    valid_out = torch.empty(cap, dtype=torch.bool, device=dev)
    kernels.require_cuda("partial_agg", order, valid_u8, signs, is_new,
                         valid_out, *keep)
    fn = kernels.entry("partial_agg", "rw_partial_agg", [
        kernels.RwCols, _Aggs, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p])
    kernels.count_launch("partial_agg")
    kernels.check(fn(cols, aggs, cap, order.data_ptr(), valid_u8.data_ptr(),
                     signs.data_ptr(), is_new.data_ptr(),
                     valid_out.view(torch.uint8).data_ptr(),
                     kernels.stream_ptr(dev)), "partial_agg")
    return sorted_keys, parts, valid_out


def partial_agg(key_cols: list, args: list, kinds: list[str],
                nullable: list[bool], valid: torch.Tensor,
                signs: torch.Tensor, order: torch.Tensor):
    """K22c on CUDA tensors, its plain version on CPU tensors."""
    if valid.device.type == "cuda":
        return partial_agg_cuda(key_cols, args, kinds, nullable, valid,
                                signs, order)
    return partial_agg_plain(key_cols, args, kinds, nullable, valid, signs,
                             order)


def sort_order(key_cols: list, valid: torch.Tensor) -> torch.Tensor:
    """The stable order of the rows by their unsigned key hash (kernel A),
    invalid rows keyed ``~0`` (last)."""
    kh = hash64_columns(key_cols)
    kh = torch.where(valid, kh, torch.full_like(kh, -1))
    return torch.sort(kh ^ INT64_MIN, stable=True).indices


class PartialAggExecutor(Executor):
    """Stateless in-chunk combine: distinct keys and signed partials."""

    emits_on_apply = True
    emits_on_flush = False

    def __init__(self, in_schema: Schema,
                 group_by: Sequence[tuple[str, Expr]],
                 aggs: Sequence[AggCall]):
        super().__init__(in_schema)
        for a in aggs:
            if a.kind not in TWO_PHASE_KINDS:
                raise ValueError(f"{a.kind} is not two-phase decomposable")
        self.group_by = tuple(group_by)
        self.aggs = tuple(aggs)
        key_fields = []
        for name, e in self.group_by:
            f = e.return_field(in_schema)
            key_fields.append(Field(name, f.data_type, str_width=f.str_width,
                                    decimal_scale=f.decimal_scale,
                                    nullable=f.nullable))
        partial_fields = []
        for a in self.aggs:
            if a.kind in ("count", "count_star"):
                # a segment of all-NULL arguments contributes 0, not NULL
                partial_fields.append(
                    Field(f"_p_{a.alias or a.kind}", DataType.INT64))
            else:
                # NULL where the segment has no non-NULL row, so that the
                # global aggregation's NULL skipping composes
                f = a.out_field(in_schema)
                partial_fields.append(Field(
                    f"_p_{f.name}", f.data_type,
                    decimal_scale=f.decimal_scale,
                    nullable=a.arg is not None
                    and a.arg.return_field(in_schema).nullable))
        self._out_schema = Schema(tuple(key_fields) + tuple(partial_fields))

    @property
    def out_schema(self) -> Schema:
        return self._out_schema

    def cuda_refusal(self) -> str | None:
        n_leaves = 0
        for _, e in self.group_by:
            f = e.return_field(self.in_schema)
            n_leaves += 2 if f.data_type.is_string else 1
        if n_leaves > kernels.MAX_COLS:
            return f"partial aggregation over more than {kernels.MAX_COLS} " \
                   "key leaves"
        if len(self.aggs) > MAX_AGGS:
            return f"partial aggregation of more than {MAX_AGGS} calls"
        for a in self.aggs:
            if a.arg is None or a.kind in ("count", "count_star"):
                continue
            t = a.arg.return_field(self.in_schema).data_type
            if t.is_string or t == DataType.BOOLEAN:
                return f"partial {a.kind} over {t.value}"
        return None

    def apply(self, state, chunk: Chunk):
        cap = chunk.capacity
        key_cols = [conform_col(e.eval(chunk),
                                e.return_field(self.in_schema).nullable, cap)
                    for _, e in self.group_by]
        args = [None if a.arg is None else a.arg.eval(chunk)
                for a in self.aggs]
        n_keys = len(self.group_by)
        nullable = [self._out_schema[n_keys + i].nullable
                    for i in range(len(self.aggs))]
        order = sort_order(key_cols, chunk.valid)
        keys, parts, valid = partial_agg(
            key_cols, args, [a.kind for a in self.aggs], nullable,
            chunk.valid, chunk.signs(), order)
        ops = torch.zeros(cap, dtype=torch.int8, device=chunk.device)
        return state, Chunk(tuple(keys) + tuple(parts), ops, valid,
                            self._out_schema)
