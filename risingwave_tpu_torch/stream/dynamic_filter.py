"""DynamicFilterExecutor: filter a stream against a changing scalar.

Port of ``risingwave_tpu/stream/dynamic_filter.py``: ``DynFilterState``,
``init_state``, ``_apply_left`` (:92), ``_apply_right`` (:106) and
``apply`` (:153), with the five comparisons (gt, ge, lt, le, eq).  It is
the band join behind ``HAVING COUNT(*) >= (SELECT ...)`` (Nexmark q102):
the left stream is filtered by a comparison whose right side is a 1-row
changelog (a global aggregate).  When the scalar moves, the rows between
the old and the new threshold are emitted (threshold dropped: inserts)
or retracted (threshold rose: deletes).

The left rows live in a flat row pool, the group top-N's (K16,
``top_n.pool_apply``); a threshold change emits the whole flipped band
as one chunk of pool capacity whose rows are the pool's own stores.  The
threshold and ``has_threshold`` stay on the device: no host read per
chunk or barrier.  On the card both sides run kernel K21
(``csrc/dyn_filter.cu``): ``pass_mask_cuda`` (the left side's
pass-through mask after K16) and ``band_cuda`` (the right side: the new
threshold from the chunk's last visible insert-side row, then the band
over the pool); ``pass_mask_plain`` and ``band_plain`` are their plain
versions.  Filter columns of int64 (also NUMERIC and TIMESTAMP), int32
and float64 run; floats compare with subnormals as zero, as the
reference's compares run with denormals-are-zero.  State is updated in
place.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from risingwave_tpu_torch import kernels
from risingwave_tpu_torch.common.chunk import (
    OP_DELETE,
    OP_INSERT,
    OP_UPDATE_INSERT,
    Chunk,
)
from risingwave_tpu_torch.common.hash import daz
from risingwave_tpu_torch.common.types import Schema
from risingwave_tpu_torch.stream.top_n import (
    _empty_like_col,
    pool_apply,
    schema_leaf_count,
    schema_protos,
)

_CMPS = {
    "gt": lambda v, t: v > t,
    "ge": lambda v, t: v >= t,
    "lt": lambda v, t: v < t,
    "le": lambda v, t: v <= t,
    "eq": lambda v, t: v == t,
}
#: comparison and dtype codes of ``csrc/dyn_filter.cu``
_CMP_CODES = {"gt": 0, "ge": 1, "lt": 2, "le": 3, "eq": 4}
_DTYPE_CODES = {torch.int64: 0, torch.int32: 1, torch.float64: 2}


class DynFilterState(NamedTuple):
    rows: tuple                  # [pool] column stores (the left rows)
    valid: torch.Tensor          # bool [pool]
    row_hash: torch.Tensor       # int64 [pool] (uint64 bits)
    threshold: torch.Tensor      # the current scalar, the filter's dtype
    has_threshold: torch.Tensor  # bool: the scalar was seen and not emptied
    overflow: torch.Tensor       # int64: left rows the pool could not hold
    inconsistency: torch.Tensor  # int64: left deletes of absent rows


def _compare(cmp: str, v: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    if v.dtype.is_floating_point:
        v, t = daz(v), daz(t)
    return _CMPS[cmp](v, t)


def pass_mask_plain(v, valid, threshold, has_threshold, cmp: str):
    """Plain PyTorch version of K21's left pass: the chunk rows that clear
    the current threshold."""
    return valid & _compare(cmp, v, threshold) & has_threshold


def band_plain(v, pool_valid, rhs, rhs_ops, rhs_valid, threshold,
               has_threshold, cmp: str):
    """Plain PyTorch version of K21's right pass, in place on
    ``threshold`` and ``has_threshold``: the new scalar is the right
    chunk's last visible insert-side row; a chunk of deletes alone
    empties it.  Returns the band's (ops int8 [pool], valid bool
    [pool])."""
    ins_like = (rhs_ops == OP_INSERT) | (rhs_ops == OP_UPDATE_INSERT)
    ins = rhs_valid & ins_like
    dels = rhs_valid & ~ins_like
    idx = torch.arange(ins.shape[0], dtype=torch.int64, device=ins.device)
    last = torch.where(ins, idx, torch.full_like(idx, -1)).max() \
        if ins.shape[0] else torch.tensor(-1, device=ins.device)
    has_new = last >= 0
    emptied = dels.any() & ~has_new
    new_thr = torch.where(
        has_new, rhs[torch.clamp(last, min=0)].to(threshold.dtype),
        threshold)
    new_has = (has_threshold | has_new) & ~emptied
    was = _compare(cmp, v, threshold) & has_threshold
    now = _compare(cmp, v, new_thr) & new_has
    emit_ins = pool_valid & now & ~was
    emit_del = pool_valid & was & ~now
    ops = torch.where(emit_ins, OP_INSERT, OP_DELETE).to(torch.int8)
    threshold.copy_(new_thr)
    has_threshold.copy_(new_has)
    return ops, emit_ins | emit_del


class _DynArgs(ctypes.Structure):
    """Mirror of ``struct DynFilterArgs`` in ``csrc/dyn_filter.cu``."""

    _fields_ = [
        ("value", ctypes.c_void_p), ("valid", ctypes.c_void_p),
        ("thr", ctypes.c_void_p), ("has", ctypes.c_void_p),
        ("out_valid", ctypes.c_void_p), ("out_ops", ctypes.c_void_p),
        ("rhs", ctypes.c_void_p), ("rhs_ops", ctypes.c_void_p),
        ("rhs_valid", ctypes.c_void_p), ("old_thr", ctypes.c_void_p),
        ("old_has", ctypes.c_void_p),
        ("dtype", ctypes.c_int), ("cmp", ctypes.c_int),
        ("n", ctypes.c_int), ("m", ctypes.c_int),
    ]


def _dyn_args(v, valid, threshold, has_threshold, cmp: str):
    if v.dtype not in _DTYPE_CODES or threshold.dtype != v.dtype:
        raise ValueError(f"dyn_filter: a {v.dtype} column against a "
                         f"{threshold.dtype} threshold")
    a = _DynArgs()
    v = v.contiguous()
    valid_u8 = valid.contiguous().view(torch.uint8)
    has_u8 = has_threshold.view(torch.uint8)
    out = torch.empty(v.shape[0], dtype=torch.uint8, device=v.device)
    a.value, a.valid = v.data_ptr(), valid_u8.data_ptr()
    a.thr, a.has = threshold.data_ptr(), has_u8.data_ptr()
    a.out_valid = out.data_ptr()
    a.dtype, a.cmp, a.n = _DTYPE_CODES[v.dtype], _CMP_CODES[cmp], v.shape[0]
    return a, [v, valid_u8, has_u8, threshold, out], out


def pass_mask_cuda(v, valid, threshold, has_threshold, cmp: str):
    """K21's left pass (``rw_dyn_filter_left``): one grid launch."""
    a, keep, out = _dyn_args(v, valid, threshold, has_threshold, cmp)
    kernels.require_cuda("dyn_filter", *keep)
    fn = kernels.entry("dyn_filter", "rw_dyn_filter_left",
                       [_DynArgs, ctypes.c_void_p])
    kernels.count_launch("dyn_filter")
    kernels.check(fn(a, kernels.stream_ptr(v.device)), "dyn_filter")
    return out.view(torch.bool)


def band_cuda(v, pool_valid, rhs, rhs_ops, rhs_valid, threshold,
              has_threshold, cmp: str):
    """K21's right pass (``rw_dyn_filter_right``): one block for the new
    scalar, then one grid launch over the pool; in place."""
    a, keep, out = _dyn_args(v, pool_valid, threshold, has_threshold, cmp)
    if rhs.dtype != v.dtype:
        raise ValueError(f"dyn_filter: a {rhs.dtype} scalar against a "
                         f"{v.dtype} column")
    dev = v.device
    rhs = rhs.contiguous()
    rops = rhs_ops.contiguous()
    rvalid = rhs_valid.contiguous().view(torch.uint8)
    ops = torch.empty(v.shape[0], dtype=torch.int8, device=dev)
    old = torch.empty(2, dtype=torch.int64, device=dev)
    kernels.require_cuda("dyn_filter", rhs, rops, rvalid, ops, old, *keep)
    a.out_ops = ops.data_ptr()
    a.rhs, a.rhs_ops, a.rhs_valid = (rhs.data_ptr(), rops.data_ptr(),
                                     rvalid.data_ptr())
    a.old_thr, a.old_has = old.data_ptr(), old[1:].data_ptr()
    a.m = rhs.shape[0]
    fn = kernels.entry("dyn_filter", "rw_dyn_filter_right",
                       [_DynArgs, ctypes.c_void_p])
    kernels.count_launch("dyn_filter")
    kernels.check(fn(a, kernels.stream_ptr(dev)), "dyn_filter")
    return ops, out.view(torch.bool)


class DynamicFilterExecutor:
    """Two-input executor: ``apply(state, chunk, side)`` like a join.

    ``filter_col`` indexes the left schema; the right chunk's column 0
    carries the scalar (its last visible insert-side row wins, as the
    reference expects of a 1-row changelog)."""

    def __init__(self, left_schema: Schema, filter_col: int,
                 cmp: str = "gt", pool_size: int = 4096):
        if cmp not in _CMPS:
            raise ValueError(f"cmp must be one of {sorted(_CMPS)}")
        self.filter_field = left_schema[filter_col]
        if self.filter_field.data_type.is_string:
            raise ValueError(
                "dynamic filter on string columns is not supported")
        self.left_schema = left_schema
        self.filter_col = filter_col
        self.cmp = cmp
        self.pool_size = pool_size

    @property
    def out_schema(self) -> Schema:
        return self.left_schema

    def init_state(self, device) -> DynFilterState:
        S = self.pool_size
        z64 = dict(dtype=torch.int64, device=device)
        return DynFilterState(
            rows=tuple(_empty_like_col(p, S)
                       for p in schema_protos(self.left_schema, device)),
            valid=torch.zeros(S, dtype=torch.bool, device=device),
            row_hash=torch.zeros(S, **z64),
            threshold=torch.zeros(
                (), dtype=self.filter_field.data_type.physical_dtype,
                device=device),
            has_threshold=torch.zeros((), dtype=torch.bool, device=device),
            overflow=torch.zeros((), **z64),
            inconsistency=torch.zeros((), **z64),
        )

    def cuda_refusal(self) -> str | None:
        """Why K16 and K21 cannot run this filter on the card, or None."""
        dt = self.filter_field.data_type.physical_dtype
        if dt not in _DTYPE_CODES:
            return (f"a dynamic filter on a {dt} column is not ported to "
                    "its kernel (K21)")
        n = schema_leaf_count(self.left_schema)
        if n > kernels.MAX_COLS:
            return (f"a dynamic filter's row of {n} column leaves (K16 "
                    f"takes {kernels.MAX_COLS})")
        return None

    # -- left: data rows -------------------------------------------------
    def _apply_left(self, state: DynFilterState, chunk: Chunk):
        pool_apply(state.rows, state.valid, state.row_hash, chunk,
                   self.pool_size, state.overflow, state.inconsistency)
        impl = pass_mask_cuda if chunk.device.type == "cuda" \
            else pass_mask_plain
        passing = impl(chunk.column(self.filter_col), chunk.valid,
                       state.threshold, state.has_threshold, self.cmp)
        return state, chunk.with_valid(passing)

    # -- right: the scalar changelog -------------------------------------
    def _apply_right(self, state: DynFilterState, chunk: Chunk):
        # the RHS scalar's logical type must match the filter column's
        # (DECIMAL scales and int/float semantics differ on device)
        rf = chunk.schema[0]
        lf = self.filter_field
        if rf.data_type != lf.data_type or (
                rf.data_type.value == "numeric"
                and rf.decimal_scale != lf.decimal_scale):
            raise ValueError(
                f"dynamic filter RHS type {rf.data_type} does not match "
                f"filter column type {lf.data_type}")
        impl = band_cuda if chunk.device.type == "cuda" else band_plain
        ops, emit = impl(state.rows[self.filter_col], state.valid,
                         chunk.column(0), chunk.ops, chunk.valid,
                         state.threshold, state.has_threshold, self.cmp)
        return state, Chunk(state.rows, ops, emit, self.left_schema)

    def apply(self, state: DynFilterState, chunk: Chunk, side: str):
        if side == "left":
            return self._apply_left(state, chunk)
        return self._apply_right(state, chunk)
