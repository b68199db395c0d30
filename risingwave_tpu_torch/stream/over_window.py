"""OverWindow: SQL window functions over partitions.

Port of ``risingwave_tpu/stream/over_window.py``: ``WindowFuncCall``
(:54), ``_segment_starts`` (:86) and ``OverWindowExecutor`` (:101)
``init_state``, ``apply``, ``_compute_outputs`` (:169), ``flush`` (:302)
and ``on_watermark`` (:361).

State is a ``TopNState``: the flat row pool of a group-less top-N (its
``apply`` is the pool's, K16) and the rows emitted at the last barrier in
the OUTPUT schema (the input columns, then one column per window call).
At a barrier ``flush`` sorts the whole pool lexicographically (order
keys, then the partition hash, then validity, each a stable sort),
evaluates every window call as a segment scan over the sorted pool,
takes the first ``emit_capacity`` sorted rows (dead ones included, as
the reference does), hashes each full output row and emits the multiset
difference against the last emitted rows as a ``[2 * emit_capacity]``
changelog (deletes, then inserts).  The valid rows past the emit window
raise ``overflow`` to their count (a gauge the maintenance audit reads).
Calls: row_number, rank, dense_rank, lag, lead (zero outside the
partition), sum, count, avg (float64, or a DECIMAL truncated toward
zero), min and max, the sums optionally over ``ROWS n PRECEDING``.

On the card:

- K17's key launch (``csrc/topn_band.cu``) encodes the order keys and
  hashes the partition columns; the three stable sorts stay
  ``torch.sort``;
- K20 ``over_window`` (``csrc/over_window.cu``) is ``_compute_outputs``
  and the gather and row hash of ``flush``: one grid scan of every lane
  (the segment start among them) with a decoupled look-back, then one
  thread per emitted row for its window values and hash, and its block
  moving the changelog's two halves and the new emitted rows (buffers of
  their own) plane by plane in words;
- K18's membership launch (``rw_topn_flush_diff``) diffs the hashes.

``flush_plain`` is the plain PyTorch version, used for CPU tensors.
Integer results are exact on both; float sums add in another order on
the card (equal when every partial sum is exact).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Sequence

import torch

from risingwave_tpu_torch import kernels
from risingwave_tpu_torch.common.chunk import Chunk, NCol, StrCol
from risingwave_tpu_torch.common.hash import hash64_columns, key_leaves, \
    leaf_width
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.expr.node import Expr
from risingwave_tpu_torch.stream.executor import Executor
from risingwave_tpu_torch.stream.top_n import (
    INT64_MIN,
    GroupTopNExecutor,
    TopNState,
    _cat,
    _empty_like_col,
    _gather,
    _leaves,
    _order_key,
    _stable_order,
    _uninit_like_col,
    band_keys_cuda,
    band_membership_cuda,
    band_membership_plain,
    order_keys_cuda_refusal,
    schema_protos,
)


@dataclass(frozen=True)
class WindowFuncCall:
    """One window function in the OVER clause plan."""

    kind: str            # row_number | rank | dense_rank | lag | lead |
    #                      sum | count | avg | min | max
    arg: Expr | None = None
    offset: int = 1      # lag/lead distance
    alias: str | None = None
    #: ROWS BETWEEN <pre> PRECEDING AND CURRENT ROW (sum/count/avg);
    #: None = the default frame (unbounded preceding .. current row)
    frame: "tuple[int, int] | None" = None

    def out_field(self, in_schema: Schema) -> Field:
        name = self.alias or self.kind
        if self.kind in ("row_number", "rank", "dense_rank", "count"):
            return Field(name, DataType.INT64)
        f = self.arg.return_field(in_schema)
        if self.kind == "sum" and f.data_type in (DataType.INT16,
                                                  DataType.INT32):
            return Field(name, DataType.INT64)
        if self.kind == "avg":
            if f.data_type == DataType.DECIMAL:
                return Field(name, DataType.DECIMAL,
                             decimal_scale=f.decimal_scale)
            return Field(name, DataType.FLOAT64)
        return Field(name, f.data_type, str_width=f.str_width,
                     decimal_scale=f.decimal_scale)


def _segment_starts(part_sorted: torch.Tensor, valid_sorted: torch.Tensor):
    """New-segment flags and the running segment start of every sorted
    position (invalid rows form one segment under the all-ones key)."""
    n = part_sorted.shape[0]
    key = torch.where(valid_sorted, part_sorted, torch.full_like(part_sorted,
                                                                 -1))
    is_new = torch.cat([torch.ones(1, dtype=torch.bool,
                                   device=key.device), key[1:] != key[:-1]])
    idx = torch.arange(n, dtype=torch.int64, device=key.device)
    start = torch.cummax(torch.where(is_new, idx, torch.zeros_like(idx)),
                         0).values
    return is_new, start


def _segmented_scan(v: torch.Tensor, seg_id: torch.Tensor, op):
    """Inclusive running ``op`` (torch.minimum / maximum) of ``v`` within
    the runs of equal ``seg_id`` (Hillis-Steele doubling)."""
    v = v.clone()
    n = v.shape[0]
    d = 1
    while d < n:
        same = seg_id[d:] == seg_id[:-d]
        v[d:] = torch.where(same, op(v[:-d], v[d:]), v[d:])
        d *= 2
    return v


def _sum_dtype(dt: torch.dtype) -> torch.dtype:
    return torch.int64 if not dt.is_floating_point else dt


# -- K20's entry: mirrors of the structs in csrc/over_window.cu ------------

MAX_CALLS = 16
MAX_LEAVES = kernels.MAX_COLS
MAX_LANES = MAX_CALLS + 3
_KINDS = ("row_number", "rank", "dense_rank", "lag", "lead", "sum", "count",
          "avg", "min", "max")
_TYPES = {torch.int8: 0, torch.bool: 0, torch.uint8: 0, torch.int16: 1,
          torch.int32: 2, torch.int64: 3, torch.float32: 4,
          torch.float64: 5}
T_STR = 6
(ADD_I64, ADD_F64, ADD_F32, MAX_I64, MIN_I64, MAX_F64, MIN_F64) = range(7)


class _Leaf(ctypes.Structure):
    _fields_ = [("pool", ctypes.c_void_p), ("prev", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("cur", ctypes.c_void_p),
                ("width", ctypes.c_int), ("kind", ctypes.c_int)]


class _Call(ctypes.Structure):
    _fields_ = [("kind", ctypes.c_int), ("arg_type", ctypes.c_int),
                ("arg_width", ctypes.c_int), ("out_type", ctypes.c_int),
                ("out_width", ctypes.c_int), ("offset", ctypes.c_int),
                ("pre", ctypes.c_int), ("lane", ctypes.c_int),
                ("decimal_avg", ctypes.c_int),
                ("arg", ctypes.c_void_p), ("arg_lens", ctypes.c_void_p),
                ("prev", ctypes.c_void_p), ("prev_lens", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("out_lens", ctypes.c_void_p),
                ("cur", ctypes.c_void_p), ("cur_lens", ctypes.c_void_p)]


class _OverWindowArgs(ctypes.Structure):
    """Mirror of ``struct OverWindowArgs`` in ``csrc/over_window.cu``."""

    _fields_ = [
        ("order", ctypes.c_void_p), ("valid", ctypes.c_void_p),
        ("part", ctypes.c_void_p), ("okeys", ctypes.c_void_p),
        ("n_order", ctypes.c_int),
        ("n_leaves", ctypes.c_int), ("leaf", _Leaf * MAX_LEAVES),
        ("n_calls", ctypes.c_int), ("call", _Call * MAX_CALLS),
        ("n_lanes", ctypes.c_int),
        ("lane_op", ctypes.c_int * MAX_LANES),
        ("lane_flagged", ctypes.c_int * MAX_LANES),
        ("start_lane", ctypes.c_int), ("anchor_lane", ctypes.c_int),
        ("dense_lane", ctypes.c_int),
        ("lane_val", ctypes.c_void_p), ("status", ctypes.c_void_p),
        ("tile_agg", ctypes.c_void_p), ("tile_incl", ctypes.c_void_p),
        ("ctl", ctypes.c_void_p), ("epoch", ctypes.c_ulonglong),
        ("cur_hash", ctypes.c_void_p), ("cur_live", ctypes.c_void_p),
        ("overflow", ctypes.c_void_p),
        ("S", ctypes.c_int), ("E", ctypes.c_int), ("P", ctypes.c_int),
        ("n_tiles", ctypes.c_int),
    ]


#: positions a tile of K20's scan (``OT`` in ``csrc/over_window.cu``)
SCAN_TILE = 512
#: epochs a status word can tag (``epoch << 34`` in a 64-bit word)
_SCAN_EPOCHS = 1 << 30
#: (device, stream) -> K20's look-back scratch (``kernels.lookback_scratch``)
#: for up to p tiles: status words int64 [p], tile lanes int64 [2, p,
#: MAX_LANES] (totals, inclusive) and the two tickets int32 [2]
_SCAN_SCRATCH: dict = {}


def _scan_tensors(p: int, dev: torch.device) -> tuple:
    return (torch.zeros(p, dtype=torch.int64, device=dev),
            torch.empty((2, p, MAX_LANES), dtype=torch.int64, device=dev),
            torch.zeros(2, dtype=torch.int32, device=dev))


class OverWindowExecutor(Executor):
    """Append window-function columns; emits a changelog at barriers."""

    emits_on_apply = False
    emits_on_flush = True

    def __init__(
        self,
        in_schema: Schema,
        partition_by: Sequence[Expr],
        order_by: Sequence[tuple[Expr, bool]],
        calls: Sequence[WindowFuncCall],
        pool_size: int = 4096,
        emit_capacity: int = 1024,
        watermark_col_idx: int | None = None,
        watermark_lag: int = 0,
    ):
        super().__init__(in_schema)
        self.partition_by = tuple(partition_by)
        self.order_by = tuple(order_by)
        self.calls = tuple(calls)
        self.pool_size = pool_size
        self.emit_capacity = emit_capacity
        self.watermark_col_idx = watermark_col_idx
        self.watermark_lag = watermark_lag
        self._out_schema = Schema(
            tuple(in_schema) + tuple(c.out_field(in_schema)
                                     for c in self.calls))
        # the group-less top-N's pool apply (insert/delete into the pool)
        self._pool = GroupTopNExecutor(
            in_schema, group_by=[], order_by=[], limit=1,
            pool_size=pool_size, emit_capacity=emit_capacity)

    @property
    def out_schema(self) -> Schema:
        return self._out_schema

    def init_state(self, device) -> TopNState:
        st = self._pool.init_state(device)
        E = self.emit_capacity
        return st._replace(prev_rows=tuple(
            _empty_like_col(p, E)
            for p in schema_protos(self._out_schema, device)))

    def apply(self, state: TopNState, chunk: Chunk):
        self._pool.apply(state, chunk)
        return state, None

    def cuda_refusal(self) -> str | None:
        """Why the card's kernels cannot run this over-window, or None."""
        why = self._pool.cuda_refusal() or order_keys_cuda_refusal(
            self.order_by, self.in_schema)
        if why is not None:
            return why
        if len(self.calls) > MAX_CALLS:
            return f"more than {MAX_CALLS} window calls (K20)"
        return None

    # ------------------------------------------------------------------
    def _pool_chunk(self, state: TopNState) -> Chunk:
        return Chunk(state.rows,
                     torch.zeros(self.pool_size, dtype=torch.int8,
                                 device=state.valid.device),
                     state.valid, self.in_schema)

    def _is_decimal_avg(self, call: WindowFuncCall) -> bool:
        return call.kind == "avg" and call.arg.return_field(
            self.in_schema).data_type == DataType.DECIMAL

    def _compute_outputs(self, state: TopNState):
        """Plain version: sort the pool and evaluate every window call per
        sorted position.  Returns (order [S], valid_sorted, per-call output
        columns in sorted order)."""
        S = self.pool_size
        dev = state.valid.device
        pool_chunk = self._pool_chunk(state)
        order = torch.arange(S, dtype=torch.int64, device=dev)
        okeys = [_order_key(e.eval(pool_chunk), desc)
                 for e, desc in self.order_by]
        for k in reversed(okeys):
            order = _stable_order(order, k ^ INT64_MIN)
        part = hash64_columns([e.eval(pool_chunk)
                               for e in self.partition_by]) \
            if self.partition_by else torch.zeros(S, dtype=torch.int64,
                                                  device=dev)
        order = _stable_order(order, part ^ INT64_MIN)
        order = _stable_order(order, (~state.valid).to(torch.uint8))

        valid_s = state.valid[order]
        part_s = torch.where(valid_s, part[order], torch.full_like(part, -1))
        is_new, seg_start = _segment_starts(part_s, valid_s)
        idx = torch.arange(S, dtype=torch.int64, device=dev)
        tie_key = torch.zeros(S, dtype=torch.int64, device=dev)
        for k in okeys:
            tie_key = tie_key * 1000003 ^ k[order]
        new_val = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                             tie_key[1:] != tie_key[:-1]]) | is_new

        outs = []
        for call in self.calls:
            if call.kind == "row_number":
                outs.append(idx - seg_start + 1)
            elif call.kind == "rank":
                anchor = torch.cummax(torch.where(new_val, idx,
                                                  torch.zeros_like(idx)),
                                      0).values
                outs.append(anchor - seg_start + 1)
            elif call.kind == "dense_rank":
                snv = torch.cumsum(new_val.to(torch.int64), 0)
                start_cum = torch.cummax(
                    torch.where(is_new, snv - 1, torch.zeros_like(snv)),
                    0).values
                outs.append(snv - start_cum)
            elif call.kind in ("lag", "lead"):
                col_s = _gather(_plain_col(call.arg.eval(pool_chunk)), order)
                shift = call.offset if call.kind == "lag" else -call.offset
                src = idx - shift
                in_range = (src >= 0) & (src < S)
                src_c = torch.clamp(src, 0, S - 1)
                same = in_range & (part_s[src_c] == part_s)
                if isinstance(col_s, StrCol):
                    outs.append(StrCol(
                        torch.where(same[:, None], col_s.data[src_c],
                                    torch.zeros_like(col_s.data)),
                        torch.where(same, col_s.lens[src_c],
                                    torch.zeros_like(col_s.lens))))
                else:
                    outs.append(torch.where(same, col_s[src_c],
                                            torch.zeros_like(col_s)))
            elif call.kind in ("sum", "count", "avg"):
                if call.kind == "count":
                    v = valid_s.to(torch.int64)
                else:
                    v = _plain_col(call.arg.eval(pool_chunk))[order]
                    v = v.to(_sum_dtype(v.dtype))
                decimal = self._is_decimal_avg(call)
                if call.kind == "avg" and not decimal:
                    v = v.to(torch.float64)
                cum = torch.cumsum(v, 0)
                before = cum - v
                pre = call.frame[0] if call.frame is not None else -1
                lo = torch.maximum(idx - pre, seg_start) if pre >= 0 \
                    else seg_start
                frame_n = idx - lo + 1
                agg = cum - before[lo]
                if call.kind == "avg":
                    if decimal:
                        agg = torch.sign(agg) * torch.div(
                            agg.abs(), frame_n, rounding_mode="floor")
                    else:
                        agg = agg / frame_n.to(torch.float64)
                outs.append(agg)
            elif call.kind in ("min", "max"):
                v = _plain_col(call.arg.eval(pool_chunk))[order]
                op = torch.minimum if call.kind == "min" else torch.maximum
                seg_id = torch.cumsum(is_new.to(torch.int64), 0)
                outs.append(_segmented_scan(v, seg_id, op))
            else:
                raise ValueError(f"unknown window fn {call.kind!r}")
        return order, valid_s, outs

    def flush_plain(self, state: TopNState):
        """Plain PyTorch version of the flush: (out columns [2E], out
        valid [2E], cur_rows, cur_live, cur_hash, n_beyond)."""
        S, E = self.pool_size, self.emit_capacity
        order, valid_s, outs = self._compute_outputs(state)
        # the first E sorted rows (the reference clamps past the pool)
        take = torch.clamp(torch.arange(E, device=order.device), max=S - 1)
        cur_rows = tuple(_gather(c, order[take]) for c in state.rows) + \
            tuple(_gather(c, take) for c in outs)
        cur_live = valid_s[take]
        h = hash64_columns(list(cur_rows))
        cur_hash = torch.where(cur_live, h, torch.zeros_like(h))
        n_beyond = valid_s[E:].sum(dtype=torch.int64) if S > E \
            else torch.zeros((), dtype=torch.int64, device=order.device)
        out_valid = band_membership_plain(state.prev_hash, state.prev_valid,
                                          cur_hash, cur_live)
        out_cols = tuple(_cat(p, c) for p, c in zip(state.prev_rows,
                                                    cur_rows))
        return out_cols, out_valid, cur_rows, cur_live, cur_hash, n_beyond

    def sorted_order_cuda(self, state: TopNState):
        """K17's key launch and the stable sort chain: (order [S], the
        sortable order keys [n, S], the partition hash [S])."""
        S = self.pool_size
        dev = state.valid.device
        pool_chunk = self._pool_chunk(state)
        keys, part = band_keys_cuda(
            [e.eval(pool_chunk) for e, _ in self.order_by],
            [d for _, d in self.order_by],
            [e.eval(pool_chunk) for e in self.partition_by], S, dev)
        order = torch.arange(S, dtype=torch.int64, device=dev)
        for j in range(keys.shape[0] - 1, -1, -1):
            order = _stable_order(order, keys[j])
        order = _stable_order(order, part ^ INT64_MIN)
        order = _stable_order(order, 1 - state.valid.view(torch.uint8))
        return order, keys.contiguous(), part

    def flush_cuda(self, state: TopNState):
        """K17's keys and the sort chain, K20, then K18's membership; the
        overflow gauge is raised on the card."""
        out_cols, cur_cols, cur_live, cur_hash = self.window_rows_cuda(
            state, *self.sorted_order_cuda(state))
        out_valid = band_membership_cuda(state.prev_hash, state.prev_valid,
                                         cur_hash, cur_live)
        return out_cols, out_valid, cur_cols, cur_live, cur_hash

    def window_rows_cuda(self, state: TopNState, order, keys, part):
        """K20 (``csrc/over_window.cu``) over the sorted pool: (out
        columns [2E] without their validity, the new emitted rows, their
        liveness and hashes)."""
        S, E = self.pool_size, self.emit_capacity
        dev = state.valid.device
        pool_chunk = self._pool_chunk(state)
        valid_u8 = state.valid.view(torch.uint8)
        a = _OverWindowArgs()
        keep = [order, valid_u8, part, keys]
        a.order, a.valid = order.data_ptr(), valid_u8.data_ptr()
        a.part, a.okeys = part.data_ptr(), keys.data_ptr()
        a.n_order = len(self.order_by)
        # the input leaves: pool -> out chunk and the new emitted rows
        out_cols, cur_cols = [], []
        n_in = len(state.rows)
        kinds = [kind for _, _, kind in key_leaves(state.rows)]
        if len(kinds) > MAX_LEAVES:
            raise ValueError(f"more than {MAX_LEAVES} pool leaves")
        n = 0
        for pc, vc in zip(state.rows, state.prev_rows[:n_in]):
            oc, cc = _uninit_like_col(pc, 2 * E), _uninit_like_col(pc, E)
            out_cols.append(oc)
            cur_cols.append(cc)
            for p, v, o, c in zip(_leaves(pc), _leaves(vc), _leaves(oc),
                                  _leaves(cc)):
                leaf = a.leaf[n]
                leaf.pool, leaf.prev = p.data_ptr(), v.data_ptr()
                leaf.out, leaf.cur = o.data_ptr(), c.data_ptr()
                leaf.width, leaf.kind = leaf_width(p), kinds[n]
                keep += [p, v, o, c]
                n += 1
        a.n_leaves = n
        if len(self.calls) > MAX_CALLS:
            raise ValueError(f"more than {MAX_CALLS} window calls")
        lanes: list[tuple[int, int]] = []     # (op, flagged)

        def lane(op: int, flagged: int) -> int:
            lanes.append((op, flagged))
            return len(lanes) - 1

        used = {c.kind for c in self.calls}
        a.start_lane = lane(MAX_I64, 0)
        a.anchor_lane = lane(MAX_I64, 0) if "rank" in used else -1
        a.dense_lane = lane(ADD_I64, 1) if "dense_rank" in used else -1
        a.n_calls = len(self.calls)
        for j, call in enumerate(self.calls):
            c = a.call[j]
            c.kind = _KINDS.index(call.kind)
            c.lane = -1
            c.pre = call.frame[0] if call.frame is not None \
                and call.frame[0] >= 0 else -1
            c.offset = call.offset
            c.decimal_avg = int(self._is_decimal_avg(call))
            arg = None
            if call.arg is not None:
                arg = _plain_col(call.arg.eval(pool_chunk))
                if isinstance(arg, StrCol):
                    if call.kind not in ("lag", "lead"):
                        raise NotImplementedError(
                            f"{call.kind} over strings")
                    c.arg_type, c.arg_width = T_STR, arg.data.shape[1]
                    arg = StrCol(arg.data.contiguous(),
                                 arg.lens.contiguous())
                    c.arg, c.arg_lens = arg.data.data_ptr(), \
                        arg.lens.data_ptr()
                    keep += [arg.data, arg.lens]
                else:
                    arg = arg.contiguous()
                    c.arg_type, c.arg_width = _TYPES[arg.dtype], \
                        arg.element_size()
                    c.arg = arg.data_ptr()
                    keep.append(arg)
            prev = state.prev_rows[n_in + j]
            oc, cc = _uninit_like_col(prev, 2 * E), _uninit_like_col(prev, E)
            out_cols.append(oc)
            cur_cols.append(cc)
            if isinstance(prev, StrCol):
                c.out_type, c.out_width = T_STR, prev.data.shape[1]
                c.prev, c.prev_lens = prev.data.data_ptr(), \
                    prev.lens.data_ptr()
                c.out, c.out_lens = oc.data.data_ptr(), oc.lens.data_ptr()
                c.cur, c.cur_lens = cc.data.data_ptr(), cc.lens.data_ptr()
                keep += [prev.data, prev.lens, oc.data, oc.lens, cc.data,
                         cc.lens]
            else:
                c.out_type, c.out_width = _TYPES[prev.dtype], \
                    prev.element_size()
                c.prev, c.out, c.cur = prev.data_ptr(), oc.data_ptr(), \
                    cc.data_ptr()
                keep += [prev, oc, cc]
            if call.kind == "count":
                c.lane = lane(ADD_I64, 1)
            elif call.kind in ("sum", "avg"):
                dt = arg.dtype
                if call.kind == "avg" and not c.decimal_avg:
                    op = ADD_F64
                else:
                    op = {torch.float64: ADD_F64,
                          torch.float32: ADD_F32}.get(dt, ADD_I64)
                if dt == torch.bool:
                    raise NotImplementedError(f"{call.kind} over booleans")
                c.lane = lane(op, 1)
            elif call.kind in ("min", "max"):
                fl = arg.dtype.is_floating_point
                op = {("min", False): MIN_I64, ("max", False): MAX_I64,
                      ("min", True): MIN_F64, ("max", True): MAX_F64}[
                          (call.kind, fl)]
                c.lane = lane(op, 1)
        a.n_lanes = len(lanes)
        for j, (op, flagged) in enumerate(lanes):
            a.lane_op[j], a.lane_flagged[j] = op, flagged

        P = min(E, S)
        n_tiles = (P + SCAN_TILE - 1) // SCAN_TILE
        (status, tile_lanes, ctl), a.epoch = kernels.lookback_scratch(
            _SCAN_SCRATCH, dev, n_tiles, _SCAN_EPOCHS, _scan_tensors)
        i64 = dict(dtype=torch.int64, device=dev)
        lane_val = torch.empty((len(lanes), P), **i64)
        cur_hash = torch.empty(E, **i64)
        cur_live = torch.empty(E, dtype=torch.bool, device=dev)
        keep += [lane_val, status, tile_lanes, ctl, cur_hash, cur_live,
                 state.overflow]
        a.lane_val, a.status = lane_val.data_ptr(), status.data_ptr()
        a.tile_agg, a.tile_incl = tile_lanes[0].data_ptr(), \
            tile_lanes[1].data_ptr()
        a.ctl = ctl.data_ptr()
        a.cur_hash, a.cur_live = cur_hash.data_ptr(), cur_live.data_ptr()
        a.overflow = state.overflow.data_ptr()
        a.S, a.E, a.P, a.n_tiles = S, E, P, n_tiles
        kernels.require_cuda("over_window", *keep)
        fn = kernels.entry("over_window", "rw_over_window",
                           [_OverWindowArgs, ctypes.c_void_p])
        kernels.count_launch("over_window")
        kernels.check(fn(a, kernels.stream_ptr(dev)), "over_window")
        return tuple(out_cols), tuple(cur_cols), cur_live, cur_hash

    def _ops_for(self, device) -> torch.Tensor:
        return self._pool._ops_for(device)

    def flush(self, state: TopNState, epoch):
        if state.valid.device.type == "cuda":
            out_cols, out_valid, cur_rows, cur_live, cur_hash = \
                self.flush_cuda(state)
        else:
            out_cols, out_valid, cur_rows, cur_live, cur_hash, n_beyond = \
                self.flush_plain(state)
            # gauge: the valid rows past the emit window
            torch.maximum(state.overflow, n_beyond, out=state.overflow)
        out = Chunk(out_cols, self._ops_for(state.valid.device), out_valid,
                    self._out_schema)
        return state._replace(prev_rows=cur_rows, prev_valid=cur_live,
                              prev_hash=cur_hash), out

    def on_watermark(self, state: TopNState, watermark):
        if self.watermark_col_idx is None:
            return state
        return self._pool.clean_below(state, self.watermark_col_idx,
                                      watermark.value - self.watermark_lag)


def _plain_col(col):
    if isinstance(col, NCol):
        raise NotImplementedError(
            "window functions over nullable columns are not ported yet")
    return col
