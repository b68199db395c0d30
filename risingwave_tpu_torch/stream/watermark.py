"""Watermark generation and the EOWC sort.

Port of ``risingwave_tpu/stream/watermark.py``:

- ``WatermarkFilterExecutor`` (:38-80): track the highest event time
  seen (a device scalar), drop rows later than the current watermark
  ``max_ts - delay``, count them.  The fragment turns the scalar into a
  ``Watermark`` at each barrier without reading it back to the host.
- ``EowcSortExecutor`` (:82-180, the reference's ``eowc/sort.rs``):
  buffer an append-only stream in a pool and emit its rows in timestamp
  order once the watermark passes them.  ``apply`` claims the pool's
  free slots by rank: the free slots in ascending order are K7's
  compaction of the free mask (``mask_indices``), and the rows scatter
  into them; ``flush`` stable-sorts the closed rows by timestamp
  (``torch.sort``, as K17, K18 and K20's callers do) and gathers the
  first ``emit_capacity``.  It needs no kernel of its own.  No planner
  builds it (the reference's neither).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from risingwave_tpu_torch.common.chunk import Chunk
from risingwave_tpu_torch.common.compact import mask_indices
from risingwave_tpu_torch.common.types import Schema
from risingwave_tpu_torch.stream.executor import Executor
from risingwave_tpu_torch.stream.materialize import empty_value_col
from risingwave_tpu_torch.stream.message import Watermark
from risingwave_tpu_torch.stream.top_n import _gather, _scatter_

INT64_MIN = -(1 << 63)
INT64_MAX = (1 << 63) - 1


class WmState(NamedTuple):
    max_ts: torch.Tensor     # int64 scalar — highest event time seen
    late_rows: torch.Tensor  # int64 scalar — rows dropped as late


class WatermarkFilterExecutor(Executor):
    """WATERMARK FOR ts AS ts - INTERVAL ``delay_us``."""

    def __init__(self, in_schema: Schema, ts_col: int, delay_us: int):
        super().__init__(in_schema)
        self.ts_col = ts_col
        self.delay_us = delay_us

    def init_state(self, device) -> WmState:
        return WmState(
            max_ts=torch.full((), INT64_MIN, dtype=torch.int64, device=device),
            late_rows=torch.zeros((), dtype=torch.int64, device=device),
        )

    def apply(self, state: WmState, chunk: Chunk):
        ts = chunk.column(self.ts_col)
        no_wm = state.max_ts == INT64_MIN
        # guard the initial state: INT64_MIN - delay would wrap positive
        wm = torch.where(no_wm, state.max_ts, state.max_ts - self.delay_us)
        late = chunk.valid & (ts < wm)
        floor = torch.full_like(ts, INT64_MIN)
        new_max = torch.maximum(state.max_ts,
                                torch.where(chunk.valid, ts, floor).max())
        return WmState(
            max_ts=new_max,
            late_rows=state.late_rows + late.sum(dtype=torch.int64),
        ), chunk.mask(~late)


class EowcSortState(NamedTuple):
    rows: tuple              # the pool's [S] stores, one per column
    valid: torch.Tensor      # bool [S]
    wm: torch.Tensor         # int64 scalar — latest watermark received
    overflow: torch.Tensor   # int64 scalar — rows dropped with the pool full


class EowcSortExecutor(Executor):
    """Buffer rows; emit them in timestamp order once the watermark
    passes them (an out-of-order append-only stream becomes an in-order
    one)."""

    emits_on_apply = False
    emits_on_flush = True
    #: emits what a watermark closes (the barrier drains after it)
    emit_on_window_close = True

    def __init__(self, in_schema: Schema, ts_col: int,
                 pool_size: int = 8192, emit_capacity: int = 4096):
        super().__init__(in_schema)
        self.ts_col = ts_col
        self.pool_size = pool_size
        self.emit_capacity = emit_capacity

    def init_state(self, device) -> EowcSortState:
        S = self.pool_size
        return EowcSortState(
            rows=tuple(empty_value_col(f, S, device)
                       for f in self.in_schema),
            valid=torch.zeros(S, dtype=torch.bool, device=device),
            wm=torch.full((), INT64_MIN, dtype=torch.int64, device=device),
            overflow=torch.zeros((), dtype=torch.int64, device=device))

    def apply(self, state: EowcSortState, chunk: Chunk):
        """In place: the chunk's valid rows, in order, claim the pool's
        free slots in ascending order; rows past the free slots count
        into ``overflow``."""
        S = self.pool_size
        is_ins = chunk.valid  # append-only input
        free_slots = mask_indices(~state.valid, S, S)
        ins32 = is_ins.to(torch.int32)
        ins_rank = torch.cumsum(ins32, 0, dtype=torch.int32) - ins32
        tgt = free_slots[torch.clamp(ins_rank, max=S - 1).to(torch.int64)]
        got = is_ins & (ins_rank < S) & (tgt < S)
        tgt = torch.where(got, tgt, torch.full_like(tgt, S))
        state.valid[tgt[got].to(torch.int64)] = True
        for store, col in zip(state.rows, chunk.columns):
            _scatter_(store, tgt, col)
        state.overflow.add_((is_ins & ~got).sum(dtype=torch.int64))
        return state, None

    def on_watermark(self, state: EowcSortState, watermark: Watermark):
        if watermark.col_idx != self.ts_col:
            return state
        return state._replace(wm=torch.maximum(state.wm, torch.as_tensor(
            watermark.value, dtype=torch.int64, device=state.wm.device)))

    def flush(self, state: EowcSortState, epoch):
        """The first ``emit_capacity`` closed rows (timestamp below the
        watermark) in stable timestamp order, as Insert rows; they leave
        the pool."""
        S, E = self.pool_size, self.emit_capacity
        ts = state.rows[self.ts_col]
        closed = state.valid & (ts < state.wm)
        sort_key = torch.where(closed, ts, torch.full_like(ts, INT64_MAX))
        take = torch.sort(sort_key, stable=True).indices[:E]
        live = closed[take]
        out = Chunk(tuple(_gather(c, take) for c in state.rows),
                    torch.zeros(take.shape[0], dtype=torch.int8,
                                device=ts.device),
                    live, self.in_schema)
        state.valid[take[live]] = False
        return state, out

    def pending_flush(self, state: EowcSortState) -> torch.Tensor:
        ts = state.rows[self.ts_col]
        return (state.valid & (ts < state.wm)).sum(dtype=torch.int64)
