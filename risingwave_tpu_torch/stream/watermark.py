"""Watermark generation.

Port of ``WatermarkFilterExecutor`` from
``risingwave_tpu/stream/watermark.py`` (:38-80): track the highest event
time seen (a device scalar), drop rows later than the current watermark
``max_ts - delay``, count them.  The fragment turns the scalar into a
``Watermark`` at each barrier without reading it back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from risingwave_tpu_torch.common.chunk import Chunk
from risingwave_tpu_torch.common.types import Schema
from risingwave_tpu_torch.stream.executor import Executor

INT64_MIN = -(1 << 63)


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
