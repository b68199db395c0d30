"""Fragment: a chain of executors driven chunk by chunk and at barriers.

Port of ``risingwave_tpu/stream/fragment.py``: ``step``, ``flush``,
``barrier`` (flush, drain, watermarks, counters), ``on_watermark``,
``maintain`` and the counters vector.  The reference jits each of these
into one XLA program; here they run eagerly, and the device work stays
asynchronous except where noted:

- the emit-capacity drain reads the pending-row count once per barrier
  (the reference loops on the device);
- watermarks propagate as device scalars, never read back;
- error counters are stacked into one device vector per barrier, read
  by the runtime once per maintenance interval.
"""

from __future__ import annotations

from typing import Sequence

import torch

from risingwave_tpu_torch.common.chunk import Chunk
from risingwave_tpu_torch.common.types import Schema
from risingwave_tpu_torch.stream.executor import Executor
from risingwave_tpu_torch.stream.message import Watermark
from risingwave_tpu_torch.stream.watermark import WatermarkFilterExecutor

#: sentinel for "no watermark yet" (matches WmState.max_ts init)
WM_NONE = -(1 << 63)
#: stand-in threshold when no watermark exists: below any real event
#: time, far enough above INT64_MIN that ``value - lag`` cannot wrap
WM_SAFE_FLOOR = -(1 << 62)

#: per-executor-state scalar counters surfaced to maintenance checks
COUNTER_ATTRS = ("inconsistency", "overflow", "emit_overflow")


def collect_counters(executors, states):
    """(labels, int64 [n] device vector) of every executor's error
    counters and residual pending-flush count."""
    labels: list[str] = []
    vals: list[torch.Tensor] = []
    for ex, st in zip(executors, states):
        for attr in COUNTER_ATTRS:
            if hasattr(st, attr):
                labels.append(f"{ex}.{attr}")
                vals.append(getattr(st, attr).to(torch.int64))
        if hasattr(ex, "pending_flush"):
            labels.append(f"{ex}.pending")
            vals.append(ex.pending_flush(st).to(torch.int64))
    return labels, (torch.stack(vals) if vals else None)


class Fragment:
    """An executor chain with its chunk and barrier paths."""

    #: bound on flush re-drain rounds per barrier
    MAX_DRAIN_ROUNDS = 64

    def __init__(self, executors: Sequence[Executor], name: str = "fragment"):
        if not executors:
            raise ValueError("fragment needs at least one executor")
        self.executors = list(executors)
        self.name = name
        #: counter labels aligned with the barrier counters vector
        self.counter_labels: list[str] = []
        #: an executor emits on window close (drain after the watermarks)
        self.has_eowc = any(getattr(ex, "emit_on_window_close", False)
                            for ex in self.executors)

    @property
    def out_schema(self) -> Schema:
        return self.executors[-1].out_schema

    def init_states(self, device) -> tuple:
        return tuple(e.init_state(device) for e in self.executors)

    # -- chunk path -----------------------------------------------------
    def step(self, states: tuple, chunk: Chunk):
        """Process one chunk; returns (states, out_chunk_or_None)."""
        new_states = list(states)
        cur = chunk
        for i, ex in enumerate(self.executors):
            if cur is None:
                break
            new_states[i], cur = ex.apply(new_states[i], cur)
        return tuple(new_states), cur

    # -- barrier path ---------------------------------------------------
    def flush(self, states: tuple, epoch):
        """Flush every executor; emitted changelogs flow through the rest
        of the chain.  Returns (states, [chunks])."""
        new_states = list(states)
        outs: list[Chunk] = []
        for i, ex in enumerate(self.executors):
            new_states[i], emitted = ex.flush(new_states[i], epoch)
            if not ex.emits_on_flush or emitted is None:
                continue
            cur = emitted
            for j in range(i + 1, len(self.executors)):
                if cur is None:
                    break
                new_states[j], cur = self.executors[j].apply(new_states[j],
                                                             cur)
            if cur is not None:
                outs.append(cur)
        return tuple(new_states), outs

    def on_watermark(self, states: tuple, watermark):
        return tuple(ex.on_watermark(st, watermark)
                     for ex, st in zip(self.executors, states))

    def pending_total(self, states) -> torch.Tensor | None:
        """Rows awaiting a further flush round (device scalar), or None
        when no executor buffers output."""
        tot = None
        for ex, st in zip(self.executors, states):
            if hasattr(ex, "pending_flush"):
                p = ex.pending_flush(st).to(torch.int64)
                tot = p if tot is None else tot + p
        return tot

    def _drain(self, states, epoch) -> tuple[tuple, int]:
        """Repeat flush rounds while rows are pending (one host read of
        the pending count per round); returns (states, pending)."""
        for rounds in range(self.MAX_DRAIN_ROUNDS + 1):
            tot = self.pending_total(states)
            pending = 0 if tot is None else int(tot)
            if pending == 0 or rounds == self.MAX_DRAIN_ROUNDS:
                break
            states, _ = self.flush(states, epoch)
        return states, pending

    def _propagate_watermarks(self, states):
        """Watermarks from generator executors to the whole chain, as
        device scalars (no readback)."""
        states = list(states)
        for i, ex in enumerate(self.executors):
            if not isinstance(ex, WatermarkFilterExecutor):
                continue
            raw = states[i].max_ts
            val = torch.where(raw == WM_NONE,
                              torch.full_like(raw, WM_SAFE_FLOOR),
                              raw - ex.delay_us)
            states = list(self.on_watermark(states,
                                            Watermark(ex.ts_col, val)))
        return tuple(states)

    def barrier(self, states, epoch):
        """Cross a barrier: flush, drain, watermarks, counters.

        Returns (states, first-pass emissions, counters vector).  As in
        the reference, the watermarks are followed by a second drain, so
        that EMIT ON WINDOW CLOSE rows closed by this barrier's watermark
        are emitted at this barrier.  Without EOWC a watermark only clears
        dirty groups, so that drain is needed only when the first one
        stopped at its round bound."""
        states, outs = self.flush(states, epoch)
        states, pending = self._drain(states, epoch)
        states = self._propagate_watermarks(states)
        if pending or self.has_eowc:
            states, _ = self._drain(states, epoch)
        labels, counters = collect_counters(self.executors, states)
        self.counter_labels = labels
        return states, outs, counters

    def maintain(self, states):
        """Checkpoint-time housekeeping: tables whose tombstones dominate
        are rebuilt."""
        return tuple(ex.maybe_rehash(st) if hasattr(ex, "maybe_rehash")
                     else st for ex, st in zip(self.executors, states))

    def __repr__(self) -> str:
        chain = " -> ".join(map(repr, self.executors))
        return f"Fragment({self.name}: {chain})"
