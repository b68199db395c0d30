"""Streaming job runtime: the host-side barrier/epoch control loop.

Port of ``StreamingJob`` from ``risingwave_tpu/stream/runtime.py``:
``run_chunk``, ``run_chunks``, ``inject_barrier``, ``_maintain``,
``_commit_checkpoint`` and ``recover``.

The chunk loop never synchronises with the device: chunks are generated
on the device and stepped through the fragment with asynchronous
launches.  A barrier reads one pending-row count back (the flush drain,
see ``Fragment.barrier``); error counters and tombstone counts are read
once per maintenance interval.

Checkpoints in this port are in-memory device clones of the state tree
taken every ``snapshot_interval`` checkpoints and restored by
``recover()``.  The reference's dirty-block shadow snapshot with block
digests and its durable checkpoint store are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from risingwave_tpu_torch.common.chunk import NCol, StrCol
from risingwave_tpu_torch.common.device import resolve_device
from risingwave_tpu_torch.common.epoch import EpochPair
from risingwave_tpu_torch.state.hash_table import HashTable
from risingwave_tpu_torch.state.tag_table import TagTable
from risingwave_tpu_torch.stream.fragment import Fragment
from risingwave_tpu_torch.stream.message import Barrier, BarrierKind


def clone_tree(x):
    """Deep device copy of a state tree (tuples, NamedTuples, tables)."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (HashTable, TagTable)):
        return x.clone()
    if isinstance(x, (NCol, StrCol)) or (isinstance(x, tuple)
                                         and hasattr(x, "_fields")):
        return type(x)(*(clone_tree(v) for v in x))
    if isinstance(x, tuple):
        return tuple(clone_tree(v) for v in x)
    return x


@dataclass
class CheckpointSnapshot:
    """A committed epoch: device clone of all state + source offsets."""

    epoch: int
    states: Any
    source_state: dict


def check_counter_values(name: str, labels: list[str],
                         values: np.ndarray) -> list[str]:
    """Raise on error counters; return labels with residual pending."""
    residual = []
    for label, v in zip(labels, values):
        if label.endswith(".pending"):
            if v > 0:
                residual.append(label)
            continue
        if v <= 0:
            continue
        kind = label.rsplit(".", 1)[-1]
        if kind == "inconsistency":
            raise RuntimeError(f"{name}/{label}: {v} inconsistent changelog "
                               "rows (deletes with no matching state)")
        if kind == "emit_overflow":
            raise RuntimeError(f"{name}/{label}: emit overflow ({v} output "
                               "rows dropped) — increase out_capacity")
        hint = "ring_size" if "AppendOnly" in label \
            else "table/bucket capacity"
        raise RuntimeError(f"{name}/{label}: state overflow ({v} rows "
                           f"dropped) — increase {hint}")
    return residual


def restore_source(source, state: dict) -> None:
    if hasattr(source, "restore"):
        source.restore(state)
    elif hasattr(source, "offset") and "offset" in state:
        source.offset = state["offset"]


class StreamingJob:
    """A linear source -> fragment pipeline driven by the barrier loop."""

    def __init__(self, source, fragment: Fragment, name: str = "job",
                 checkpoint_frequency: int = 1, device=None):
        self.source = source
        self.fragment = fragment
        self.name = name
        self.device = resolve_device(device)
        self.checkpoint_frequency = checkpoint_frequency
        #: checkpoints between maintenance passes (rehash + the counters
        #: readback)
        self.maintenance_interval = 1
        self._ckpts_since_maintain = 0
        #: checkpoints between in-memory snapshots
        self.snapshot_interval = 1
        self._ckpts_since_snapshot = 0
        self.states = fragment.init_states(self.device)
        self.epoch = EpochPair.first()
        self.barriers_seen = 0
        self.checkpoints: list[CheckpointSnapshot] = []
        self.committed_epoch = 0
        #: counters vector of the last barrier (device tensor)
        self._counters = None

    # ------------------------------------------------------------------
    def run_chunk(self) -> int:
        """Pull one chunk from the source through the fragment; returns
        the chunk capacity (no device sync)."""
        chunk = self.source.next_chunk()
        self.states, _ = self.fragment.step(self.states, chunk)
        return chunk.capacity

    def run_chunks(self, n: int) -> int:
        return sum(self.run_chunk() for _ in range(n))

    def inject_barrier(self, barrier: Barrier | None = None) -> list:
        """Cross a barrier, then maintenance / checkpoint on their
        cadences.  Returns the chunks of the first flush pass (already
        applied downstream, e.g. to the MV)."""
        if barrier is None:
            self.barriers_seen += 1
            kind = (BarrierKind.CHECKPOINT
                    if self.barriers_seen % self.checkpoint_frequency == 0
                    else BarrierKind.BARRIER)
            barrier = Barrier(
                EpochPair(self.epoch.curr.next(), self.epoch.curr), kind)
        if barrier.mutation is not None:
            raise NotImplementedError("barrier mutations are not ported yet")
        epoch_val = barrier.epoch.prev.value
        self.states, outs, self._counters = self.fragment.barrier(
            self.states, epoch_val)
        if barrier.is_checkpoint:
            self._ckpts_since_maintain += 1
            if self._ckpts_since_maintain >= self.maintenance_interval:
                self._maintain(epoch_val)
                self._ckpts_since_maintain = 0
            self._commit_checkpoint(barrier)
        self.epoch = barrier.epoch
        return outs

    def _maintain(self, epoch_val) -> None:
        """Rehash + the counters readback (the maintenance sync)."""
        self.states = self.fragment.maintain(self.states)
        if self._counters is None:
            return
        labels = self.fragment.counter_labels
        residual = check_counter_values(self.name, labels,
                                        self._counters.cpu().numpy())
        for _ in range(64):
            if not residual:
                break
            self.states, _, self._counters = self.fragment.barrier(
                self.states, epoch_val)
            residual = check_counter_values(
                self.name, self.fragment.counter_labels,
                self._counters.cpu().numpy())

    def _commit_checkpoint(self, barrier: Barrier) -> None:
        """Every ``snapshot_interval`` checkpoints: clone the state tree
        on the device and commit the epoch."""
        epoch_val = barrier.epoch.prev.value
        self._ckpts_since_snapshot += 1
        if self._ckpts_since_snapshot < self.snapshot_interval:
            return
        self._ckpts_since_snapshot = 0
        src_state = self.source.state() if hasattr(self.source, "state") \
            else {}
        self.checkpoints = [CheckpointSnapshot(
            epoch=epoch_val, states=clone_tree(self.states),
            source_state=src_state)]
        self.committed_epoch = epoch_val

    def recover(self) -> None:
        """Reset to the last committed checkpoint (states and source)."""
        self._counters = None
        if not self.checkpoints:
            self.states = self.fragment.init_states(self.device)
            if hasattr(self.source, "offset"):
                self.source.offset = 0
            return
        snap = self.checkpoints[-1]
        # clone: the running job updates state in place
        self.states = clone_tree(snap.states)
        restore_source(self.source, snap.source_state)
