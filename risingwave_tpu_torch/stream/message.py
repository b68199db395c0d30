"""Stream messages: barriers and watermarks (host-side control values).

A copy of ``risingwave_tpu/stream/message.py``, unchanged except that its imports
name this package: the module imports no JAX, and the port keeps its
own copy instead of importing the reference package.

Reference counterparts:
- ``Message`` enum — src/stream/src/executor/mod.rs:1311
  (``Chunk | Barrier | Watermark``)
- ``Barrier``      — src/stream/src/executor/mod.rs:400-411
- ``Mutation``     — src/stream/src/executor/mod.rs:359-399
- ``Watermark``    — src/stream/src/executor/mod.rs:1234

TPU-first design: data (``Chunk``) flows through jitted fragment step
functions; barriers and watermarks are *host* control flow between
steps, so they are plain Python values, never traced.  A mutation rides
a barrier exactly as in the reference — it is applied by the runtime
between jitted steps (pause/resume/update-vnode-bitmaps/stop).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Mapping

from risingwave_tpu_torch.common.epoch import EpochPair


class BarrierKind(enum.Enum):
    """ref: proto stream_plan Barrier kind (Initial/Barrier/Checkpoint)."""

    INITIAL = "initial"
    BARRIER = "barrier"
    CHECKPOINT = "checkpoint"


@dataclass(frozen=True)
class Mutation:
    """Graph-change command piggybacked on a barrier.

    ref: ``Mutation`` (src/stream/src/executor/mod.rs:359) — the variants
    carried here are the subset the runtime implements; ``conf`` holds
    variant-specific payload (e.g. new vnode→shard mapping for rescale).
    """

    kind: str  # "stop" | "pause" | "resume" | "update" | "add" | "source_change_split" | "throttle"
    conf: Mapping[str, Any] = field(default_factory=dict)


@dataclass(frozen=True)
class Barrier:
    """An epoch barrier (ref executor/mod.rs:400).

    ``epoch.curr`` is the epoch the barrier *opens*; state flushed when
    this barrier passes an executor is attributed to ``epoch.prev``.
    """

    epoch: EpochPair
    kind: BarrierKind = BarrierKind.BARRIER
    mutation: Mutation | None = None

    @property
    def is_checkpoint(self) -> bool:
        return self.kind in (BarrierKind.CHECKPOINT, BarrierKind.INITIAL)

    def is_stop(self) -> bool:
        return self.mutation is not None and self.mutation.kind == "stop"

    def is_pause(self) -> bool:
        return self.mutation is not None and self.mutation.kind == "pause"


@dataclass(frozen=True)
class Watermark:
    """Per-column event-time lower bound (ref executor/mod.rs:1234).

    Downstream operators may drop state for keys strictly below ``value``
    (state cleaning) and EOWC operators emit closed windows.
    """

    col_idx: int
    value: Any  # host scalar in the column's physical representation
