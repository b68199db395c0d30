"""Epochs — the unit of consistency.

A copy of ``risingwave_tpu/common/epoch.py``, unchanged except that its imports
name this package: the module imports no JAX, and the port keeps its
own copy instead of importing the reference package.

Reference counterpart: ``src/common/src/util/epoch.rs:31,36,156``.
An epoch is ``physical-ms-since-2021-04-01 << 16``; the low 16 bits are a
sequence number so multiple epochs can share a wall-clock millisecond.
Every barrier carries an ``EpochPair {curr, prev}``; state commits are
tagged with the epoch they seal.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

#: 2021-04-01T00:00:00Z in unix millis (ref epoch.rs UNIX_RISINGWAVE_DATE_EPOCH)
_EPOCH_BASE_MS = 1_617_235_200_000
EPOCH_PHYSICAL_SHIFT = 16


@dataclass(frozen=True, order=True)
class Epoch:
    value: int

    @staticmethod
    def now(prev: "Epoch | None" = None) -> "Epoch":
        phys = max(int(time.time() * 1000) - _EPOCH_BASE_MS, 0)
        e = phys << EPOCH_PHYSICAL_SHIFT
        if prev is not None and e <= prev.value:
            e = prev.value + 1  # monotonicity under clock skew / same-ms ticks
        return Epoch(e)

    @property
    def physical_ms(self) -> int:
        return self.value >> EPOCH_PHYSICAL_SHIFT

    def next(self) -> "Epoch":
        return Epoch.now(prev=self)

    def __repr__(self) -> str:
        return f"Epoch({self.value})"


INVALID_EPOCH = Epoch(0)


@dataclass(frozen=True)
class EpochPair:
    """(curr, prev) carried by every barrier (ref epoch.rs:156)."""

    curr: Epoch
    prev: Epoch

    @staticmethod
    def first() -> "EpochPair":
        return EpochPair(Epoch.now(), INVALID_EPOCH)

    def bump(self) -> "EpochPair":
        return EpochPair(self.curr.next(), self.curr)
