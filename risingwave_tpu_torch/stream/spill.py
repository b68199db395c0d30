"""Host-resident overflow tier of an aggregation (spill-to-host).

Port of ``risingwave_tpu/stream/spill.py``.  A device hash table cannot
grow, so the input rows whose group cannot claim a slot divert into the
aggregation's spill ring (``HashAggExecutor.spill_ring``) and drain, at
snapshot barriers, into this tier: the SAME ``HashAggExecutor`` built
for the CPU (its plain versions) with a much larger table, as the
reference builds it on ``jax.devices("cpu")``.  Its changelog injects
into the dataflow right after the device aggregation, so downstream
(projection, join, MV) sees one merged changelog.  This is the
reference's semantics for unbounded key spaces, not a fallback: every
other row stays on the card.

Ownership is structural: a group lives in the tier iff its first row
overflowed, and the device table only frees slots by watermark
cleaning, which the planner excludes from spill-enabled plans.
"""

from __future__ import annotations

import torch

from risingwave_tpu_torch.common.chunk import Chunk
from risingwave_tpu_torch.common.tree import tree_map


def chunk_to(chunk: Chunk, device) -> Chunk:
    """A copy of ``chunk`` on ``device``."""
    cols = tree_map(lambda x: x.to(device, copy=True), tuple(chunk.columns))
    return Chunk(cols, chunk.ops.to(device, copy=True),
                 chunk.valid.to(device, copy=True), chunk.schema)


class AggSpillTier:
    """CPU twin of a device ``HashAggExecutor``, fed by its spill ring."""

    def __init__(self, agg, table_size: int):
        self.agg = agg.make_spill_tier(table_size)
        self.state = self.agg.init_state("cpu")
        self.rows_absorbed = 0

    def process(self, drained: Chunk, epoch) -> Chunk:
        """Apply one drained ring chunk and flush; returns the tier's
        changelog chunk (on the CPU)."""
        chunk = chunk_to(drained, "cpu")
        st, _ = self.agg.apply(self.state, chunk)
        self.state, out = self.agg.flush(st, epoch)
        self.rows_absorbed += int(chunk.valid.sum())
        return out

    # -- checkpoint -----------------------------------------------------
    def snapshot(self):
        """An owned copy of the tier's state."""
        return tree_map(torch.clone, self.state)

    def restore(self, host_state) -> None:
        self.state = tree_map(lambda x: x.to("cpu", copy=True), host_state)
        self.rows_absorbed = 1

    def reset(self) -> None:
        """Forget every absorbed group: recovery rewound to an epoch
        before this tier's first checkpoint, so its live state is from
        the future of the recovered epoch."""
        self.state = self.agg.init_state("cpu")
        self.rows_absorbed = 0
