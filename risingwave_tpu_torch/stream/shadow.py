"""ShadowSnapshot: incremental device-side snapshots of a state tree.

Port of ``ShadowSnapshot`` from ``risingwave_tpu/stream/shadow.py``
(:273) with ``matches``, ``update``, ``restore`` and ``dirty_ratio``, and
of ``leaf_lanes`` (:180).
The snapshot is a persistent flat copy of every state leaf (the shadow)
plus, in the durable mode, the block-digest vector of its contents:

- ``digest=True`` (a job with a checkpoint store): one K11 launch per
  snapshot (``csrc/shadow_digest.cu`` through
  ``storage.digest.shadow_digest``) digests every live leaf by blocks,
  diffs with the shadow's digests, copies the dirty blocks into the
  shadow and counts them; the digest vector feeds the store's delta;
- ``digest=False`` (store-less): nothing consumes a digest, so the
  update is a straight ``copy_`` of every leaf into the persistent
  shadow buffers (no allocation per snapshot).

The observable results are the reference's: the shadow contents, the
digest vector (int64 bit patterns of its uint64 digests) and
``dirty_blocks`` (the dirty blocks of leaves with more than 8 blocks
and at least 2 full blocks, including their ragged tail block; smaller
leaves copy whole and count 0; the store-less mode reports every
block).  The reference's budget ladder is replaced by an exact
per-block dirty copy (see the kernel's header), which leaves the same
shadow contents.

Everything is asynchronous on the device: ``update`` records the CUDA
event ``ready`` after its launch, which the checkpoint uploader's own
stream waits on before it reads the shadow; ``dirty_blocks`` stays a
device scalar until ``dirty_ratio`` reads it.

``shard_rows=N`` (a lane-stacked tree, the sharded ``DagJob``'s): every
leaf whose leading axis is the lane axis digests in N lanes (K11 lanes,
``storage/digest.py``): the block grid restarts at every row, so no block
and no dirty copy spans two lanes, each row's ragged tail copies always,
and ``dirty_blocks`` counts as the reference's ``_copy_leaf_rows`` (:122):
a leaf with ``rows * nb_row <= 8`` or ``rows * nbf < 2`` copies whole and
counts 0.  ``lanes`` (per leaf ``(rows, row_elems)`` or None) rides every
upload, so the store cuts its delta runs on the same grid.
"""

from __future__ import annotations

import torch

from risingwave_tpu_torch.common.tree import flatten, unflatten
from risingwave_tpu_torch.storage.digest import (
    DEFAULT_BLOCK_ELEMS,
    block_counts,
    shadow_digest,
)


def leaf_lanes(shape, shard_rows) -> tuple | None:
    """``(rows, row_elems)`` of a leaf whose leading axis is the lane axis
    under per-shard digesting, else None (flat)."""
    if not shard_rows or not shape or shape[0] != shard_rows:
        return None
    n = 1
    for d in shape:
        n *= int(d)
    return (shard_rows, n // shard_rows)


class ShadowSnapshot:
    """A device-resident shadow of one job's state tree."""

    #: when a list, every update appends the (start, end) CUDA events
    #: around its launches (None on the CPU): device time per snapshot,
    #: for chip_smoke.py
    timing: list | None = None

    def __init__(self, states, block_elems: int = DEFAULT_BLOCK_ELEMS,
                 digest: bool = True, shard_rows: int | None = None):
        leaves, self.treedef = flatten(states)
        self.block = block_elems
        self.digest_mode = digest
        self.shard_rows = shard_rows
        self.shapes = [tuple(x.shape) for x in leaves]
        self.sig = tuple((str(x.dtype), tuple(x.shape)) for x in leaves)
        #: per-leaf (rows, row_elems), None = flat
        self.lanes = [leaf_lanes(s, shard_rows) for s in self.shapes]
        self._rows = [ln[0] if ln else 1 for ln in self.lanes]
        self.nblocks = block_counts(self.shapes, self.lanes, block_elems)
        self.total_blocks = int(sum(self.nblocks))
        dev = leaves[0].device if leaves else torch.device("cpu")
        self.device = dev
        #: flat copies of every leaf (the shadow contents)
        self.leaves = [torch.empty(x.numel(), dtype=x.dtype, device=dev)
                       for x in leaves]
        self.digests = torch.zeros(self.total_blocks if digest else 0,
                                   dtype=torch.int64, device=dev)
        #: dirty blocks of the LAST update (device scalar)
        self.dirty_blocks = torch.zeros((), dtype=torch.int64, device=dev)
        self.ready = None
        flat = [x.reshape(-1) for x in leaves]
        if digest:
            shadow_digest(flat, self.leaves, self.digests,
                          self.dirty_blocks, self.nblocks, self.block,
                          update=False, rows=self._rows)
        else:
            for sh, x in zip(self.leaves, flat):
                sh.copy_(x)
        self.epoch = 0
        # a clean no-op diff, as the reference's warm-up update
        self.update(states)

    # ------------------------------------------------------------------
    def matches(self, states) -> bool:
        leaves = flatten(states)[0]
        if len(leaves) != len(self.sig):
            return False
        return all((str(x.dtype), tuple(x.shape)) == s
                   for x, s in zip(leaves, self.sig))

    def update(self, states, epoch: int = 0) -> torch.Tensor:
        """Diff live vs shadow and copy the dirty blocks (K11), or copy
        every leaf (store-less); returns the digest vector."""
        flat = [x.reshape(-1) for x in flatten(states)[0]]
        cuda = self.device.type == "cuda"
        events = None
        if cuda and self.timing is not None:
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        if self.digest_mode:
            self.dirty_blocks.zero_()
            shadow_digest(flat, self.leaves, self.digests,
                          self.dirty_blocks, self.nblocks, self.block,
                          update=True, events=events, rows=self._rows)
        else:
            if events is not None:
                events[0].record()
            for sh, x in zip(self.leaves, flat):
                sh.copy_(x)
            if events is not None:
                events[1].record()
            self.dirty_blocks.fill_(self.total_blocks)
        if self.timing is not None:
            self.timing.append(events)
        if cuda:
            self.ready = torch.cuda.Event()
            self.ready.record()
        self.epoch = epoch
        return self.digests

    # ------------------------------------------------------------------
    def restore(self):
        """A fresh tree equal to the shadow contents; independent of the
        shadow."""
        return unflatten(self.treedef, [
            sh.clone().reshape(s) for sh, s in zip(self.leaves, self.shapes)])

    def dirty_ratio(self) -> float:
        """Dirty fraction of the LAST update (a host read: for metrics,
        never the barrier path)."""
        return float(self.dirty_blocks.item()) / max(1, self.total_blocks)
