"""ShadowSnapshot: incremental device-side snapshots of a state tree.

Port of ``ShadowSnapshot`` from ``risingwave_tpu/stream/shadow.py``
(:273) with ``matches``, ``update``, ``restore`` and ``dirty_ratio``.
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
device scalar until ``dirty_ratio`` reads it.  Per-shard lanes
(``shard_rows``, mesh-stacked trees) wait for the multi-GPU port.
"""

from __future__ import annotations

import torch

from risingwave_tpu_torch.common.tree import flatten, unflatten
from risingwave_tpu_torch.storage.digest import (
    DEFAULT_BLOCK_ELEMS,
    leaf_block_count,
    shadow_digest,
)


class ShadowSnapshot:
    """A device-resident shadow of one job's state tree."""

    #: when a list, every update appends the (start, end) CUDA events
    #: around its launches (None on the CPU): device time per snapshot,
    #: for chip_smoke.py
    timing: list | None = None

    def __init__(self, states, block_elems: int = DEFAULT_BLOCK_ELEMS,
                 digest: bool = True, shard_rows: int | None = None):
        if shard_rows:
            raise NotImplementedError(
                "per-shard digest lanes (shard_rows) are not ported yet")
        leaves, self.treedef = flatten(states)
        self.block = block_elems
        self.digest_mode = digest
        self.shard_rows = None
        self.shapes = [tuple(x.shape) for x in leaves]
        self.sig = tuple((str(x.dtype), tuple(x.shape)) for x in leaves)
        self.nblocks = [leaf_block_count(s, block_elems)
                        for s in self.shapes]
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
                          update=False)
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
                          update=True, events=events)
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
