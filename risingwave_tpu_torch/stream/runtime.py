"""Streaming job runtime: the host-side barrier/epoch control loop.

Port of ``StreamingJob`` from ``risingwave_tpu/stream/runtime.py``:
``run_chunk``, ``run_chunks``, ``inject_barrier``, ``_maintain``,
``_commit_checkpoint`` and ``recover``.

The chunk loop never synchronises with the device: chunks are generated
on the device and stepped through the fragment with asynchronous
launches.  A barrier reads one pending-row count back (the flush drain,
see ``Fragment.barrier``); error counters and tombstone counts are read
once per maintenance interval.

Every ``snapshot_interval`` checkpoints the barrier seals the epoch
through ``CheckpointPipelineMixin`` (the reference's, :77-230, shared
with ``DagJob``): the state tree goes into the job's ``ShadowSnapshot``
(K11's digest diff and dirty copy with a checkpoint store, a plain copy
into persistent buffers without one) and, with a store, a background
uploader persists the epoch; ``committed_epoch`` advances when the
upload acks.  ``recover()`` prefers the durable store and else restores
the shadow.  The aggregations' spill tiers (``stream/spill.py``) ride
the same commit: every snapshot barrier first drains the non-empty
rings into their host tiers (one host read of the fill counts, in
``StreamingJob._drain_spill_tiers`` and ``DagJob``'s); each snapshot
carries host copies of the tiers (``CheckpointSnapshot.spill``), the
uploader saves them first under their own store keys, and
``rewind_spill_tier`` rewinds a tier on a durable recover.  Sinks deliver at the same commit
(``deliver_sinks``, the reference's :303): a snapshot barrier drains
every ``SinkExecutor``'s new rows to its connector before the shadow
update, so the advanced ``read_cursor`` rides that epoch's snapshot; with
a checkpoint store this happens only when the uploader is idle, else the
delivery waits for the uploads' ack (``_sinks_due``, the reference's
:129-141 and :559-583).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from risingwave_tpu_torch.common.device import resolve_device
from risingwave_tpu_torch.common.epoch import EpochPair
from risingwave_tpu_torch.common.trace import GLOBAL_TRACE
from risingwave_tpu_torch.common.tree import tree_map
from risingwave_tpu_torch.stream.fragment import Fragment
from risingwave_tpu_torch.stream.message import Barrier, BarrierKind
from risingwave_tpu_torch.stream.spill import chunk_to


@dataclass
class CheckpointSnapshot:
    """A sealed epoch: the source cursors; the states live in the job's
    shadow (``states is None``, as the reference's shadow-backed
    snapshots)."""

    epoch: int
    states: Any
    source_state: dict
    #: host copies of spill-tier states at this epoch (key -> tree); a
    #: missing key: the tier had absorbed nothing yet
    spill: dict | None = None


class CheckpointPipelineMixin:
    """Incremental shadow snapshots + pipelined durable uploads, shared
    by ``StreamingJob`` and ``DagJob``.

    A snapshot barrier SEALS the epoch (``sealed_epoch``): one shadow
    update on the device and, with a store, an upload task;
    ``committed_epoch`` advances when the upload acks.  Without a store
    seal and commit coincide.  The barrier loop stalls only when the
    uploader is more than ``upload_window`` epochs behind."""

    #: max sealed-but-unacked epochs before the barrier loop stalls
    upload_window: int = 4
    #: optional MetricsRegistry (the engine attaches its own)
    metrics = None
    checkpoint_store = None
    _shadow = None
    _uploader = None

    def _init_pipeline(self) -> None:
        self.sealed_epoch = 0
        #: seconds this job's barrier loop stalled on the upload window
        self.stall_seconds = 0.0
        self._shadow = None
        self._uploader = None
        #: sink delivery deferred to the upload ack (uploader was busy)
        self._sinks_due = False

    @property
    def ckpt_key(self) -> str:
        """Durable-store key of this job's checkpoint lineage: the job's
        name, or a partition's own lineage (``name@pN``: the scale plane
        runs one partition per engine over ONE shared store).  The
        uploader, the shadow's re-base, the spill tiers' keys and
        ``recover`` all use it."""
        return getattr(self, "_ckpt_key", None) or self.name

    @ckpt_key.setter
    def ckpt_key(self, value: str) -> None:
        self._ckpt_key = value

    def _ensure_uploader(self):
        if self._uploader is None and self.checkpoint_store is not None:
            from risingwave_tpu_torch.stream.checkpoint import (
                CheckpointUploader,
            )
            self._uploader = CheckpointUploader(
                self.checkpoint_store, self.ckpt_key, metrics=self.metrics)
        return self._uploader

    def _process_upload_acks(self) -> None:
        """Cheap ack poll (no device work): advances committed_epoch
        and runs a deferred sink delivery once the queue is empty."""
        up = self._uploader
        if up is None:
            return
        acked = up.take_acked()
        if acked:
            self.committed_epoch = max(self.committed_epoch, acked[-1])
        if self._sinks_due and up.pending() == 0 \
                and self.committed_epoch > 0:
            self._sinks_due = False
            self._deliver_all_sinks(self.committed_epoch)

    def _deliver_or_defer(self, epoch_val) -> None:
        """A snapshot barrier's sink delivery: now when the uploader is
        idle (or there is no store), else on the uploads' ack."""
        up = self._ensure_uploader()
        if up is None or up.pending() == 0:
            self._deliver_all_sinks(epoch_val)
        else:
            self._sinks_due = True

    def upload_queue_depth(self) -> int:
        return 0 if self._uploader is None else self._uploader.pending()

    def drain_uploads(self, raise_error: bool = True) -> None:
        """Block until every sealed epoch is durable."""
        if self._uploader is not None:
            self._uploader.drain(raise_error=raise_error)
            self._process_upload_acks()

    def _shadow_shard_rows(self) -> int | None:
        """The lane axis of a lane-stacked state tree (its shadow digests
        per lane), None for a linear tree."""
        return None

    def _snapshot_commit(self, epoch_val: int, src_state: dict,
                         spill_host: dict | None = None,
                         spill_items: list | None = None) -> None:
        """Seal one epoch: shadow update + uploader enqueue (or, with no
        store, the in-memory commit).  ``spill_host`` are the spill
        tiers' copies for the in-memory snapshot, ``spill_items`` their
        ``(store key, tree)`` saves."""
        from risingwave_tpu_torch.storage.digest import DEFAULT_BLOCK_ELEMS
        from risingwave_tpu_torch.stream.shadow import ShadowSnapshot

        store = self.checkpoint_store
        up = self._ensure_uploader()
        if up is not None:
            self.stall_seconds += up.wait_window(self.upload_window)
            self._process_upload_acks()
        if self._shadow is not None and (
                not self._shadow.matches(self.states)
                or self._shadow.digest_mode != (store is not None)):
            # the tree changed shape (or the job gained/lost a store):
            # drain, then rebuild the shadow from scratch (full re-base)
            if up is not None:
                up.drain()
                self._process_upload_acks()
            if store is not None:
                store.invalidate(self.ckpt_key)
            self._shadow = None
        with GLOBAL_TRACE.span("snapshot", job=self.name, epoch=epoch_val):
            if self._shadow is None:
                self._shadow = ShadowSnapshot(
                    self.states,
                    block_elems=store.block_elems if store is not None
                    else DEFAULT_BLOCK_ELEMS,
                    digest=store is not None,
                    shard_rows=self._shadow_shard_rows())
                digests = self._shadow.digests
            else:
                if up is not None:
                    # the update overwrites what in-flight fetches read
                    up.wait_fetched()
                digests = self._shadow.update(self.states, epoch_val)
        self.sealed_epoch = epoch_val
        self.checkpoints = [CheckpointSnapshot(
            epoch=epoch_val, states=None, source_state=src_state,
            spill=spill_host)]
        if store is not None:
            from risingwave_tpu_torch.stream.checkpoint import UploadTask
            up.enqueue(UploadTask(
                epoch=epoch_val, leaves=self._shadow.leaves,
                digests=digests, shapes=self._shadow.shapes,
                treedef=self._shadow.treedef, source_state=src_state,
                ready=self._shadow.ready, spill=list(spill_items or ()),
                trace_ctx=GLOBAL_TRACE.current(), lanes=self._shadow.lanes))
            self._process_upload_acks()
        else:
            self.committed_epoch = epoch_val

    # -- spill tiers (stream/spill.py) -----------------------------------
    def _init_spill_tiers(self, sites) -> None:
        """One host tier per spill-enabled aggregation; ``sites`` are
        ``((node, executor index), store-key suffix, executor)``."""
        self._spill_tiers = {key: (suffix, self._spill_tier(ex))
                             for key, suffix, ex in sites}

    @staticmethod
    def _spill_tier(ex):
        """A host tier for the spill-enabled aggregation ``ex``."""
        from risingwave_tpu_torch.stream.spill import AggSpillTier

        return AggSpillTier(ex, getattr(ex, "spill_table_size",
                                        ex.table_size * 8))

    def _spill_key(self, suffix) -> str:
        return f"{self.ckpt_key}@spill{suffix}"

    def _read_spill_counts(self, rings) -> list[int]:
        """One host read of the given rings' fill counts."""
        if not rings:
            return []
        self.spill_reads += 1
        return torch.stack(rings).tolist()

    def _spill_snapshot(self):
        """``(spill_host, spill_items)`` of ``_snapshot_commit``: a copy
        of every tier that absorbed rows, and its store saves."""
        host = {key: tier.snapshot()
                for key, (_, tier) in self._spill_tiers.items()
                if tier.rows_absorbed}
        items = [(self._spill_key(self._spill_tiers[key][0]), tree)
                 for key, tree in host.items()]
        return host, items

    def _rewind_spill_tiers(self, epoch: int) -> None:
        """A durable recover: rewind every tier to the job's epoch."""
        for suffix, tier in self._spill_tiers.values():
            key = self._spill_key(suffix)
            self.checkpoint_store.invalidate(key)
            rewind_spill_tier(self.checkpoint_store, key, epoch, tier)

    def _restore_spill_tiers(self, snap) -> None:
        """An in-memory recover: each tier from the snapshot's copy (or
        empty: it had absorbed nothing by then, or there is no
        snapshot)."""
        for key, (_, tier) in self._spill_tiers.items():
            spill = None if snap is None else snap.spill
            if spill and key in spill:
                tier.restore(spill[key])
            else:
                tier.reset()

    def _recover_pipeline(self, epoch: int | None):
        """The shared head of ``recover``: drain the uploads (a failed
        upload is swallowed: the rewind resolves it), then load the
        durable epoch.  Returns ``(epoch, states on the job's device,
        source_state)``, or None without a durable checkpoint."""
        self._counters = None
        if self._uploader is not None:
            self._uploader.drain(raise_error=False)
            self._process_upload_acks()
            self._uploader.clear_error()
            self._sinks_due = False
        if self.checkpoint_store is None:
            return None
        # any rewind invalidates the digest cache: the next save re-bases
        self.checkpoint_store.invalidate(self.ckpt_key)
        loaded = self.checkpoint_store.load(self.ckpt_key, epoch)
        if loaded is None:
            return None
        epoch_v, states, src_state = loaded
        self.committed_epoch = epoch_v
        self.sealed_epoch = epoch_v
        return epoch_v, tree_map(lambda x: x.to(self.device), states), \
            src_state


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


def rewind_spill_tier(store, key: str, epoch: int, tier) -> None:
    """Rewind a host spill tier after a durable recover: restore its
    nearest epoch at or before the job's (a crash between the tier's
    save and the job's leaves the tier one epoch ahead), else reset it —
    its live state would count the replayed rows twice."""
    cands = [e for e in store.epochs(key) if e <= epoch] \
        if store is not None else []
    loaded = store.load(key, cands[-1]) if cands else None
    if loaded is not None:
        tier.restore(loaded[1])
    else:
        tier.reset()


def deliver_sinks(fragment: Fragment, states, epoch_val):
    """Drain the fragment's sink rings to their connectors (the host
    barrier hook; a device-to-host read, on the snapshot cadence only)."""
    states = list(states)
    for i, ex in enumerate(fragment.executors):
        if hasattr(ex, "deliver"):
            states[i] = ex.deliver(states[i], epoch_val)
    return tuple(states)


def restore_source(source, state: dict) -> None:
    if hasattr(source, "restore"):
        source.restore(state)
    elif hasattr(source, "offset") and "offset" in state:
        source.offset = state["offset"]


class StreamingJob(CheckpointPipelineMixin):
    """A linear source -> fragment pipeline driven by the barrier loop."""

    def __init__(self, source, fragment: Fragment, name: str = "job",
                 checkpoint_frequency: int = 1, device=None,
                 checkpoint_store=None):
        self.source = source
        self.fragment = fragment
        self.name = name
        self.device = resolve_device(device)
        self.checkpoint_frequency = checkpoint_frequency
        #: optional durable store (storage.CheckpointStore)
        self.checkpoint_store = checkpoint_store
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
        self._init_pipeline()
        #: counters vector of the last barrier (device tensor)
        self._counters = None
        #: host reads of the spill rings' fill counts
        self.spill_reads = 0
        self._init_spill_tiers([((0, i), i, ex)
                                for i, ex in enumerate(fragment.executors)
                                if getattr(ex, "spill_ring", 0)])

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
        self._process_upload_acks()
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

    def _drain_spill_tiers(self, epoch_val) -> None:
        """Snapshot-barrier hook: one host read of every ring's fill
        count; each non-empty ring drains into its host tier, and the
        tier's changelog runs through the rest of the fragment."""
        keys = list(self._spill_tiers)
        counts = self._read_spill_counts(
            [self.states[j].spill_count for _, j in keys])
        executors = self.fragment.executors
        for (_, j), n in zip(keys, counts):
            if n == 0:
                continue
            states = list(self.states)
            states[j], chunk = executors[j].drain_spill(states[j])
            out = chunk_to(self._spill_tiers[(0, j)][1].process(
                chunk, epoch_val), self.device)
            for k in range(j + 1, len(executors)):
                if out is None:
                    break
                states[k], out = executors[k].apply(states[k], out)
            self.states = tuple(states)

    def _deliver_all_sinks(self, epoch_val) -> None:
        self.states = deliver_sinks(self.fragment, self.states, epoch_val)

    def _commit_checkpoint(self, barrier: Barrier) -> None:
        """Every ``snapshot_interval`` checkpoints: drain the spill rings,
        deliver the sinks (or defer them to the ack), then seal the
        epoch."""
        epoch_val = barrier.epoch.prev.value
        self._ckpts_since_snapshot += 1
        if self._ckpts_since_snapshot < self.snapshot_interval:
            return
        self._ckpts_since_snapshot = 0
        self._drain_spill_tiers(epoch_val)
        self._deliver_or_defer(epoch_val)
        src_state = self.source.state() if hasattr(self.source, "state") \
            else {}
        self._snapshot_commit(epoch_val, src_state, *self._spill_snapshot())

    def recover(self, epoch: int | None = None) -> None:
        """Reset to the last committed checkpoint: the durable store's
        (``epoch`` pins a retained one), else the shadow, else the
        initial state."""
        loaded = self._recover_pipeline(epoch)
        if loaded is not None:
            epoch_v, self.states, src_state = loaded
            restore_source(self.source, src_state)
            self._rewind_spill_tiers(epoch_v)
            return
        if not self.checkpoints:
            self.states = self.fragment.init_states(self.device)
            if hasattr(self.source, "offset"):
                self.source.offset = 0
            self._restore_spill_tiers(None)
            return
        snap = self.checkpoints[-1]
        # a copy: the running job updates state in place
        self.states = self._shadow.restore()
        restore_source(self.source, snap.source_state)
        self._restore_spill_tiers(snap)
