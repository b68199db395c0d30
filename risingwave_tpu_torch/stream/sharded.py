"""Sharded streaming jobs: one fragment chain over a mesh of lanes.

Port of ``risingwave_tpu/stream/sharded.py``: ``ShardedJob`` (:37) and
``ShardedStreamingJob`` (:253).  The reference runs the chain SPMD as one
``shard_map`` over a device mesh: each shard generates its own source
block, runs the stateless local half (watermark filter, window, project,
the partial aggregation), the hash exchange (``all_to_all``) and the keyed
half (the aggregation and what follows it) on its own states, which are
stacked on a leading ``[n_shards]`` axis.

The port's mesh is ``n`` LANES on one ``torch.device`` (the engine's
``lanes`` argument plays the part of ``len(jax.devices())``), with the
same placement the reference's tests use (8 virtual devices on one
CPU).  The states stay stacked exactly as the reference stacks them:
every leaf has a leading ``[n]`` axis, so the checkpoint, the shadow
(K11 over the stacked leaves) and the comparison with the reference see
one tree.  A step runs each half lane by lane on views ``x[s]`` of the
stacked leaves (the executors update state in place; a leaf an executor
replaces is copied back into its lane, ``_Lanes.put``), and the exchange
between them is ``parallel.exchange.shuffle_chunk`` over all lanes at
once (K2 and K24 on the card).

A barrier (``ShardedJob.flush``, the reference's ``_local_flush``)
flushes the local half lane by lane and feeds each emission across the
exchange, drains the local half if it buffers output, flushes and drains
the keyed half, then aligns the watermark: the reference's ``lax.pmin``
over the mesh is a min over the lane axis, and a lane that has seen no
data pins it at ``WM_NONE`` -> ``WM_SAFE_FLOOR``; the keyed half drains
again after it when rows are left or it emits on window close.  The
drains read one pending count per round for all lanes (the reference
loops on the device), and only lanes with rows pending flush.  As in the
reference, the sharded job never rehashes (no maintenance pass); its
counters are read once per maintenance interval, summed over the lanes.

``ShardedStreamingJob`` drives it from the engine's barrier loop: one
``reader.next_base()`` per lane per chunk, the counters, the snapshot
through the port's checkpoint pipeline (``CheckpointPipelineMixin``: the
shadow and the uploader, as every job of the port), sink delivery with
per-lane cursors and one commit marker per epoch, ``recover`` and
``mv_rows``.  ``rescale`` (ALTER PARALLELISM) is a later slice.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from risingwave_tpu_torch.common.device import resolve_device
from risingwave_tpu_torch.common.epoch import EpochPair
from risingwave_tpu_torch.common.tree import flatten, unflatten
from risingwave_tpu_torch.parallel.exchange import shuffle_chunk
from risingwave_tpu_torch.stream.executor import Executor
from risingwave_tpu_torch.stream.fragment import (
    COUNTER_ATTRS,
    WM_NONE,
    WM_SAFE_FLOOR,
    Fragment,
)
from risingwave_tpu_torch.stream.message import Watermark
from risingwave_tpu_torch.stream.runtime import (
    CheckpointPipelineMixin,
    check_counter_values,
    restore_source,
)
from risingwave_tpu_torch.stream.watermark import WatermarkFilterExecutor


def stack_trees(trees: Sequence) -> object:
    """Per-lane trees of one structure stacked leaf by leaf on a leading
    lane axis."""
    flat = [flatten(t) for t in trees]
    spec = flat[0][1]
    return unflatten(spec, [torch.stack(xs)
                            for xs in zip(*(leaves for leaves, _ in flat))])


class _Lanes:
    """A stacked state tuple (one entry per executor) with a view tree per
    lane, kept for as long as the stacked tensors live."""

    def __init__(self, stacked: tuple, n: int):
        self.stacked = stacked
        self.leaves, spec = flatten(stacked)
        self.views = [unflatten(spec, [x[s] for x in self.leaves])
                      for s in range(n)]
        self.ranges = []
        start = 0
        for st in stacked:
            k = len(flatten(st)[0])
            self.ranges.append((start, start + k))
            start += k

    def put(self, s: int, states: Sequence, first: int = 0) -> None:
        """Lane ``s``'s new states of executors ``first, first + 1, ...``:
        a leaf that is not its lane's view any more is copied into it."""
        for e, st in enumerate(states, start=first):
            a, b = self.ranges[e]
            new = flatten(st)[0]
            if len(new) != b - a:
                raise RuntimeError(f"executor {e} changed its state's shape")
            for x, stacked in zip(new, self.leaves[a:b]):
                v = stacked[s]
                if x.data_ptr() != v.data_ptr() or x.shape != v.shape:
                    v.copy_(x)


class ShardedJob:
    """source -> [local executors] -> hash exchange -> [keyed executors],
    over ``n_lanes`` lanes of one device.

    ``source_fn(k0, cap) -> Chunk`` generates a lane's block of the source
    (each lane reads its own ordinal range); ``exchange_key_fn(chunk)``
    gives the columns whose vnode picks the receiving lane."""

    def __init__(self, n_lanes: int, source_fn: Callable,
                 chunk_capacity: int, local_executors: Sequence[Executor],
                 exchange_key_fn: Callable,
                 keyed_executors: Sequence[Executor], device=None):
        self.n_shards = n_lanes
        self.device = resolve_device(device)
        self.source_fn = source_fn
        self.cap = chunk_capacity
        # the two halves are real Fragments: chain semantics (None-break,
        # the flush cascade) stay in one place
        self.local_frag = Fragment(local_executors, "local") \
            if local_executors else None
        self.keyed_frag = Fragment(keyed_executors, "keyed")
        self.exchange_key_fn = exchange_key_fn
        self.executors = list(local_executors) + list(keyed_executors)
        self.n_local = len(local_executors)

    def init_states(self) -> tuple:
        """Per-lane states stacked on a leading ``[n_lanes]`` axis."""
        return stack_trees([tuple(ex.init_state(self.device)
                                  for ex in self.executors)
                            for _ in range(self.n_shards)])

    # -- the halves, lane by lane ---------------------------------------
    def _local(self, lanes: _Lanes, s: int) -> tuple:
        return tuple(lanes.views[s][:self.n_local])

    def _keyed(self, lanes: _Lanes, s: int) -> tuple:
        return tuple(lanes.views[s][self.n_local:])

    def _feed_exchange(self, lanes: _Lanes, emitted: list) -> None:
        """Route each lane's emission across the exchange into the keyed
        half (which is terminal: its output is not kept)."""
        recv = shuffle_chunk(emitted, [self.exchange_key_fn(c)
                                       for c in emitted])
        for d in range(self.n_shards):
            states, _ = self.keyed_frag.step(self._keyed(lanes, d), recv[d])
            lanes.put(d, states, self.n_local)

    def step(self, lanes: _Lanes, k0s: Sequence[int]) -> None:
        """One chunk per lane; ``k0s[s]`` is lane ``s``'s first ordinal."""
        emitted = []
        for s in range(self.n_shards):
            chunk = self.source_fn(k0s[s], self.cap)
            if self.local_frag is not None:
                states, chunk = self.local_frag.step(self._local(lanes, s),
                                                     chunk)
                lanes.put(s, states)
            emitted.append(chunk)
        if emitted[0] is not None:
            self._feed_exchange(lanes, emitted)

    def _pending(self, frag: Fragment, lanes: _Lanes, part) -> list[int]:
        """Each lane's rows awaiting a flush round (one host read)."""
        tots = [frag.pending_total(part(lanes, s))
                for s in range(self.n_shards)]
        if tots[0] is None:
            return [0] * self.n_shards
        return torch.stack(tots).tolist()

    def _drain_keyed(self, lanes: _Lanes, epoch) -> int:
        """Flush rounds on every lane with rows pending, at most
        ``MAX_DRAIN_ROUNDS`` (the reference's per-shard device loop);
        returns the rows still pending."""
        frag = self.keyed_frag
        for rounds in range(frag.MAX_DRAIN_ROUNDS + 1):
            pending = self._pending(frag, lanes, self._keyed)
            if not any(pending) or rounds == frag.MAX_DRAIN_ROUNDS:
                break
            for d, p in enumerate(pending):
                if p > 0:
                    states, _ = frag.flush(self._keyed(lanes, d), epoch)
                    lanes.put(d, states, self.n_local)
        return sum(pending)

    def _flush_local(self, lanes: _Lanes, epoch) -> None:
        """Flush the local half on every lane; each emission crosses the
        exchange (an emission of one lane is matched by one of every lane:
        the chain and its None-ness are the same)."""
        outs = []
        for s in range(self.n_shards):
            states, o = self.local_frag.flush(self._local(lanes, s), epoch)
            lanes.put(s, states)
            outs.append(o)
        for k in range(len(outs[0])):
            self._feed_exchange(lanes, [o[k] for o in outs])

    def flush(self, lanes: _Lanes, epoch) -> None:
        """A barrier: the reference's ``_local_flush``."""
        if self.local_frag is not None:
            self._flush_local(lanes, epoch)
            frag = self.local_frag
            for _ in range(frag.MAX_DRAIN_ROUNDS):
                if not any(self._pending(frag, lanes, self._local)):
                    break
                self._flush_local(lanes, epoch)
        for d in range(self.n_shards):
            states, _ = self.keyed_frag.flush(self._keyed(lanes, d), epoch)
            lanes.put(d, states, self.n_local)
        pending = self._drain_keyed(lanes, epoch)
        self._wm_pass(lanes)
        if pending or self.keyed_frag.has_eowc:
            self._drain_keyed(lanes, epoch)

    def _wm_pass(self, lanes: _Lanes) -> None:
        """Watermark alignment: the min of every lane's watermark filter
        (the reference's ``lax.pmin``), applied by every executor of both
        halves on every lane."""
        for i, ex in enumerate(self.executors[:self.n_local]):
            if not isinstance(ex, WatermarkFilterExecutor):
                continue
            graw = lanes.stacked[i].max_ts.min()
            val = torch.where(graw == WM_NONE,
                              torch.full_like(graw, WM_SAFE_FLOOR),
                              graw - ex.delay_us)
            wm = Watermark(ex.ts_col, val)
            for s in range(self.n_shards):
                lanes.put(s, self.local_frag.on_watermark(
                    self._local(lanes, s), wm))
                lanes.put(s, self.keyed_frag.on_watermark(
                    self._keyed(lanes, s), wm), self.n_local)

    def gather_counters(self, lanes: _Lanes):
        """(labels, int64 device vector) of every executor's error counters
        and residual pending, summed over the lanes."""
        labels: list[str] = []
        vals: list[torch.Tensor] = []
        for i, ex in enumerate(self.executors):
            st = lanes.stacked[i]
            for attr in COUNTER_ATTRS:
                if hasattr(st, attr):
                    labels.append(f"{ex}.{attr}")
                    vals.append(getattr(st, attr).sum().to(torch.int64))
            if hasattr(ex, "pending_flush"):
                labels.append(f"{ex}.pending")
                vals.append(torch.stack([
                    ex.pending_flush(lanes.views[s][i]).to(torch.int64)
                    for s in range(self.n_shards)]).sum())
        return labels, (torch.stack(vals) if vals else
                        torch.zeros(0, dtype=torch.int64,
                                    device=self.device))


class ShardedStreamingJob(CheckpointPipelineMixin):
    """The engine's barrier-loop interface over a ``ShardedJob``."""

    def __init__(self, sharded: ShardedJob, reader, name: str,
                 checkpoint_frequency: int = 1, checkpoint_store=None,
                 max_lanes: int | None = None):
        self.sharded = sharded
        self.reader = reader
        self.name = name
        self.device = sharded.device
        #: the lanes the engine has (a checkpoint of more cannot load)
        self.max_lanes = max_lanes or sharded.n_shards
        self.checkpoint_frequency = checkpoint_frequency
        self.checkpoint_store = checkpoint_store
        self.maintenance_interval = 1
        self._ckpts_since_maintain = 0
        self.snapshot_interval = 1
        self._ckpts_since_snapshot = 0
        self._lanes = None
        self.states = sharded.init_states()
        self.epoch = EpochPair.first()
        self.barriers_seen = 0
        self.committed_epoch = 0
        self.checkpoints: list = []
        self._init_pipeline()

    @property
    def states(self):
        return self._states

    @states.setter
    def states(self, value) -> None:
        self._states = value
        self._lanes = None

    @property
    def lanes(self) -> _Lanes:
        if self._lanes is None:
            self._lanes = _Lanes(self._states, self.sharded.n_shards)
        return self._lanes

    @property
    def source(self):
        return self.reader

    # ------------------------------------------------------------------
    def run_chunk(self) -> int:
        """One chunk per lane; returns the rows consumed (no device
        sync)."""
        n = self.sharded.n_shards
        k0s = [self.reader.next_base() for _ in range(n)]
        self.sharded.step(self.lanes, k0s)
        return n * self.sharded.cap

    def run_chunks(self, n: int) -> int:
        return sum(self.run_chunk() for _ in range(n))

    def inject_barrier(self, barrier=None) -> None:
        if barrier is not None:
            raise NotImplementedError(
                "barrier mutations of a sharded job are not ported yet")
        self.barriers_seen += 1
        sealed = self.epoch.curr.value
        self.sharded.flush(self.lanes, sealed)
        if self.barriers_seen % self.checkpoint_frequency == 0:
            self._ckpts_since_maintain += 1
            if self._ckpts_since_maintain >= self.maintenance_interval:
                self._check_counters(sealed)
                self._ckpts_since_maintain = 0
            self._ckpts_since_snapshot += 1
            if self._ckpts_since_snapshot >= self.snapshot_interval:
                self._ckpts_since_snapshot = 0
                self._deliver_or_defer(sealed)
                self._snapshot_commit(sealed, {"offset": self.reader.offset})
        self._process_upload_acks()
        self.epoch = self.epoch.bump()

    def _check_counters(self, sealed) -> None:
        """The one counters read of a maintenance interval; residual
        pending rows past the drain bound get host-looped flushes."""
        labels, vals = self.sharded.gather_counters(self.lanes)
        residual = check_counter_values(self.name, labels,
                                        vals.cpu().numpy())
        for _ in range(64):
            if not residual:
                break
            self.sharded.flush(self.lanes, sealed)
            labels, vals = self.sharded.gather_counters(self.lanes)
            residual = check_counter_values(self.name, labels,
                                            vals.cpu().numpy())

    def _deliver_all_sinks(self, epoch_val) -> None:
        """Every lane's new sink rows, then ONE commit marker for the
        epoch (the closed-epoch reader protocol of the file sink); the
        per-lane ``read_cursor``s ride the epoch's snapshot."""
        lanes = self.lanes
        for i, ex in enumerate(self.sharded.executors):
            if not hasattr(ex, "deliver"):
                continue
            for s in range(self.sharded.n_shards):
                st = ex.deliver(lanes.views[s][i], epoch_val, commit=False)
                lanes.put(s, (st,), i)
            ex.sink.commit(epoch_val)

    def recover(self, epoch: int | None = None) -> None:
        """Reset to the last committed checkpoint: the durable store's
        (its lane count wins over the DDL's, up to the engine's lanes),
        else the shadow, else the initial state."""
        loaded = self._recover_pipeline(epoch)
        if loaded is not None:
            _, states, src_state = loaded
            n_ckpt = flatten(states)[0][0].shape[0]
            if n_ckpt != self.sharded.n_shards:
                if n_ckpt > self.max_lanes:
                    raise RuntimeError(
                        f"checkpoint has {n_ckpt} shards but the engine "
                        f"has {self.max_lanes} lanes")
                old = self.sharded
                self.sharded = ShardedJob(
                    n_ckpt, old.source_fn, old.cap,
                    old.executors[:old.n_local], old.exchange_key_fn,
                    old.executors[old.n_local:], old.device)
            self.states = states
            restore_source(self.reader, src_state)
            return
        if not self.checkpoints:
            self.states = self.sharded.init_states()
            if hasattr(self.reader, "offset"):
                self.reader.offset = 0
            return
        snap = self.checkpoints[-1]
        self.states = self._shadow.restore()
        restore_source(self.reader, snap.source_state)

    def rescale(self, new_n: int) -> None:
        raise NotImplementedError(
            "online rescale (ALTER ... SET PARALLELISM) is a later slice of "
            "the port, with cluster/scale's vnode, gate and handover")

    def mv_rows(self, mv_executor, state_index: int) -> list[tuple]:
        """Every lane's MV partition, merged on the host."""
        rows = []
        for s in range(self.sharded.n_shards):
            rows.extend(mv_executor.to_host(self.lanes.views[s][state_index]))
        return rows
