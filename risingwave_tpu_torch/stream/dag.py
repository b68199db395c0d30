"""DAG streaming runtime: fragments and joins under one barrier loop.

Port of ``DagJob`` from ``risingwave_tpu/stream/dag.py`` for one device,
without staging or a mesh: ``FragNode`` / ``JoinNode`` / ``SideNode``
(a two-input node without windows, driven by its ``apply(state, chunk,
side)``, :416-420, its counters flat on its state, :1055-1065: the
dynamic filter's ``FilterNode`` and the temporal join's
``TemporalJoinNode``, whose build table rehashes at maintenance,
:1141), ``_propagate`` and
``_apply_join_windowed`` (:406), ``run_chunk``, ``_compute_pulls``,
``chunk_round`` and ``run_chunks``, the barrier (``_flush_node``,
``_flush_all``, ``_node_watermarks``, ``_wm_all``, ``_upstream_wm``,
``_clean_joins``, ``_collect_counters``, ``_barrier_impl``,
``inject_barrier``), ``_maintain``, ``_commit_checkpoint``, ``recover``
and ``mv_rows``, and the aggregations' spill tiers
(``_drain_spill_tiers`` and ``_restore_spill_tiers``, :1214-1350; the
tiers are built with the job; the drain and the bookkeeping are
shared with ``StreamingJob`` in ``CheckpointPipelineMixin``, and a node
sends the drained changelog on through ``_propagate``): at every snapshot
barrier one host read of the fill counts decides which rings
drain into their host tier (``stream/spill.py``), whose changelog then
runs through the rest of the aggregation's node and downstream.
Topology changes (``add_source`` :227, ``remove_sources`` :233,
``add_nodes`` :242, ``remove_nodes`` :269, which leaves ``None`` in the
node list and the state tree, and ``reseed_checkpoint`` :294 with
``_snapshot_and_save`` :302) let the engine attach cascaded MVs and sinks
to a running job and drop them again; ``backfill_node`` (:1449, run
eagerly) replays the upstream MV's current rows through a new node; and
``_commit_checkpoint`` delivers the sinks (``_deliver_all_sinks`` :1192)
before the snapshot, or on the uploads' ack when the uploader is behind.
Staged plans and the mesh are not ported.  One scheduling difference
keeps the reference's states:
a table reader read only by temporal joins' build sides, with nothing
pending, is not pulled; the empty chunk it would return changes nothing
but the join's overflow copy, which ``apply_idle_right`` makes.

The reference traces a whole scheduling window into one program; here
the same steps run eagerly, in the same order, and the device work
stays asynchronous except for these host reads:

- one per join chunk with a consumer: the chunk's emission total, read
  after window 0 has propagated, decides how many further windows drain
  (the reference loops on the device); ``window_reads`` counts them;
- one per barrier: ``_clean_joins`` reads every join's rehash and
  compaction conditions in one readback (``barrier_reads``), plus one
  more on a barrier where a rebuild ran, to re-read that side's
  compaction condition;
- the flush drain of a fragment with pending output (none on q8's path)
  and the counters at maintenance, as in ``StreamingJob``;
- one per snapshot barrier of a job with spill-enabled aggregations:
  the rings' fill counts (``spill_reads``).

Checkpoints go through ``CheckpointPipelineMixin`` as in the port's
``StreamingJob`` (the reference's ``_snapshot_and_save`` :302 and
``recover`` :1367): every snapshot barrier seals the state tree into
the job's shadow with the readers' cursors (keyed by source name) and,
with a checkpoint store, uploads it in the background.
"""

from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import Any

import torch

from risingwave_tpu_torch.common.device import resolve_device
from risingwave_tpu_torch.common.epoch import EpochPair
from risingwave_tpu_torch.connector.dml import TableSourceReader
from risingwave_tpu_torch.stream.fragment import (
    COUNTER_ATTRS,
    WM_NONE,
    WM_SAFE_FLOOR,
    Fragment,
    collect_counters,
)
from risingwave_tpu_torch.stream.message import Watermark
from risingwave_tpu_torch.stream.runtime import (
    CheckpointPipelineMixin,
    CheckpointSnapshot,
    check_counter_values,
    deliver_sinks,
    restore_source,
)
from risingwave_tpu_torch.stream.watermark import WatermarkFilterExecutor

#: a dataflow edge endpoint: ("source", name) or ("node", node_id)
Ref = tuple
INT64_MIN = -(1 << 63)


@dataclass
class FragNode:
    """A fragment (executor chain) with one upstream input."""

    fragment: Fragment
    input: Ref

    def init_state(self, device):
        return self.fragment.init_states(device)


@dataclass
class JoinNode:
    """A two-input node: a hash join with windowed emission."""

    join: Any
    left: Ref
    right: Ref

    def init_state(self, device):
        return self.join.init_state(device)


class SideNode(JoinNode):
    """A two-input node that is not a hash join: driven by
    ``apply(state, chunk, side)``, its counters flat on its state, no
    windows and nothing to clean."""


class FilterNode(SideNode):
    """The dynamic filter (``stream/dynamic_filter.py``): nothing to
    rehash."""


class TemporalJoinNode(SideNode):
    """The temporal join (``stream/temporal_join.py``): ``"right"``
    upserts its build table and emits nothing, ``"left"`` probes it and
    sends its chunk on; the build table rehashes at maintenance."""


class DagJob(CheckpointPipelineMixin):
    """A streaming job over a DAG of fragments and joins.  ``nodes`` is a
    topological list: a node's inputs are sources or earlier nodes."""

    def __init__(self, sources: dict[str, Any], nodes: list,
                 name: str = "dag_job", checkpoint_frequency: int = 1,
                 device=None, checkpoint_store=None, states=None):
        self.sources = dict(sources)
        self.nodes: list = list(nodes)
        self.name = name
        self.device = resolve_device(device)
        self.checkpoint_frequency = checkpoint_frequency
        self.checkpoint_store = checkpoint_store
        self.maintenance_interval = 1
        self._ckpts_since_maintain = 0
        self.snapshot_interval = 1
        self._ckpts_since_snapshot = 0
        #: ``states`` adopts an existing state tree (a job upgraded in place)
        self.states = self._init_states() if states is None else states
        self.epoch = EpochPair.first()
        self.barriers_seen = 0
        self.checkpoints: list[CheckpointSnapshot] = []
        self.committed_epoch = 0
        self._init_pipeline()
        self.paused = False
        self._counters = None
        self.counter_labels: list[str] = []
        #: host reads of a join chunk's emission total
        self.window_reads = 0
        #: host reads of the barrier's rehash/compaction conditions (one
        #: per barrier, plus one per rebuild)
        self.barrier_reads = 0
        #: maintenance passes that fired, by kind (rebuild, rebuild_pool,
        #: compact_pool)
        self.rehash_fired: dict[str, int] = {}
        #: host reads of the spill rings' fill counts
        self.spill_reads = 0
        # one host tier per spill-enabled aggregation, keyed (node, exec)
        self._init_spill_tiers(self._spill_sites())
        self._rebuild()

    def _spill_sites(self) -> list:
        return [((idx, j), f"{idx}_{j}", ex)
                for idx, node in enumerate(self.nodes)
                if isinstance(node, FragNode)
                for j, ex in enumerate(node.fragment.executors)
                if getattr(ex, "spill_ring", 0)]

    def _rebuild(self) -> None:
        """Recompute the consumer map, the pulls and the idle build
        readers (after any topology change; a removed node is None)."""
        self._consumers: dict[Ref, list[int]] = {}
        for idx, node in enumerate(self.nodes):
            if node is None:
                continue
            refs = [node.input] if isinstance(node, FragNode) \
                else [node.left, node.right]
            for ref in refs:
                self._validate_ref(ref, idx)
                lst = self._consumers.setdefault(ref, [])
                if idx not in lst:
                    lst.append(idx)
        self._pulls = self._compute_pulls()
        #: sources read only by temporal joins' build sides: while such a
        #: reader has nothing pending its empty chunk is skipped (its only
        #: effect, the join's copied overflow, is applied instead)
        self._idle_builds = {}
        for name, src in self.sources.items():
            ref = ("source", name)
            users = self._consumers.get(ref, [])
            if isinstance(src, TableSourceReader) and users and all(
                    isinstance(self.nodes[i], TemporalJoinNode)
                    and self.nodes[i].right == ref != self.nodes[i].left
                    for i in users):
                self._idle_builds[name] = users

    def _init_states(self):
        return tuple(None if n is None else n.init_state(self.device)
                     for n in self.nodes)

    def _validate_ref(self, ref: Ref, at: int) -> None:
        kind, key = ref
        if kind == "source":
            if key not in self.sources:
                raise ValueError(f"node {at} references unknown source "
                                 f"{key!r}")
        elif kind == "node":
            if not 0 <= key < at or self.nodes[key] is None:
                raise ValueError(f"node {at} must reference an earlier "
                                 f"live node, got {key}")
        else:
            raise ValueError(f"bad ref {ref!r}")

    def downstream_closure(self, ref: Ref,
                           through_joins: bool = True) -> list[int]:
        """Node ids transitively consuming ``ref`` (topological order);
        with ``through_joins=False`` a join consumer is included but not
        passed through."""
        seen = set()
        frontier = [ref]
        while frontier:
            r = frontier.pop()
            for idx in self._consumers.get(r, ()):
                if idx in seen:
                    continue
                seen.add(idx)
                if through_joins or isinstance(self.nodes[idx], FragNode):
                    frontier.append(("node", idx))
        return sorted(seen)

    # -- chunk path -----------------------------------------------------
    def _propagate(self, new_states: list, injections) -> None:
        """Push chunks through the DAG in topological order (a source
        feeding both sides of a join delivers left first)."""
        inbox: dict[int, list] = {}

        def enqueue(ref, chunk):
            for idx in self._consumers.get(ref, ()):
                node = self.nodes[idx]
                if isinstance(node, FragNode):
                    inbox.setdefault(idx, []).append((chunk, None))
                else:
                    if node.left == ref:
                        inbox.setdefault(idx, []).append((chunk, "left"))
                    if node.right == ref:
                        inbox.setdefault(idx, []).append((chunk, "right"))

        for ref, chunk in injections:
            enqueue(ref, chunk)
        for idx, node in enumerate(self.nodes):
            if idx not in inbox:
                continue
            for chunk, side in inbox[idx]:
                if isinstance(node, FragNode):
                    new_states[idx], out = node.fragment.step(
                        new_states[idx], chunk)
                    if out is not None:
                        enqueue(("node", idx), out)
                else:
                    self._apply_join_windowed(new_states, idx, chunk, side)

    def _apply_join_windowed(self, new_states: list, idx: int, chunk,
                             side: str) -> None:
        """Drive a join with windowed emission: window 0 propagates
        first, then (after one host read of the emission total) the
        further windows, in order, each through the downstream nodes.  A
        SideNode applies the chunk and sends its output on."""
        join = self.nodes[idx].join
        if isinstance(self.nodes[idx], SideNode):
            new_states[idx], out = join.apply(new_states[idx], chunk, side)
            if out is not None:
                self._propagate(new_states, [(("node", idx), out)])
            return
        new_states[idx], pending = join.apply_begin(new_states[idx], chunk,
                                                    side)
        if not self._consumers.get(("node", idx)):
            return  # terminal join: emissions have no consumers
        build_rows = join.build_rows_of(new_states[idx], side)
        first, probe_bound = join.emit_window(build_rows, pending, 0, side)
        new_states[idx].emit_overflow.add_(probe_bound)
        self._propagate(new_states, [(("node", idx), first)])
        max_w = join.max_windows(chunk.capacity)
        if max_w <= 1:
            return
        total = int(pending.total)  # the one host read per join chunk
        self.window_reads += 1
        n_w = min(-(-total // join.out_capacity), max_w)
        for w in range(1, n_w):
            window, probe_bound = join.emit_window(build_rows, pending, w,
                                                   side)
            new_states[idx].emit_overflow.add_(probe_bound)
            self._propagate(new_states, [(("node", idx), window)])

    def run_chunk(self, src_name: str) -> int:
        """Pull one chunk from one source through its reachable nodes."""
        if self.paused:
            return 0
        reader = self.sources[src_name]
        new_states = list(self.states)
        idle = self._idle_builds.get(src_name)
        if idle and reader.pending() == 0:
            for idx in idle:
                new_states[idx] = self.nodes[idx].join.apply_idle_right(
                    new_states[idx])
            self.states = tuple(new_states)
            return reader.cap
        chunk = reader.next_chunk()
        self._propagate(new_states, [(("source", src_name), chunk)])
        self.states = tuple(new_states)
        return chunk.capacity

    def _compute_pulls(self) -> list[tuple[str, int]]:
        """Chunks pulled per scheduling round per source: sources whose
        rows sweep event time faster pull proportionally fewer chunks."""
        names = list(self.sources)
        eprs = []
        for n in names:
            epr = getattr(self.sources[n], "events_per_row", None)
            if epr is None:
                return [(n, 1) for n in names]
            eprs.append(Fraction(epr))
        inv = [1 / e for e in eprs]
        lo = min(inv)
        pulls = []
        for n, f in zip(names, inv):
            ratio = f / lo
            if ratio.denominator != 1 or ratio.numerator > 16:
                return [(n, 1) for n in names]
            pulls.append((n, int(ratio)))
        return pulls

    def chunk_round(self) -> int:
        """One scheduling round: pull each source by its pacing ratio."""
        rows = 0
        for name, k in self._pulls:
            for _ in range(k):
                rows += self.run_chunk(name)
        return rows

    def run_chunks(self, n: int) -> int:
        """``n`` scheduling rounds (the reference fuses them into one
        program; the chunks and their order are the same)."""
        if self.paused or n <= 0:
            return 0
        return sum(self.chunk_round() for _ in range(n))

    # -- barrier --------------------------------------------------------
    def _flush_node(self, new_states: list, idx: int, epoch) -> None:
        """Flush one fragment node; emissions cross downstream nodes,
        re-flushing while the node reports pending output."""
        frag = self.nodes[idx].fragment
        for rounds in range(frag.MAX_DRAIN_ROUNDS + 1):
            if rounds:
                tot = frag.pending_total(new_states[idx])
                if tot is None or int(tot) == 0:
                    break
            st, outs = frag.flush(new_states[idx], epoch)
            new_states[idx] = st
            for out in outs:
                self._propagate(new_states, [(("node", idx), out)])
            if frag.pending_total(st) is None:
                break

    def _flush_all(self, new_states: list, epoch) -> None:
        for idx, node in enumerate(self.nodes):
            if isinstance(node, FragNode):
                self._flush_node(new_states, idx, epoch)

    def _node_watermarks(self, new_states: list, idx: int):
        """(Watermark, has) device pairs of a fragment node's filters."""
        out = []
        for i, ex in enumerate(self.nodes[idx].fragment.executors):
            if not isinstance(ex, WatermarkFilterExecutor):
                continue
            raw = new_states[idx][i].max_ts
            has = raw != WM_NONE
            val = torch.where(has, raw - ex.delay_us,
                              torch.full_like(raw, WM_SAFE_FLOOR))
            out.append((Watermark(ex.ts_col, val), has))
        return out

    def _wm_all(self, new_states: list) -> None:
        """Watermarks within each fragment, then across node boundaries
        to downstream fragment nodes; joins block propagation."""
        for idx, node in enumerate(self.nodes):
            if not isinstance(node, FragNode):
                continue
            new_states[idx] = node.fragment._propagate_watermarks(
                new_states[idx])
            for wm, _ in self._node_watermarks(new_states, idx):
                for j in self.downstream_closure(("node", idx),
                                                 through_joins=False):
                    dn = self.nodes[j]
                    if isinstance(dn, FragNode):
                        new_states[j] = dn.fragment.on_watermark(
                            new_states[j], wm)

    def _upstream_wm(self, new_states: list, ref: Ref, src_col: int):
        """Walk a join input upstream to its watermark filter on
        ``src_col``: (value, has) device scalars, or None."""
        while True:
            kind, key = ref
            if kind == "source":
                return None
            node = self.nodes[key]
            if not isinstance(node, FragNode):
                return None
            for i, ex in enumerate(node.fragment.executors):
                if isinstance(ex, WatermarkFilterExecutor) \
                        and ex.ts_col == src_col:
                    raw = new_states[key][i].max_ts
                    has = raw != WM_NONE
                    val = torch.where(has, raw - ex.delay_us,
                                      torch.full_like(raw, WM_SAFE_FLOOR))
                    return val, has
            ref = node.input

    def _clean_joins(self, new_states: list) -> None:
        """Watermark cleaning of windowed joins by the MIN watermark of
        both inputs, then ``maybe_rehash``.  The reference's
        ``lax.cond(has_all, ...)`` becomes a threshold that cleans
        nothing while a watermark is missing, and the rehash conditions
        (false without one) are read in one readback for all joins."""
        plans = []
        for idx, node in enumerate(self.nodes):
            if not isinstance(node, JoinNode) or isinstance(node, SideNode):
                continue
            join = node.join
            wms = []
            ok = True
            for side, ref in (("left", node.left), ("right", node.right)):
                clean = getattr(join, f"{side}_clean", None)
                if clean is None:
                    continue
                wm = self._upstream_wm(new_states, ref, clean[2])
                if wm is None:
                    ok = False
                    break
                wms.append(wm)
            if not ok or not wms:
                continue
            has_all = wms[0][1]
            min_wm = wms[0][0]
            for val, has in wms[1:]:
                has_all = has_all & has
                min_wm = torch.minimum(min_wm, val)
            stats = {}
            for side in ("left", "right"):
                clean = getattr(join, f"{side}_clean", None)
                if clean is None:
                    continue
                _, lag, _ = clean
                thr = torch.where(has_all, min_wm - lag,
                                  torch.full_like(min_wm, INT64_MIN))
                stats[side] = join.clean_side(new_states[idx], side, thr)
            conds = join.rehash_decisions(new_states[idx], stats) & has_all
            plans.append((idx, conds))
        if not plans:
            return
        flat = torch.cat([c for _, c in plans]).tolist()  # one readback
        self.barrier_reads += 1
        for k, (idx, _) in enumerate(plans):
            decisions = [bool(v) for v in flat[4 * k: 4 * k + 4]]
            if any(decisions):
                rebuilds = self.rehash_fired.get("rebuild_pool", 0)
                new_states[idx] = self.nodes[idx].join.apply_rehash(
                    new_states[idx], decisions, self.rehash_fired)
                # each rebuild re-reads its side's compaction condition
                self.barrier_reads += \
                    self.rehash_fired.get("rebuild_pool", 0) - rebuilds

    def _collect_counters(self, new_states: list):
        labels: list[str] = []
        vals: list[torch.Tensor] = []
        for idx, node in enumerate(self.nodes):
            if isinstance(node, FragNode):
                sub_labels, sub = collect_counters(node.fragment.executors,
                                                   new_states[idx])
                labels.extend(f"n{idx}.{x}" for x in sub_labels)
                if sub is not None:
                    vals.append(sub)
                continue
            if node is None:
                continue
            jstate = new_states[idx]
            if isinstance(node, SideNode):
                for attr in COUNTER_ATTRS:
                    if hasattr(jstate, attr):
                        labels.append(f"n{idx}.dynfilter.{attr}")
                        vals.append(getattr(jstate, attr).to(
                            torch.int64)[None])
                continue
            for side_name in ("left", "right"):
                s = getattr(jstate, side_name)
                for attr in COUNTER_ATTRS:
                    if hasattr(s, attr):
                        labels.append(f"n{idx}.join.{side_name}.{attr}")
                        vals.append(getattr(s, attr).to(torch.int64)[None])
            labels.append(f"n{idx}.join.emit_overflow")
            vals.append(jstate.emit_overflow.to(torch.int64)[None])
        counters = torch.cat(vals) if vals else \
            torch.zeros(0, dtype=torch.int64, device=self.device)
        return labels, counters

    def _barrier_impl(self, states, epoch):
        new_states = list(states)
        self._flush_all(new_states, epoch)
        # watermarks advance, then a second flush pass
        self._wm_all(new_states)
        self._flush_all(new_states, epoch)
        self._clean_joins(new_states)
        labels, counters = self._collect_counters(new_states)
        self.counter_labels = labels
        return tuple(new_states), counters

    def inject_barrier(self) -> None:
        self.barriers_seen += 1
        sealed = self.epoch.curr.value
        self.states, self._counters = self._barrier_impl(self.states, sealed)
        if self.barriers_seen % self.checkpoint_frequency == 0:
            self._ckpts_since_maintain += 1
            if self._ckpts_since_maintain >= self.maintenance_interval:
                self._maintain(sealed)
                self._ckpts_since_maintain = 0
            self._ckpts_since_snapshot += 1
            if self._ckpts_since_snapshot >= self.snapshot_interval:
                self._ckpts_since_snapshot = 0
                self._commit_checkpoint(sealed)
        self._process_upload_acks()
        self.epoch = self.epoch.bump()

    # -- maintenance ----------------------------------------------------
    def _maintain_impl(self, states):
        new_states = list(states)
        for idx, node in enumerate(self.nodes):
            if isinstance(node, FragNode):
                new_states[idx] = node.fragment.maintain(new_states[idx])
            elif node is not None and not isinstance(node, FilterNode):
                new_states[idx] = node.join.maybe_rehash(new_states[idx])
        return tuple(new_states)

    def _maintain(self, sealed) -> None:
        """Rehash + the counters readback (the maintenance sync)."""
        self.states = self._maintain_impl(self.states)
        if self._counters is None:
            return
        residual = check_counter_values(self.name, self.counter_labels,
                                        self._counters.cpu().numpy())
        for _ in range(64):
            if not residual:
                break
            self.states, self._counters = self._barrier_impl(self.states,
                                                             sealed)
            residual = check_counter_values(self.name, self.counter_labels,
                                            self._counters.cpu().numpy())

    # -- checkpoint / recovery ------------------------------------------
    def _source_states(self) -> dict:
        return {name: (src.state() if hasattr(src, "state") else {})
                for name, src in self.sources.items()}

    def _deliver_all_sinks(self, epoch_val) -> None:
        new_states = list(self.states)
        for idx, node in enumerate(self.nodes):
            if isinstance(node, FragNode):
                new_states[idx] = deliver_sinks(node.fragment,
                                                new_states[idx], epoch_val)
        self.states = tuple(new_states)

    def _commit_checkpoint(self, sealed) -> None:
        """Drain the spill rings into their tiers, deliver the sinks (or
        defer them to the uploads' ack), then seal the epoch with the
        readers' cursors and the tiers' states."""
        self._drain_spill_tiers(sealed)
        self._deliver_or_defer(sealed)
        self._snapshot_and_save(sealed)

    def _snapshot_and_save(self, epoch: int) -> None:
        """The checkpoint tail shared by the barrier commit and the
        topology reseed: the shadow update and the durable upload."""
        self._snapshot_commit(epoch, self._source_states(),
                              *self._spill_snapshot())

    # -- topology changes -------------------------------------------------
    def add_source(self, name: str, reader) -> None:
        if name in self.sources:
            raise ValueError(f"source {name!r} already attached")
        self.sources[name] = reader
        self._rebuild()

    def remove_sources(self, names: list[str]) -> None:
        """Detach sources (a dropped MV's private readers).  Refuses
        while any live node still consumes one."""
        for name in names:
            if self._consumers.get(("source", name)):
                raise ValueError(f"source {name!r} still has consumers")
            self.sources.pop(name, None)
        self._rebuild()

    def add_nodes(self, nodes: list) -> list[int]:
        """Attach new nodes (a cascaded MV's or a sink's fragment);
        returns their ids.  Existing states are kept; the new nodes start
        empty, and callers backfill them (``backfill_node``)."""
        ids = []
        states = list(self.states)
        for n in nodes:
            self.nodes.append(n)
            states.append(n.init_state(self.device))
            ids.append(len(self.nodes) - 1)
        self.states = tuple(states)
        self._sync_spill_tiers()
        self._rebuild()
        return ids

    def remove_nodes(self, ids: list[int]) -> None:
        """Tombstone nodes (a dropped MV or sink).  Refuses while live
        consumers remain, as the reference rejects dropping an MV with
        dependents."""
        drop = set(ids)
        for idx, node in enumerate(self.nodes):
            if node is None or idx in drop:
                continue
            refs = [node.input] if isinstance(node, FragNode) \
                else [node.left, node.right]
            for kind, key in refs:
                if kind == "node" and key in drop:
                    raise ValueError(f"node {key} still feeds node {idx} "
                                     "(drop dependents first)")
        states = list(self.states)
        for i in drop:
            self.nodes[i] = None
            states[i] = None
        self.states = tuple(states)
        self._sync_spill_tiers()
        self._rebuild()

    def _sync_spill_tiers(self) -> None:
        """A tier for every spill-enabled aggregation of a new node; the
        tiers of removed nodes go."""
        sites = {key: (suffix, ex) for key, suffix, ex in self._spill_sites()}
        for key in [k for k in self._spill_tiers if k not in sites]:
            del self._spill_tiers[key]
        for key, (suffix, ex) in sites.items():
            if key not in self._spill_tiers:
                self._spill_tiers[key] = (suffix, self._spill_tier(ex))

    def reseed_checkpoint(self) -> None:
        """Re-snapshot after a topology change: the retained checkpoints
        hold the old state tree (and the old source names), so a recover
        before the next commit would restore a tree that no longer fits.
        The shadow re-bases (the tree changed shape) and, with a store,
        the epoch is saved again in full."""
        self._snapshot_and_save(self.committed_epoch)

    # -- backfill -----------------------------------------------------------
    def backfill_node(self, node_id: int, chunks,
                      side: str | None = None) -> None:
        """Feed snapshot chunks through ONE node and everything
        downstream of it (a freshly attached cascade consuming the
        upstream MV's current rows, the reference's :1449 with
        arrangement backfill collapsed to a snapshot replay); ``side``
        names a join node's side.  The chunk's columns are the upstream
        MV's own stores: nothing here writes them."""
        for chunk in chunks:
            new_states = list(self.states)
            node = self.nodes[node_id]
            if isinstance(node, FragNode):
                new_states[node_id], out = node.fragment.step(
                    new_states[node_id], chunk)
                if out is not None:
                    self._propagate(new_states, [(("node", node_id), out)])
            else:
                self._apply_join_windowed(new_states, node_id, chunk, side)
            self.states = tuple(new_states)

    # the spill drain's view of a node: its states and executors, and
    # the drained changelog's way downstream
    def _node_states(self, idx):
        return self.states[idx]

    def _node_executors(self, idx):
        return self.nodes[idx].fragment.executors

    def _spill_downstream(self, idx, node_states, out) -> None:
        new_states = list(self.states)
        new_states[idx] = node_states
        if out is not None:
            self._propagate(new_states, [(("node", idx), out)])
        self.states = tuple(new_states)

    def recover(self, epoch: int | None = None) -> None:
        """Reset to the last committed checkpoint (states and readers):
        the durable store's, else the shadow, else the initial state."""
        loaded = self._recover_pipeline(epoch)
        if loaded is not None:
            epoch_v, self.states, src_state = loaded
            for name, src in self.sources.items():
                restore_source(src, src_state.get(name, {}))
            self._rewind_spill_tiers(epoch_v)
            return
        if not self.checkpoints:
            self.states = self._init_states()
            for src in self.sources.values():
                if hasattr(src, "offset"):
                    src.offset = 0
            self._restore_spill_tiers(None)
            return
        snap = self.checkpoints[-1]
        self.states = self._shadow.restore()
        for name, src in self.sources.items():
            restore_source(src, snap.source_state.get(name, {}))
        self._restore_spill_tiers(snap)

    def mv_rows(self, mv_executor, state_index) -> list[tuple]:
        st = self.states
        for i in state_index:
            st = st[i]
        return mv_executor.to_host(st)

