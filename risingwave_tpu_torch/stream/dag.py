"""DAG streaming runtime: fragments and joins under one barrier loop.

Port of ``DagJob`` from ``risingwave_tpu/stream/dag.py`` for one device,
without staging: ``FragNode`` / ``JoinNode`` / ``SideNode``
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
tiers are built with the job; the bookkeeping is shared with
``StreamingJob`` in ``CheckpointPipelineMixin``, and a node sends the
drained changelog on through ``_propagate``): at every snapshot
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
Staged plans are not ported.  One scheduling difference keeps the
reference's states: a table reader read only by temporal joins' build
sides, with nothing pending, is not pulled; the empty chunk it would
return changes nothing but the join's overflow copy, which
``apply_idle_right`` makes.

The mesh (``DagJob(..., lanes=N, exchanges=...)``, the reference's
``mesh`` branches): the states are the stacked tree (every leaf ``[N,
...]``, ``stream/sharded.py``'s layout) and every traversal runs on its
lane views (``_Lanes``), all lanes node by node in topological order.
The reference runs the whole subgraph per shard inside ``shard_map``, its
exchanges (:397) collectives; here a marked edge collects the N lanes'
chunks as they are enqueued, runs one ``shuffle_chunk`` (K2 + K24) and
delivers each lane its received chunk, so every lane's inbox order is
the reference's per-shard order.  The trip counts are the reference's
``pmax``: a join chunk drains the max over the lanes of its windows
(:444) and a flush drain keeps every lane in while any lane has rows
pending (:897); idle lanes emit and flush empty.  Watermarks are the min
over the lanes (``pmin``, :939).  A generated source reads one
``next_base()`` block a lane; a host-chunk source (a table) enters on
lane 0 and the other lanes get an all-zero chunk of its shape.  Counters
are summed over the lanes; spill tiers are per lane (``_s{s}`` keys);
the shadow digests in lanes (K11 lanes, ``_shadow_shard_rows``);
``recover`` takes the checkpoint's lane count up to the engine's;
``mv_rows`` merges the lanes and ``backfill_node`` replays each lane's
partition of a stacked snapshot chunk.  A linear job is one lane
(``_OneLane``) through the same code.

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

from risingwave_tpu_torch.common.chunk import Chunk
from risingwave_tpu_torch.common.device import resolve_device
from risingwave_tpu_torch.common.epoch import EpochPair
from risingwave_tpu_torch.common.tree import flatten, tree_map
from risingwave_tpu_torch.connector.dml import TableSourceReader
from risingwave_tpu_torch.parallel.exchange import shuffle_chunk
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
from risingwave_tpu_torch.stream.sharded import _Lanes, stack_trees
from risingwave_tpu_torch.stream.spill import chunk_to
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


class _OneLane:
    """A linear job's node states as one lane: ``views[0]`` is the node
    list the traversal updates (``put`` assigns)."""

    def __init__(self, states):
        self.views = [list(states)]

    def put(self, s: int, states, first: int = 0) -> None:
        for e, st in enumerate(states, start=first):
            self.views[0][e] = st


def _lane_chunk(chunk: Chunk, s: int) -> Chunk:
    """Lane ``s`` of a lane-stacked chunk (leaves ``[lanes, cap, ...]``)."""
    return Chunk(tree_map(lambda x: x[s], chunk.columns), chunk.ops[s],
                 chunk.valid[s], chunk.schema)


def _zero_chunk(chunk: Chunk) -> Chunk:
    """An all-zero chunk of ``chunk``'s shape: every payload 0, op 0, not
    valid (the reference's ``np.zeros_like`` of a host chunk)."""
    return Chunk(tree_map(torch.zeros_like, chunk.columns),
                 torch.zeros_like(chunk.ops), torch.zeros_like(chunk.valid),
                 chunk.schema)


class DagJob(CheckpointPipelineMixin):
    """A streaming job over a DAG of fragments and joins.  ``nodes`` is a
    topological list: a node's inputs are sources or earlier nodes.

    ``lanes=N`` (N > 1) runs the DAG vnode-sharded over N lanes of the
    device: ``states`` are the stacked tree (every leaf ``[N, ...]``) and
    ``exchanges[(node id, side)] -> key_fn`` marks the edges whose chunks
    re-route to their key's lane (side None for a fragment's input)."""

    def __init__(self, sources: dict[str, Any], nodes: list,
                 name: str = "dag_job", checkpoint_frequency: int = 1,
                 device=None, checkpoint_store=None, states=None,
                 lanes: int = 1, exchanges: dict | None = None,
                 max_lanes: int | None = None):
        self.sources = dict(sources)
        self.nodes: list = list(nodes)
        self.name = name
        self.device = resolve_device(device)
        self.n_shards = lanes
        #: the lanes the engine has (a checkpoint of more cannot load)
        self.max_lanes = max_lanes or lanes
        self.exchanges = dict(exchanges or {})
        self.checkpoint_frequency = checkpoint_frequency
        self.checkpoint_store = checkpoint_store
        self.maintenance_interval = 1
        self._ckpts_since_maintain = 0
        self.snapshot_interval = 1
        self._ckpts_since_snapshot = 0
        self._lanes = None
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
        #: host reads of a join chunk's emission total (all lanes at once)
        self.window_reads = 0
        #: host reads of the barrier's rehash/compaction conditions (one
        #: per barrier, plus one per rebuild)
        self.barrier_reads = 0
        #: maintenance passes that fired, by kind (rebuild, rebuild_pool,
        #: compact_pool), over every lane
        self.rehash_fired: dict[str, int] = {}
        #: host reads of the spill rings' fill counts
        self.spill_reads = 0
        # one host tier per spill-enabled aggregation (and lane)
        self._init_spill_tiers(self._spill_sites())
        self._rebuild()

    # -- the state tree and its lanes -----------------------------------
    @property
    def states(self):
        return self._states

    @states.setter
    def states(self, value) -> None:
        self._states = value
        self._lanes = None

    @property
    def lanes(self) -> _Lanes:
        """Lane views of the stacked tree (a sharded job's)."""
        if self._lanes is None:
            self._lanes = _Lanes(self._states, self.n_shards)
        return self._lanes

    def _open(self):
        """The states as lanes for one traversal: the stacked tree's views
        (updated in place) or a linear job's node list."""
        return self.lanes if self.n_shards > 1 else _OneLane(self.states)

    def _close(self, lanes) -> None:
        if self.n_shards == 1:
            self.states = tuple(lanes.views[0])

    def _lane_max(self, values) -> int:
        """The max of per-lane device scalars (one host read)."""
        if len(values) == 1:
            return int(values[0])
        return int(torch.stack(values).max())

    @staticmethod
    def _lane_min(values):
        """The min over the lanes of a device scalar (the reference's
        ``lax.pmin``)."""
        return values[0] if len(values) == 1 else torch.stack(values).min()

    def _spill_sites(self) -> list:
        lanes = range(self.n_shards) if self.n_shards > 1 else (None,)
        return [((idx, j) if s is None else (idx, j, s),
                 f"{idx}_{j}" if s is None else f"{idx}_{j}_s{s}", ex)
                for idx, node in enumerate(self.nodes)
                if isinstance(node, FragNode)
                for j, ex in enumerate(node.fragment.executors)
                if getattr(ex, "spill_ring", 0)
                for s in lanes]

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

    def _node_state(self, node):
        """A new node's state: per lane, stacked on the lane axis."""
        if self.n_shards == 1:
            return node.init_state(self.device)
        return stack_trees([node.init_state(self.device)
                            for _ in range(self.n_shards)])

    def _init_states(self):
        return tuple(None if n is None else self._node_state(n)
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
    def _exchange(self, idx: int, side, chunks: list) -> list:
        """Every lane's chunk across the hash exchange of a marked edge
        (K2 + K24), else as it is."""
        fn = self.exchanges.get((idx, side))
        if fn is None or self.n_shards == 1:
            return chunks
        return shuffle_chunk(chunks, [fn(c) for c in chunks])

    def _step_node(self, lanes, idx: int, chunks: list) -> list:
        """A fragment node's step on every lane; returns the outputs."""
        frag = self.nodes[idx].fragment
        outs = []
        for s, chunk in enumerate(chunks):
            st, out = frag.step(lanes.views[s][idx], chunk)
            lanes.put(s, (st,), idx)
            outs.append(out)
        return outs

    def _propagate(self, lanes, injections) -> None:
        """Push every lane's chunks through the DAG in topological order,
        all lanes node by node (a source feeding both sides of a join
        delivers left first); a marked edge exchanges the lanes' chunks
        as they are enqueued, as the reference's ``_exchange`` (:397)."""
        inbox: dict[int, list] = {}

        def enqueue(ref, chunks):
            for idx in self._consumers.get(ref, ()):
                node = self.nodes[idx]
                if isinstance(node, FragNode):
                    inbox.setdefault(idx, []).append(
                        (self._exchange(idx, None, chunks), None))
                else:
                    for side in ("left", "right"):
                        if getattr(node, side) == ref:
                            inbox.setdefault(idx, []).append(
                                (self._exchange(idx, side, chunks), side))

        for ref, chunks in injections:
            enqueue(ref, chunks)
        for idx, node in enumerate(self.nodes):
            if idx not in inbox:
                continue
            for chunks, side in inbox[idx]:
                if isinstance(node, FragNode):
                    outs = self._step_node(lanes, idx, chunks)
                    if outs[0] is not None:
                        enqueue(("node", idx), outs)
                else:
                    self._apply_join_windowed(lanes, idx, chunks, side)

    def _apply_join_windowed(self, lanes, idx: int, chunks: list,
                             side: str) -> None:
        """Drive a join with windowed emission: window 0 propagates
        first, then (after one host read of the emission total, the max
        over the lanes: every lane runs the same windows, an idle lane's
        empty) the further windows, in order, each through the downstream
        nodes.  A SideNode applies the chunk and sends its output on."""
        join = self.nodes[idx].join
        n = len(chunks)
        if isinstance(self.nodes[idx], SideNode):
            outs = []
            for s, chunk in enumerate(chunks):
                st, out = join.apply(lanes.views[s][idx], chunk, side)
                lanes.put(s, (st,), idx)
                outs.append(out)
            if outs[0] is not None:
                self._propagate(lanes, [(("node", idx), outs)])
            return
        pending = []
        for s, chunk in enumerate(chunks):
            st, p = join.apply_begin(lanes.views[s][idx], chunk, side)
            lanes.put(s, (st,), idx)
            pending.append(p)
        if not self._consumers.get(("node", idx)):
            return  # terminal join: emissions have no consumers
        build = [join.build_rows_of(lanes.views[s][idx], side)
                 for s in range(n)]

        def window(w: int) -> None:
            outs = []
            for s in range(n):
                out, probe_bound = join.emit_window(build[s], pending[s], w,
                                                    side)
                lanes.views[s][idx].emit_overflow.add_(probe_bound)
                outs.append(out)
            self._propagate(lanes, [(("node", idx), outs)])

        window(0)
        max_w = join.max_windows(chunks[0].capacity)
        if max_w <= 1:
            return
        # the one host read per join chunk
        total = self._lane_max([p.total for p in pending])
        self.window_reads += 1
        for w in range(1, min(-(-total // join.out_capacity), max_w)):
            window(w)

    def run_chunk(self, src_name: str) -> int:
        """Pull one chunk from one source (one a lane) through its
        reachable nodes.  A sharded job's generated source reads one
        ``next_base()`` block a lane; a host-chunk source (a table) enters
        on lane 0, the other lanes an all-zero chunk."""
        if self.paused:
            return 0
        reader = self.sources[src_name]
        lanes = self._open()
        if self.n_shards > 1:
            if hasattr(reader, "impl") and hasattr(reader, "next_base"):
                bases = [reader.next_base() for _ in range(self.n_shards)]
                chunks = [reader.impl(k0, reader.cap) for k0 in bases]
                rows = reader.cap * self.n_shards
            else:
                chunk = reader.next_chunk()
                chunks = [chunk] + [_zero_chunk(chunk)] * (self.n_shards - 1)
                rows = chunk.capacity
            self._propagate(lanes, [(("source", src_name), chunks)])
            return rows
        idle = self._idle_builds.get(src_name)
        if idle and reader.pending() == 0:
            for idx in idle:
                lanes.put(0, (self.nodes[idx].join.apply_idle_right(
                    lanes.views[0][idx]),), idx)
            self._close(lanes)
            return reader.cap
        chunk = reader.next_chunk()
        self._propagate(lanes, [(("source", src_name), [chunk])])
        self._close(lanes)
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
    def _pending_max(self, frag, lanes, idx: int) -> int | None:
        tots = [frag.pending_total(v[idx]) for v in lanes.views]
        return None if tots[0] is None else self._lane_max(tots)

    def _flush_node(self, lanes, idx: int, epoch) -> None:
        """Flush one fragment node on every lane; emissions cross
        downstream nodes, re-flushing every lane while any lane reports
        pending output (the reference's ``pmax``)."""
        frag = self.nodes[idx].fragment
        for rounds in range(frag.MAX_DRAIN_ROUNDS + 1):
            if rounds:
                tot = self._pending_max(frag, lanes, idx)
                if not tot:
                    break
            outs = []
            for s, v in enumerate(lanes.views):
                st, o = frag.flush(v[idx], epoch)
                lanes.put(s, (st,), idx)
                outs.append(o)
            for k in range(len(outs[0])):
                self._propagate(lanes, [(("node", idx), [o[k] for o in outs])])
            if frag.pending_total(lanes.views[0][idx]) is None:
                break

    def _flush_all(self, lanes, epoch) -> None:
        for idx, node in enumerate(self.nodes):
            if isinstance(node, FragNode):
                self._flush_node(lanes, idx, epoch)

    def _wm_value(self, lanes, idx: int, i: int, ex):
        """(value, has) of watermark filter ``i`` of node ``idx``: its
        max_ts, the min over the lanes, less the delay."""
        raw = self._lane_min([v[idx][i].max_ts for v in lanes.views])
        has = raw != WM_NONE
        val = torch.where(has, raw - ex.delay_us,
                          torch.full_like(raw, WM_SAFE_FLOOR))
        return val, has

    def _node_watermarks(self, lanes, idx: int) -> list:
        """The watermarks of a fragment node's filters (device values)."""
        return [Watermark(ex.ts_col, self._wm_value(lanes, idx, i, ex)[0])
                for i, ex in enumerate(self.nodes[idx].fragment.executors)
                if isinstance(ex, WatermarkFilterExecutor)]

    def _on_watermark(self, lanes, idx: int, wm) -> None:
        frag = self.nodes[idx].fragment
        for s, v in enumerate(lanes.views):
            lanes.put(s, (frag.on_watermark(v[idx], wm),), idx)

    def _wm_all(self, lanes) -> None:
        """Watermarks within each fragment (the fragment's own pass, with
        the min over the lanes), then across node boundaries to
        downstream fragment nodes; joins block propagation."""
        for idx, node in enumerate(self.nodes):
            if not isinstance(node, FragNode):
                continue
            for i, ex in enumerate(node.fragment.executors):
                if isinstance(ex, WatermarkFilterExecutor):
                    val, _ = self._wm_value(lanes, idx, i, ex)
                    self._on_watermark(lanes, idx, Watermark(ex.ts_col, val))
            for wm in self._node_watermarks(lanes, idx):
                for j in self.downstream_closure(("node", idx),
                                                 through_joins=False):
                    if isinstance(self.nodes[j], FragNode):
                        self._on_watermark(lanes, j, wm)

    def _upstream_wm(self, lanes, ref: Ref, src_col: int):
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
                    return self._wm_value(lanes, key, i, ex)
            ref = node.input

    def _clean_joins(self, lanes) -> None:
        """Watermark cleaning of windowed joins by the MIN watermark of
        both inputs (over the lanes), then ``maybe_rehash`` on every lane.
        The reference's ``lax.cond(has_all, ...)`` becomes a threshold
        that cleans nothing while a watermark is missing, and the rehash
        conditions (false without one) of every join and lane are read in
        one readback."""
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
                wm = self._upstream_wm(lanes, ref, clean[2])
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
            for s, v in enumerate(lanes.views):
                stats = {}
                for side in ("left", "right"):
                    clean = getattr(join, f"{side}_clean", None)
                    if clean is None:
                        continue
                    _, lag, _ = clean
                    thr = torch.where(has_all, min_wm - lag,
                                      torch.full_like(min_wm, INT64_MIN))
                    stats[side] = join.clean_side(v[idx], side, thr)
                conds = join.rehash_decisions(v[idx], stats) & has_all
                plans.append((idx, s, conds))
        if not plans:
            return
        flat = torch.cat([c for _, _, c in plans]).tolist()  # one readback
        self.barrier_reads += 1
        for k, (idx, s, _) in enumerate(plans):
            decisions = [bool(v) for v in flat[4 * k: 4 * k + 4]]
            if any(decisions):
                rebuilds = self.rehash_fired.get("rebuild_pool", 0)
                lanes.put(s, (self.nodes[idx].join.apply_rehash(
                    lanes.views[s][idx], decisions, self.rehash_fired),),
                    idx)
                # each rebuild re-reads its side's compaction condition
                self.barrier_reads += \
                    self.rehash_fired.get("rebuild_pool", 0) - rebuilds

    def _lane_counters(self, states) -> tuple[list[str], list]:
        """(labels, int64 device vectors) of one lane's node states."""
        labels: list[str] = []
        vals: list[torch.Tensor] = []
        for idx, node in enumerate(self.nodes):
            if isinstance(node, FragNode):
                sub_labels, sub = collect_counters(node.fragment.executors,
                                                   states[idx])
                labels.extend(f"n{idx}.{x}" for x in sub_labels)
                if sub is not None:
                    vals.append(sub)
                continue
            if node is None:
                continue
            jstate = states[idx]
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
        return labels, vals

    def _collect_counters(self, lanes):
        """Every counter, summed over the lanes (one device vector)."""
        per_lane = []
        labels: list[str] = []
        for v in lanes.views:
            labels, vals = self._lane_counters(v)
            per_lane.append(torch.cat(vals) if vals else
                            torch.zeros(0, dtype=torch.int64,
                                        device=self.device))
        counters = per_lane[0] if len(per_lane) == 1 \
            else torch.stack(per_lane).sum(0)
        return labels, counters

    def _barrier(self, epoch) -> None:
        lanes = self._open()
        self._flush_all(lanes, epoch)
        # watermarks advance, then a second flush pass
        self._wm_all(lanes)
        self._flush_all(lanes, epoch)
        self._clean_joins(lanes)
        self.counter_labels, self._counters = self._collect_counters(lanes)
        self._close(lanes)

    def inject_barrier(self) -> None:
        self.barriers_seen += 1
        sealed = self.epoch.curr.value
        self._barrier(sealed)
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
    def _maintain_impl(self) -> None:
        lanes = self._open()
        for idx, node in enumerate(self.nodes):
            for s, v in enumerate(lanes.views):
                if isinstance(node, FragNode):
                    lanes.put(s, (node.fragment.maintain(v[idx]),), idx)
                elif node is not None and not isinstance(node, FilterNode):
                    lanes.put(s, (node.join.maybe_rehash(v[idx]),), idx)
        self._close(lanes)

    def _maintain(self, sealed) -> None:
        """Rehash + the counters readback (the maintenance sync)."""
        self._maintain_impl()
        if self._counters is None:
            return
        residual = check_counter_values(self.name, self.counter_labels,
                                        self._counters.cpu().numpy())
        for _ in range(64):
            if not residual:
                break
            self._barrier(sealed)
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
        defer them to the uploads' ack; a sharded job has none), then
        seal the epoch with the readers' cursors and the tiers' states."""
        self._drain_spill_tiers(sealed)
        if self.n_shards == 1:
            self._deliver_or_defer(sealed)
        self._snapshot_and_save(sealed)

    def _snapshot_and_save(self, epoch: int) -> None:
        """The checkpoint tail shared by the barrier commit and the
        topology reseed: the shadow update and the durable upload."""
        self._snapshot_commit(epoch, self._source_states(),
                              *self._spill_snapshot())

    def _shadow_shard_rows(self) -> int | None:
        """A sharded job's stacked tree digests in lanes (K11 lanes)."""
        return self.n_shards if self.n_shards > 1 else None

    def _tier(self, idx: int, j: int, s: int):
        """Lane ``s``'s host tier of aggregation ``j`` of node ``idx``."""
        return self._spill_tiers[(idx, j) if self.n_shards == 1
                                 else (idx, j, s)][1]

    def _drain_spill_tiers(self, epoch_val) -> None:
        """Snapshot-barrier hook: one host read of every ring's fill count
        (over the lanes); a site with rows drains every lane's ring into
        that lane's host tier, and the tiers' changelogs run through the
        rest of the aggregation's node on their lanes and then downstream
        together."""
        sites = sorted({key[:2] for key in self._spill_tiers})
        counts = self._read_spill_counts(
            [self.states[idx][j].spill_count.sum() for idx, j in sites])
        for (idx, j), n in zip(sites, counts):
            if n == 0:
                continue
            executors = self.nodes[idx].fragment.executors
            lanes = self._open()
            outs = []
            for s, v in enumerate(lanes.views):
                states = list(v[idx])
                states[j], chunk = executors[j].drain_spill(states[j])
                out = chunk_to(self._tier(idx, j, s).process(chunk,
                                                             epoch_val),
                               self.device)
                for k in range(j + 1, len(executors)):
                    if out is None:
                        break
                    states[k], out = executors[k].apply(states[k], out)
                lanes.put(s, (tuple(states),), idx)
                outs.append(out)
            if outs[0] is not None:
                self._propagate(lanes, [(("node", idx), outs)])
            self._close(lanes)

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
        empty (stacked on the lanes of a sharded job), and callers
        backfill them (``backfill_node``)."""
        ids = []
        states = list(self.states)
        for n in nodes:
            self.nodes.append(n)
            states.append(self._node_state(n))
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
        for key in [k for k in self.exchanges if k[0] in drop]:
            del self.exchanges[key]
        self._sync_spill_tiers()
        self._rebuild()

    def _sync_spill_tiers(self) -> None:
        """A tier for every spill-enabled aggregation (and lane) of a new
        node; the tiers of removed nodes go."""
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
        names a join node's side.  A sharded job's chunk is lane-stacked
        and each lane replays its own partition (:1467).  The chunk's
        columns are the upstream MV's own stores: nothing here writes
        them."""
        node = self.nodes[node_id]
        for chunk in chunks:
            lanes = self._open()
            per = [chunk] if self.n_shards == 1 else \
                [_lane_chunk(chunk, s) for s in range(self.n_shards)]
            if isinstance(node, FragNode):
                outs = self._step_node(lanes, node_id,
                                       self._exchange(node_id, None, per))
                if outs[0] is not None:
                    self._propagate(lanes, [(("node", node_id), outs)])
            else:
                self._apply_join_windowed(
                    lanes, node_id, self._exchange(node_id, side, per), side)
            self._close(lanes)

    def recover(self, epoch: int | None = None) -> None:
        """Reset to the last committed checkpoint (states and readers):
        the durable store's, else the shadow, else the initial state.  A
        sharded job takes the checkpoint's lane count, up to the engine's
        lanes."""
        loaded = self._recover_pipeline(epoch)
        if loaded is not None:
            epoch_v, states, src_state = loaded
            if self.n_shards > 1:
                n_ckpt = flatten(states)[0][0].shape[0]
                if n_ckpt > self.max_lanes:
                    raise RuntimeError(
                        f"checkpoint has {n_ckpt} shards but the engine "
                        f"has {self.max_lanes} lanes")
                if n_ckpt != self.n_shards:
                    self.n_shards = n_ckpt
                    self._sync_spill_tiers()
            self.states = states
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
        """The MV's rows: a sharded job's lanes merged, lane by lane."""
        rows = []
        for v in self._open().views:
            st = v
            for i in state_index:
                st = st[i]
            rows.extend(mv_executor.to_host(st))
        return rows
