"""A meta-less driver of one vnode-partitioned job over engines in one
process.

The reference's meta service (``cluster/meta_service.py``, ``scale``
:1661 and ``_handover_job`` :1747) places partitions on compute workers,
each holding one ``Engine(..., role="compute")``, and moves vnodes between
them at a committed round.  The engine calls it makes are the scale
plane's API (``adopt_job``, ``partition_job``, ``set_job_vnodes``,
``repartition_job``, DROP to release); the rest is the pure map
functions of ``vnode``.  ``ScaleDriver`` makes those same calls without
RPC: each partition is an engine built by ``make_engine(worker_id)`` over
one shared checkpoint directory, and every partition reads the whole
source (replicate mode).  It drives any engine with that API, so the port
and the reference can be run side by side.

Protocol of ``scale(workers)``, as the reference's meta:

1. every partition is committed at its last barrier (``tick`` drains the
   uploads), so live state equals the checkpoint at that epoch;
2. the new map is ``rebalance(old, workers)`` and the work list
   ``moved_vnodes(old, new)``;
3. each recipient transplants every donor's slice (a new worker first
   adopts the job as an empty partition under a new lineage and replays
   the DML the others saw), then each donor narrows its mask, and a donor
   left with no vnode drops the MV.

A table's DML goes to every engine (``execute_dml``) and is logged, so a
new engine replays the same history and a restored cursor means the same
rows everywhere.
"""

from __future__ import annotations

from typing import Callable

from risingwave_tpu_torch.cluster.scale.vnode import (
    initial_map,
    moved_vnodes,
    owned_vnodes,
    rebalance,
)


class ScaleDriver:
    """Partitions of job ``name`` (DDL ``ddl``) over ``n_vnodes``."""

    def __init__(self, make_engine: Callable, ddl: list[str], name: str,
                 n_vnodes: int):
        self.make_engine = make_engine
        self.ddl = list(ddl)
        self.name = name
        self.n_vnodes = n_vnodes
        #: worker id -> engine holding its partition
        self.engines: dict = {}
        #: worker id -> checkpoint lineage of its partition
        self.lineages: dict = {}
        self.vmap: list[int] | None = None
        self.specs: dict = {}
        self.dml_log: list[str] = []
        self._next_lineage = 1

    def _adopt(self, worker: int, vnodes) -> None:
        eng = self.make_engine(worker)
        eng.adopt_job(self.ddl, self.name, recover=False)
        lineage = f"{self.name}@p{self._next_lineage}"
        self._next_lineage += 1
        self.specs[worker] = eng.partition_job(self.name, self.n_vnodes,
                                               lineage)
        eng.set_job_vnodes(self.name, vnodes)
        for sql in self.dml_log:
            eng.execute(sql)
        self.engines[worker] = eng
        self.lineages[worker] = lineage

    def start(self, workers: list[int]) -> None:
        """The first map: one partition per worker."""
        self.vmap = initial_map(workers, self.n_vnodes)
        for w in sorted(workers):
            self._adopt(w, owned_vnodes(self.vmap, w))

    def execute_dml(self, sql: str) -> None:
        """A DML statement on every partition's copy of the table."""
        for w in sorted(self.engines):
            self.engines[w].execute(sql)
        self.dml_log.append(sql)

    def tick(self, barriers: int = 1, chunks_per_barrier: int = 1) -> None:
        """Advance every partition through the same rounds."""
        for _ in range(barriers):
            for w in sorted(self.engines):
                self.engines[w].tick(barriers=1,
                                     chunks_per_barrier=chunks_per_barrier)

    def job(self, worker: int):
        return self.engines[worker].catalog.get(self.name).job

    def scale(self, workers: list[int]) -> dict:
        """Rebalance onto ``workers`` with the state handover; returns the
        moved vnodes and each recipient's ``repartition_job`` result."""
        old = list(self.vmap)
        new = rebalance(old, workers, self.n_vnodes)
        moved = moved_vnodes(old, new)
        epochs = {}
        for w in self.engines:
            job = self.job(w)
            if job.committed_epoch != job.sealed_epoch:
                raise RuntimeError(f"partition {self.lineages[w]} is not "
                                   "committed at its last barrier")
            epochs[w] = job.committed_epoch
        gains: dict[int, list] = {}
        for (src, dst), vns in moved.items():
            if src in self.engines:
                gains.setdefault(dst, []).append((src, vns))
        results = []
        for dst in sorted(gains):
            xfers = [{"ckpt": self.lineages[src], "epoch": epochs[src],
                      "vnodes": vns} for src, vns in gains[dst]]
            if dst not in self.engines:
                self._adopt(dst, [])
            res = self.engines[dst].repartition_job(
                self.name, owned_vnodes(new, dst), xfers)
            results.append({"worker": dst, **res})
        for src in sorted({s for s, _ in moved if s in self.engines}):
            own = owned_vnodes(new, src)
            if own:
                self.engines[src].repartition_job(self.name, own, [])
            else:
                self.engines[src].execute(
                    f"DROP MATERIALIZED VIEW {self.name}")
                del self.engines[src]
                del self.lineages[src]
        self.vmap = new
        return {"moved_vnodes": sum(len(v) for v in moved.values()),
                "moved": {f"{s}>{d}": len(v) for (s, d), v in moved.items()},
                "recipients": results}

    def rows(self, read_sql: str) -> list:
        """The union of every partition's read."""
        out = []
        for w in sorted(self.engines):
            out.extend(self.engines[w].execute(read_sql))
        return out

    def stats(self) -> dict:
        """``partition_stats`` of every partition, by worker."""
        return {w: self.engines[w].partition_stats()[self.name]
                for w in sorted(self.engines)}
