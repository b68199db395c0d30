"""The SQL engine: DDL, streaming jobs, serving reads.

Port of the single-process subset of ``risingwave_tpu/sql/engine.py``
that runs Nexmark aggregations and the q8 join end to end (a join
plans as a ``DagPlan`` and runs as a ``DagJob``, ``_build_dag_job``
:1184, the branch without MV taps)::

    eng = Engine()                      # device="cuda" unless told "cpu"
    eng.execute("CREATE SOURCE bid (...) WITH (connector='nexmark', ...)")
    eng.execute("CREATE MATERIALIZED VIEW v AS SELECT ...")
    eng.tick(barriers=5, chunks_per_barrier=8)
    eng.execute("SELECT * FROM v ORDER BY window_start LIMIT 10")

Ported statements: CREATE SOURCE (nexmark and datagen connectors), CREATE
MATERIALIZED VIEW, SET, ALTER SYSTEM SET and ``SELECT <columns> FROM
<mv> [ORDER BY ...] [LIMIT n] [OFFSET n]`` (read on the host).  Every
other statement raises ``NotImplementedError``.

The engine runs on the card: ``Engine(config)`` means
``device="cuda"`` and raises when no GPU is present; the CPU is used
only when the caller passes ``device="cpu"``.

Durability (``Engine(config, data_dir=d)``, the reference's
``engine.py:154,253-278``): the engine keeps a ``CheckpointStore`` and a
``MetaStore`` under ``d``.  Every snapshot barrier seals its epoch into
the job's shadow snapshot (K11) and a background uploader persists it
as a full snapshot or a dirty-block delta; the end of ``tick`` drains
the uploads (the durability point).  Every executed CREATE SOURCE,
CREATE MATERIALIZED VIEW and SET is logged, and a new
``Engine(config, data_dir=d)`` over a logged catalog cold-starts
(``_bootstrap``): it replays the log, loads each job's last committed
epoch onto the device and rewinds the source cursors, so the MVs
continue as if the process never stopped.  Only these two stores are
built: the reference's Hummock MV export to SSTs, its compactor and
scrubber, DML tables and their journal, sinks and spill tiers are not
ported yet.
"""

from __future__ import annotations

import time
from typing import Sequence

from risingwave_tpu_torch.common.chunk import Chunk
from risingwave_tpu_torch.common.config import (
    SessionConfig,
    StorageConfig,
    SystemParams,
)
from risingwave_tpu_torch.common.device import resolve_device
from risingwave_tpu_torch.common.metrics import MetricsRegistry
from risingwave_tpu_torch.common.types import Schema
from risingwave_tpu_torch.connector.datagen import (
    DatagenReader,
    declared_schema,
)
from risingwave_tpu_torch.connector.nexmark import (
    SCHEMAS,
    NexmarkConfig,
    NexmarkGenerator,
    NexmarkSplitReader,
)
from risingwave_tpu_torch.meta.catalog import Catalog, CatalogEntry
from risingwave_tpu_torch.sql import ast
from risingwave_tpu_torch.sql.binder import Scope
from risingwave_tpu_torch.sql.parser import parse_with_text
from risingwave_tpu_torch.sql.planner import (
    DagPlan,
    PlanError,
    Planner,
    PlannerConfig,
)
from risingwave_tpu_torch.stream.dag import DagJob
from risingwave_tpu_torch.stream.runtime import StreamingJob


class _ProjectingReader:
    """Selects/reorders a reader's columns (declared source columns);
    the generator produces only those columns."""

    def __init__(self, inner, idxs: Sequence[int], schema: Schema):
        self.inner = inner
        self.idxs = list(idxs)
        self.schema = schema
        self.cap = inner.cap
        self.events_per_row = inner.events_per_row

    def next_chunk(self) -> Chunk:
        c = self.inner.next_chunk(self.idxs)
        return Chunk(c.columns, c.ops, c.valid, self.schema)

    @property
    def offset(self):
        return self.inner.offset

    @offset.setter
    def offset(self, v):
        self.inner.offset = v

    def state(self):
        return self.inner.state()


class Engine:
    #: statements recorded in the durable DDL log: the ported subset of
    #: the reference's ``_LOGGED_DDL`` (engine.py:299-303)
    _LOGGED_DDL = (ast.CreateSource, ast.CreateMaterializedView,
                   ast.SetStatement)

    def __init__(self, config: PlannerConfig | None = None,
                 data_dir: str | None = None, device=None):
        self.device = resolve_device(device)
        self.catalog = Catalog()
        self.config = config or PlannerConfig()
        self.planner = Planner(self.catalog, self.config, self.device)
        self.jobs: list[StreamingJob | DagJob] = []
        self.system_params = SystemParams()
        self.session_config = SessionConfig()
        self.metrics = MetricsRegistry()
        self._last_columns: list[str] | None = None
        self.checkpoint_store = None
        self.meta_store = None
        #: True while replaying the DDL log (suppresses re-logging)
        self._replaying = False
        if data_dir is not None:
            from risingwave_tpu_torch.meta.store import MetaStore
            from risingwave_tpu_torch.storage.checkpoint_store import (
                CheckpointStore,
            )
            self.checkpoint_store = CheckpointStore(
                data_dir, keep_epochs=StorageConfig().checkpoint_keep_epochs,
                metrics=self.metrics,
                native_crc=self.device.type == "cuda")
            self.meta_store = MetaStore(data_dir)
            if self.meta_store.has_catalog():
                self._bootstrap()

    def _bootstrap(self) -> None:
        """Cold start: replay the DDL log to rebuild the catalog and the
        jobs, then restore every job's state and source cursors from its
        last committed checkpoint."""
        self._replaying = True
        try:
            for sql in self.meta_store.ddl_log():
                self.execute(sql)
            self.recover()
        finally:
            self._replaying = False

    # ------------------------------------------------------------------
    def execute(self, sql: str):
        """Run one or more statements; returns the last result.  With a
        ``data_dir``, DDL is logged after it succeeds."""
        result = None
        for text, stmt in parse_with_text(sql):
            result = self._execute_one(stmt)
            if isinstance(stmt, self._LOGGED_DDL) \
                    and self.meta_store is not None and not self._replaying:
                self.meta_store.append_ddl(text)
        return result

    def query(self, sql: str):
        """Run statements; returns (column_names, rows)."""
        self._last_columns = None
        rows = self.execute(sql)
        if rows is None:
            return [], []
        return self._last_columns or [], rows

    def _execute_one(self, stmt):
        self._last_columns = None
        if isinstance(stmt, ast.CreateSource):
            return self._create_source(stmt)
        if isinstance(stmt, ast.CreateMaterializedView):
            return self._create_mview(stmt)
        if isinstance(stmt, ast.SetStatement):
            if stmt.system:
                self.system_params.set(stmt.name, stmt.value)
            else:
                self.session_config.set(stmt.name, stmt.value)
            return None
        if isinstance(stmt, ast.Select):
            return self._serve(stmt)
        raise NotImplementedError(
            f"{type(stmt).__name__} is not ported yet")

    # -- sources ----------------------------------------------------------
    def _create_source(self, stmt: ast.CreateSource):
        connector = stmt.with_options.get("connector")
        if connector == "datagen" and not stmt.is_table:
            return self._datagen_source(stmt)
        if connector != "nexmark" or stmt.is_table:
            raise NotImplementedError(
                f"connector {connector!r} is not ported yet (nexmark and "
                "datagen are)")
        opts = stmt.with_options
        table = opts.get("nexmark.table", stmt.name)
        base = SCHEMAS[table]
        if stmt.columns:
            idxs = [base.index_of(c.name) for c in stmt.columns]
            schema = Schema(tuple(base[i] for i in idxs))
        else:
            idxs = list(range(len(base)))
            schema = base
        rate = int(opts.get("nexmark.event.rate", "100000"))
        gen_config = NexmarkConfig(
            inter_event_us=max(1_000_000 // max(rate, 1), 1))
        cap = self.config.chunk_capacity
        device = self.device

        def factory(split_id: int = 0, num_splits: int = 1):
            reader = NexmarkSplitReader(
                table, NexmarkGenerator(gen_config, device),
                chunk_capacity=cap, split_id=split_id,
                num_splits=num_splits)
            if idxs == list(range(len(base))):
                return reader
            return _ProjectingReader(reader, idxs, schema)

        wm = None
        if stmt.watermark is not None:
            wm = (schema.index_of(stmt.watermark.column),
                  stmt.watermark.delay.micros)
        self.catalog.create(
            CatalogEntry(stmt.name, "source", schema, reader_factory=factory,
                         watermark=wm, append_only=True, definition=str(stmt)),
            stmt.if_not_exists)
        return None

    def _datagen_source(self, stmt: ast.CreateSource):
        schema, wm = declared_schema(stmt)
        cap = self.config.chunk_capacity
        device = self.device

        def factory(split_id: int = 0, num_splits: int = 1):
            return DatagenReader(schema, cap, split_id, num_splits, device)

        self.catalog.create(
            CatalogEntry(stmt.name, "source", schema, reader_factory=factory,
                         watermark=wm, append_only=True, definition=str(stmt)),
            stmt.if_not_exists)
        return None

    # -- materialized views -------------------------------------------
    def _create_mview(self, stmt: ast.CreateMaterializedView):
        if stmt.name in self.catalog:
            if stmt.if_not_exists:
                return None
            raise ValueError(f"{stmt.name!r} already exists")
        plan = self.planner.plan(stmt.query, eowc=stmt.emit_on_window_close)
        ckpt_freq = int(self.system_params.get("checkpoint_frequency"))
        if isinstance(plan, DagPlan):
            job, mv_exec, state_index = self._build_dag_job(
                plan, stmt.name, ckpt_freq)
        else:
            job = StreamingJob(plan.reader, plan.fragment, stmt.name,
                               checkpoint_frequency=ckpt_freq,
                               device=self.device,
                               checkpoint_store=self.checkpoint_store)
            mv_exec = plan.fragment.executors[plan.mv_index]
            state_index = (plan.mv_index,)
        self.catalog.create(CatalogEntry(
            stmt.name, "mview", mv_exec.in_schema, job=job,
            mv_executor=mv_exec, mv_state_index=state_index,
            append_only=not hasattr(mv_exec, "pk_indices"),
            stream_key=list(getattr(mv_exec, "pk_indices", [])) or None,
            definition=str(stmt)))
        self.jobs.append(job)
        return None

    def _build_dag_job(self, plan: DagPlan, name: str, ckpt_freq: int):
        """A ``DagJob`` over the plan's sources and nodes (the reference's
        no-tap branch; one device, not staged)."""
        job = DagJob(plan.sources, plan.nodes, name,
                     checkpoint_frequency=ckpt_freq, device=self.device,
                     checkpoint_store=self.checkpoint_store)
        terminal = plan.nodes[plan.mv_node].fragment.executors[plan.mv_index]
        return job, terminal, (plan.mv_node, plan.mv_index)

    # -- the barrier loop -----------------------------------------------
    def tick(self, barriers: int = 1,
             chunks_per_barrier: int | None = None) -> None:
        """Advance every streaming job ``barriers`` barriers."""
        if chunks_per_barrier is None:
            chunks_per_barrier = int(
                self.system_params.get("chunks_per_barrier"))
        ckpt_freq = int(self.system_params.get("checkpoint_frequency"))
        maint = int(self.system_params.get(
            "maintenance_interval_checkpoints"))
        snap_iv = int(self.system_params.get(
            "snapshot_interval_checkpoints"))
        upload_window = int(self.system_params.get(
            "checkpoint_upload_window"))
        for _ in range(barriers):
            for job in self.jobs:
                job.checkpoint_frequency = ckpt_freq
                job.maintenance_interval = maint
                job.snapshot_interval = snap_iv
                job.upload_window = upload_window
                if job.metrics is None:
                    job.metrics = self.metrics
                t0 = time.perf_counter()
                rows = job.run_chunks(chunks_per_barrier)
                t1 = time.perf_counter()
                job.inject_barrier()
                t2 = time.perf_counter()
                self.metrics.inc("stream_rows_total", rows, job=job.name)
                self.metrics.observe("barrier_latency_seconds", t2 - t0,
                                     job=job.name)
                self.metrics.observe("barrier_phase_seconds", t1 - t0,
                                     job=job.name, phase="dispatch")
                self.metrics.observe("barrier_phase_seconds", t2 - t1,
                                     job=job.name, phase="seal")
        # the batch boundary is the durability point: uploads sealed in
        # the window pipelined against the barrier loop and land here
        for job in self.jobs:
            job.drain_uploads()
            self._export_checkpoint_gauges(job)

    def _export_checkpoint_gauges(self, job) -> None:
        """Checkpoint-pipeline gauges (no device read)."""
        self.metrics.set_gauge("committed_epoch", job.committed_epoch,
                               job=job.name)
        self.metrics.set_gauge("sealed_epoch", job.sealed_epoch,
                               job=job.name)
        self.metrics.set_gauge(
            "checkpoint_seal_lag_epochs",
            max(0, job.sealed_epoch - job.committed_epoch), job=job.name)
        self.metrics.set_gauge("checkpoint_upload_queue_depth",
                               job.upload_queue_depth(), job=job.name)
        up = job._uploader
        if up is not None:
            self.metrics.set_gauge("checkpoint_uploads_total",
                                   up.uploads_total, job=job.name)
            self.metrics.set_gauge("checkpoint_upload_seconds_total",
                                   up.upload_seconds_total, job=job.name)
            self.metrics.set_gauge("checkpoint_upload_stall_seconds_total",
                                   up.stall_seconds_total, job=job.name)

    def recover(self) -> None:
        """Restore every job from its last committed checkpoint."""
        for job in self.jobs:
            job.recover()

    # -- serving ----------------------------------------------------------
    def _mv_rows(self, entry: CatalogEntry) -> list[tuple]:
        state = entry.job.states
        for i in entry.mv_state_index:
            state = state[i]
        return entry.mv_executor.to_host(state)

    def _serve(self, select: ast.Select):
        """``SELECT <columns> FROM <mv> [ORDER BY] [LIMIT] [OFFSET]``,
        evaluated on the host over the MV's rows."""
        if not isinstance(select.from_, ast.TableRef):
            raise PlanError("serving reads support SELECT ... FROM <mv>")
        if select.where is not None or select.group_by or \
                select.having is not None:
            raise NotImplementedError(
                "serving WHERE / GROUP BY is not ported yet")
        entry = self.catalog.get(select.from_.name)
        if entry.kind != "mview":
            raise PlanError("serving reads are over materialized views")
        schema = entry.schema
        scope = Scope.of(schema, select.from_.alias or select.from_.name)
        idxs, names = [], []
        for name, e in self.planner._expand_items(select.items, scope):
            if not isinstance(e, ast.ColumnRef):
                raise NotImplementedError(
                    "serving expressions other than columns are not "
                    "ported yet")
            idxs.append(scope.resolve(e.name, e.table))
            names.append(name)
        rows = [tuple(r[i] for i in idxs) for r in self._mv_rows(entry)]
        self._last_columns = names
        for oi in reversed(select.order_by):
            k = self._order_key(oi.expr, names)
            rows.sort(key=lambda r: (r[k] is None, r[k] if r[k] is not None
                                     else 0), reverse=oi.descending)
        if select.offset:
            rows = rows[select.offset:]
        if select.limit is not None:
            rows = rows[:select.limit]
        return rows

    @staticmethod
    def _order_key(e, names: list[str]) -> int:
        if isinstance(e, ast.Literal) and e.type_name == "int":
            if not 1 <= e.value <= len(names):
                raise PlanError(f"ORDER BY position {e.value} out of range")
            return e.value - 1
        if isinstance(e, ast.ColumnRef) and e.name in names:
            return names.index(e.name)
        raise NotImplementedError(
            "serving ORDER BY supports output columns only")

