"""The SQL engine: DDL, streaming jobs, serving reads.

Port of the single-process subset of ``risingwave_tpu/sql/engine.py``
that runs Nexmark aggregations, the joins, cascaded MVs and sinks end
to end (a join or a cascade plans as a ``DagPlan`` and runs as a
``DagJob``, ``_build_dag_job`` :1184)::

    eng = Engine()                      # device="cuda" unless told "cpu"
    eng.execute("CREATE SOURCE bid (...) WITH (connector='nexmark', ...)")
    eng.execute("CREATE MATERIALIZED VIEW v AS SELECT ...")
    eng.tick(barriers=5, chunks_per_barrier=8)
    eng.execute("SELECT * FROM v ORDER BY window_start LIMIT 10")

Ported statements: CREATE SOURCE (nexmark and datagen connectors), CREATE
TABLE (INSERT-fed; ``WITH (retract = 'true')`` takes DELETE and UPDATE
too), INSERT, ``DELETE FROM t VALUES (...)`` (full rows, as in the
reference), ``UPDATE t SET col = literal, ... WHERE <full-pk
equality>``, FLUSH, CREATE FUNCTION (SQL UDFs, inlined into every later
statement: ``inline_udfs``, the reference's :78), CREATE MATERIALIZED
VIEW (over sources, tables and other MVs), CREATE SINK (``AS SELECT``
or ``FROM rel``, blackhole and file connectors), ``DROP SOURCE | TABLE |
MATERIALIZED VIEW | SINK``, ``SHOW SOURCES | TABLES | MATERIALIZED VIEWS
| SINKS``, SET, ALTER SYSTEM SET and ``SELECT <columns> FROM <mv> [ORDER BY
...] [LIMIT n] [OFFSET n]`` or ``SELECT <global aggregates of columns>
FROM <mv>`` (read on the host).  ``SET query_epoch = e`` makes those
reads come from the retained checkpoint of epoch ``e`` (time travel,
the reference's :3783; it needs a ``data_dir``).  Every other statement
raises ``NotImplementedError``.

MV-on-MV (the reference's :952-1330): a plan over an MV taps it
(``MvTap``).  The tapped MV's ``StreamingJob`` is upgraded in place to a
``DagJob`` (``_ensure_dag``, states kept), jobs of several tapped MVs
merge (``_merge_dag_jobs``), the new nodes attach to that job, and each
node that consumes a tap is backfilled once from the MV's current rows
(``_mv_snapshot_chunk``: one device-resident insert chunk of the table's
or the ring's size).  A sink is the same plan ending in a
``SinkExecutor``; its rows reach the connector at snapshot barriers.
DROP of an entry that shares its job removes only its nodes and readers
(refused while a cascade consumes them) and re-seeds the checkpoint.

Tables (the reference's ``_dml_table`` :832, ``_insert`` :567,
``_delete`` :577, ``_update`` :600, FLUSH :448): a table keeps its rows
in a ``connector.dml.TableDmlManager``; each job reads them through its
own cursor.  A temporal join's build side is drained when the MV is
created (``_prime_temporal_builds``, :1651), before any probe chunk
flows, and FLUSH drains every table reader and then commits a barrier.

Sharded jobs (the reference's :917, :1742-1899, :3819, :3857): ``SET
streaming_parallelism = P`` (0: every lane) shards a unary plan with one
hash aggregation over min(P, ``lanes``) lanes of the engine's device
(``Engine(..., lanes=N)``, the reference's device count; default 1, so a
parallelism above 1 plans linearly, and without the pane rewrite, as the
reference does on one device) as a ``ShardedStreamingJob``
(``stream/sharded.py``): the two-phase rewrite for append-only two-phase
calls, the hash exchange, a global top-N merged at the serving read
(``serving_topn``).  A join-shaped DAG plan (the reference's :1901; q8
among them) runs as a sharded ``DagJob`` over the same lanes: stateless
and watermark-filter prefixes, hash exchanges (K2 + K24) on every join
input keyed by its equi keys, and a per-key-safe chain after the join
(project, filter, materialize, or an inner join's aggregation whose group
keys cover the equi keys); its stacked tree checkpoints through K11 lanes.
An MV over a sharded join MV attaches per lane when its chain is
per-key-safe; a shape that needs an exchange on the attach edge (a
reduced-key or global aggregation, a top-N, a join of two sharded MVs) is
refused as the next slice.  ALTER PARALLELISM raises.

The vnode scale plane (the reference's :2450-3180): an engine of
``role="compute"`` keeps a ``CheckpointStore`` on its ``data_dir`` and no
DDL log, so several engines share one store, each partition under its own
lineage (``job.ckpt_key``).  ``adopt_job`` replays a job's DDL;
``partition_job`` rebuilds a ``source -> agg -> materialize`` job or a
two-source hash join (its sides made dense) as one partition behind
``VnodeGateExecutor``s (``cluster/scale/gate.py``); ``set_job_vnodes``
swaps the owned-vnode mask; ``repartition_job`` clears the gained vnodes,
transplants each donor's checkpoint slice and reseals
(``cluster/scale/handover.py``); ``partition_stats`` reports the gates'
drops; a partition's reads, live, time-travelled or backfilled, narrow to
its vnodes (``_vnode_filtered_mv_state``).  Every partition reads the
whole source (the reference's replicate mode: exchange-lite is not
ported), and MV-on-MV over a partition is refused.

The engine runs on the card: ``Engine(config)`` means
``device="cuda"`` and raises when no GPU is present; the CPU is used
only when the caller passes ``device="cpu"``.

Durability (``Engine(config, data_dir=d)``, the reference's
``engine.py:154,253-278``): the engine keeps a ``CheckpointStore`` and a
``MetaStore`` under ``d``.  Every snapshot barrier seals its epoch into
the job's shadow snapshot (K11) and a background uploader persists it
as a full snapshot or a dirty-block delta; the end of ``tick`` drains
the uploads (the durability point).  Every executed CREATE SOURCE,
CREATE FUNCTION, CREATE MATERIALIZED VIEW, CREATE SINK, DROP and SET is
logged (so a cold start defines a UDF before the MVs that inline it),
every DML statement's rows go to the table's journal (``MetaStore.append_dml``), and a new
``Engine(config, data_dir=d)`` over a logged catalog cold-starts
(``_bootstrap``): it replays the log, reloads each table's history
before any MV plans against it, loads each job's last committed epoch
onto the device and rewinds the source cursors (the table readers'
included), so the MVs continue as if the process never stopped.  CREATE
SINK and DROP are logged too, so the replay rebuilds the same merged
jobs in the same node order, and each sink's ``read_cursor`` comes back
with its job's checkpoint (a file sink appends to its file).  Only these
two stores are built: the reference's Hummock MV export to SSTs, its
compactor and scrubber are not ported yet.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from risingwave_tpu_torch.common.chunk import Chunk
from risingwave_tpu_torch.common.config import (
    SessionConfig,
    StorageConfig,
    SystemParams,
)
from risingwave_tpu_torch.common.device import resolve_device
from risingwave_tpu_torch.common.hash import normalize_null_col
from risingwave_tpu_torch.common.metrics import MetricsRegistry
from risingwave_tpu_torch.common.tree import flatten, unflatten
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.connector.datagen import (
    DatagenReader,
    declared_schema,
)
from risingwave_tpu_torch.connector.dml import (
    TableDmlManager,
    TableSourceReader,
    mark_deletes,
)
from risingwave_tpu_torch.connector.nexmark import (
    SCHEMAS,
    NexmarkConfig,
    NexmarkGenerator,
    NexmarkSplitReader,
)
from risingwave_tpu_torch.connector.sinks import create_sink
from risingwave_tpu_torch.expr.node import InputRef
from risingwave_tpu_torch.meta.catalog import Catalog, CatalogEntry
from risingwave_tpu_torch.sql import ast
from risingwave_tpu_torch.sql.binder import Scope
from risingwave_tpu_torch.sql.parser import parse, parse_with_text
from risingwave_tpu_torch.sql.planner import (
    DagPlan,
    MvTap,
    PlanError,
    Planner,
    PlannerConfig,
)
from risingwave_tpu_torch.stream.dag import (
    DagJob,
    FragNode,
    JoinNode,
    SideNode,
    TemporalJoinNode,
)
from risingwave_tpu_torch.stream.executor import (
    FilterExecutor,
    HopWindowExecutor,
    ProjectExecutor,
)
from risingwave_tpu_torch.stream.materialize import (
    AppendOnlyMaterialize,
    MaterializeExecutor,
)
from risingwave_tpu_torch.stream.runtime import StreamingJob


def _ast_map(node, fn):
    """Bottom-up structural map over the (frozen-dataclass) SQL AST (a
    copy of the reference's ``_ast_map``)."""
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        changed = {}
        for f in dataclasses.fields(node):
            v = getattr(node, f.name)
            nv = _ast_map(v, fn)
            if nv is not v:
                changed[f.name] = nv
        if changed:
            node = dataclasses.replace(node, **changed)
        return fn(node)
    if isinstance(node, (tuple, list)):
        mapped = [_ast_map(x, fn) for x in node]
        if not any(m is not x for m, x in zip(mapped, node)):
            return node
        return tuple(mapped) if isinstance(node, tuple) else mapped
    return node


def inline_udfs(stmt, udfs: dict, depth: int = 0):
    """Expand SQL-UDF calls by AST substitution (a port of the
    reference's ``inline_udfs``; the reference frontend inlines SQL UDFs
    in its binder the same way)."""
    if not udfs:
        return stmt
    if depth > 8:
        raise ValueError("SQL UDF recursion exceeds depth 8")

    def expand(node):
        if not isinstance(node, ast.FuncCall) or node.name not in udfs:
            return node
        params, body = udfs[node.name]
        if len(node.args) != len(params):
            raise ValueError(f"{node.name} takes {len(params)} arguments, "
                             f"got {len(node.args)}")
        sub = dict(zip(params, node.args))

        def substitute(n):
            if isinstance(n, ast.ColumnRef) and n.table is None \
                    and n.name in sub:
                return sub[n.name]
            return n

        # the body may itself call UDFs
        return inline_udfs(_ast_map(body, substitute), udfs, depth + 1)

    return _ast_map(stmt, expand)


class _ProjectingReader:
    """Selects/reorders a reader's columns (declared source columns);
    the generator produces only those columns."""

    def __init__(self, inner, idxs: Sequence[int], schema: Schema):
        self.inner = inner
        self.idxs = list(idxs)
        self.schema = schema
        self.cap = inner.cap
        self.events_per_row = inner.events_per_row
        self.next_base = inner.next_base

    def next_chunk(self) -> Chunk:
        c = self.inner.next_chunk(self.idxs)
        return Chunk(c.columns, c.ops, c.valid, self.schema)

    def impl(self, k0: int, cap: int) -> Chunk:
        """The block from ordinal ``k0`` (a sharded job's lane source)."""
        c = self.inner.impl(k0, cap, self.idxs)
        return Chunk(c.columns, c.ops, c.valid, self.schema)

    @property
    def offset(self):
        return self.inner.offset

    @offset.setter
    def offset(self, v):
        self.inner.offset = v

    def state(self):
        return self.inner.state()


def _is_int_dtype(dt: torch.dtype) -> bool:
    """An integer-family physical dtype (the reference's
    ``np.issubdtype(..., np.integer)``: a string's uint8 bytes count)."""
    return not dt.is_floating_point and not dt.is_complex \
        and dt != torch.bool


def _join_exchange_keys(key_exprs, chunk) -> list:
    """A join input's routing keys (the reference's :134): each equi key
    with a NULL's payload zeroed and no null plane, so a key nullable on
    one side and not on the other routes equal values to one lane (a NULL
    key matches nothing wherever it lands)."""
    return [normalize_null_col(e.eval(chunk))[0] for e in key_exprs]


class Engine:
    #: statements recorded in the durable DDL log: the reference's
    #: ``_LOGGED_DDL`` (engine.py:299-303) less CREATE INDEX and ALTER
    #: PARALLELISM, which are not ported
    _LOGGED_DDL = (ast.CreateSource, ast.CreateMaterializedView,
                   ast.CreateSink, ast.CreateFunction, ast.DropStatement,
                   ast.SetStatement)

    def __init__(self, config: PlannerConfig | None = None,
                 data_dir: str | None = None, device=None, lanes: int = 1,
                 role: str = "single"):
        self.device = resolve_device(device)
        #: "single", or "compute": a partition host of the scale plane,
        #: which shares the checkpoint store of ``data_dir`` with other
        #: engines and keeps no DDL log (the reference's :238-251)
        self.role = role
        #: lanes of the device's shard mesh (the reference's
        #: ``len(jax.devices())``): ``SET streaming_parallelism`` shards an
        #: eligible plan over min(parallelism, lanes) of them
        self.lanes = lanes
        self.catalog = Catalog()
        self.config = config or PlannerConfig()
        self.planner = Planner(self.catalog, self.config, self.device)
        self.jobs: list[StreamingJob | DagJob] = []
        self.system_params = SystemParams()
        self.session_config = SessionConfig()
        self.metrics = MetricsRegistry()
        #: SQL UDFs: name -> (parameter names, body expression AST)
        self.functions: dict[str, tuple] = {}
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
            if role != "compute":
                self.meta_store = MetaStore(data_dir)
                if self.meta_store.has_catalog():
                    self._bootstrap()

    def _bootstrap(self) -> None:
        """Cold start: replay the DDL log to rebuild the catalog and the
        jobs (each table reloads its history first), then restore every
        job's state and source cursors from its last committed
        checkpoint."""
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
            if isinstance(stmt, ast.CreateFunction):
                result = self._create_function(stmt)
            else:
                result = self._execute_one(inline_udfs(stmt, self.functions))
            if isinstance(stmt, self._LOGGED_DDL) \
                    and self.meta_store is not None and not self._replaying:
                self.meta_store.append_ddl(text)
        return result

    def _create_function(self, stmt: ast.CreateFunction) -> None:
        """Register a SQL UDF (the reference's ``_create_function``)."""
        if stmt.name in self.functions:
            if stmt.if_not_exists:
                return None
            raise ValueError(f"function {stmt.name!r} already exists")
        body = parse(stmt.body_sql)
        if len(body) != 1 or not isinstance(body[0], ast.Select) \
                or body[0].from_ is not None or len(body[0].items) != 1:
            raise ValueError("SQL UDF body must be a single SELECT <expr>")
        self.functions[stmt.name] = (tuple(stmt.params),
                                     body[0].items[0].expr)
        return None

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
        if isinstance(stmt, ast.CreateSink):
            return self._create_sink(stmt)
        if isinstance(stmt, ast.DropStatement):
            return self._drop(stmt)
        if isinstance(stmt, ast.ShowStatement):
            kind = {"sources": "source", "tables": "source",
                    "materialized views": "mview",
                    "sinks": "sink"}.get(stmt.kind)
            return [(e.name,) for e in self.catalog.list(kind)]
        if isinstance(stmt, ast.SetStatement):
            if stmt.system:
                self.system_params.set(stmt.name, stmt.value)
            else:
                self.session_config.set(stmt.name, stmt.value)
            return None
        if isinstance(stmt, ast.Insert):
            return self._insert(stmt)
        if isinstance(stmt, ast.Delete):
            return self._delete(stmt)
        if isinstance(stmt, ast.Update):
            return self._update(stmt)
        if isinstance(stmt, ast.FlushStatement):
            return self._flush()
        if isinstance(stmt, ast.Select):
            return self._serve(stmt)
        raise NotImplementedError(
            f"{type(stmt).__name__} is not ported yet")

    def _drop(self, stmt: ast.DropStatement) -> None:
        """``DROP SOURCE | TABLE | MATERIALIZED VIEW | SINK`` (the
        reference's :378-434, without its index, Hummock-export and
        metrics-series branches, which are not ported).  An entry that
        shares a ``DagJob`` with others removes only its own nodes and
        readers (refused while a cascade still consumes them) and
        re-seeds the job's checkpoint; an entry that owns its job stops
        it."""
        entry = self.catalog.get(stmt.name) \
            if stmt.name in self.catalog else None
        if entry is not None:
            want = {"source": "source", "table": "source",
                    "materialized view": "mview", "sink": "sink",
                    "index": "mview"}[stmt.kind]
            if entry.kind != want:
                raise ValueError(f"{stmt.name} is a {entry.kind}, not a "
                                 f"{want}")
            if stmt.kind == "index":
                raise ValueError(f"{stmt.name} is not an index")
            if entry.job is not None:
                job = entry.job
                shared = isinstance(job, DagJob) and any(
                    e is not entry and e.job is job
                    for e in self.catalog.list())
                if shared:
                    # only this entry's nodes; raises while dependent
                    # (cascaded) MVs or sinks still consume them
                    job.remove_nodes(entry.dag_nodes)
                    job.remove_sources(entry.dag_sources or [])
                    if not self._replaying:
                        job.reseed_checkpoint()
                else:
                    self.jobs.remove(job)
            if entry.kind == "sink" and entry.mv_executor is not None:
                entry.mv_executor.sink.close()
            if entry.dml is not None and self.meta_store is not None \
                    and not self._replaying:
                # the durable history dies with the table (at replay the
                # log already holds only the last generation's rows)
                self.meta_store.truncate_dml(stmt.name)
        self.catalog.drop(stmt.name, stmt.if_exists)
        return None

    def _flush(self) -> None:
        """Drain every bounded source's pending rows, then commit one
        barrier (the reference's FLUSH, engine.py:448).  Only table
        readers are bounded: the unbounded sources (nexmark, datagen)
        never drain."""
        cpb = max(1, int(self.system_params.get("chunks_per_barrier")))
        for _ in range(4096):
            pending = 0
            for job in self.jobs:
                srcs = list(job.sources.values()) \
                    if isinstance(job, DagJob) else [job.source]
                pending += sum(s.pending() for s in srcs
                               if isinstance(s, TableSourceReader))
            if pending == 0:
                break
            self.tick(barriers=1, chunks_per_barrier=cpb)
        else:
            raise RuntimeError("FLUSH did not drain in 4096 barriers "
                               f"({pending} rows still pending)")
        self.tick(barriers=1, chunks_per_barrier=0)

    # -- DML --------------------------------------------------------------
    def _dml_entry(self, table: str, verb: str) -> CatalogEntry:
        entry = self.catalog.get(table)
        if entry.dml is None:
            raise ValueError(f"{table} is not a DML table")
        if verb != "INSERT" and entry.append_only:
            raise ValueError(f"{table} is append-only; CREATE TABLE ... WITH "
                             f"(retract = 'true') to enable {verb}")
        return entry

    def _journal(self, table: str, rows: list) -> None:
        if self.meta_store is not None and not self._replaying:
            self.meta_store.append_dml(table, rows)

    @staticmethod
    def _dml_rows(stmt, entry: CatalogEntry, verb: str) -> list[tuple]:
        """The statement's literal rows coerced to the table schema."""
        schema = entry.schema
        if stmt.columns:
            order = [schema.index_of(c) for c in stmt.columns]
            if len(set(order)) != len(order):
                raise ValueError(f"{verb} lists a column twice")
            for i in set(range(len(schema))) - set(order):
                if not schema[i].nullable:
                    raise ValueError(
                        f"{verb} omits NOT NULL column {schema[i].name}")
        else:
            order = list(range(len(schema)))
        rows = []
        for r in stmt.rows:
            if len(r) != len(order):
                raise ValueError(f"{verb} arity mismatch")
            vals = [None] * len(schema)
            for pos, e in zip(order, r):
                vals[pos] = _coerce_const(_const_value(e), schema[pos])
            rows.append(tuple(vals))
        return rows

    def _insert(self, stmt: ast.Insert) -> None:
        entry = self.catalog.get(stmt.table)
        if entry.dml is None:
            raise ValueError(f"{stmt.table} is not an INSERT-able table")
        rows = self._dml_rows(stmt, entry, "INSERT")
        entry.dml.insert(rows)
        self._journal(stmt.table, rows)

    def _delete(self, stmt: ast.Delete) -> None:
        """Exact full-row retraction: the marked rows join the history
        (and the journal) like any other batch."""
        entry = self._dml_entry(stmt.table, "DELETE")
        marked = mark_deletes(self._dml_rows(stmt, entry, "DELETE"),
                              len(entry.schema))
        entry.dml.insert(marked)
        self._journal(stmt.table, marked)

    def _update(self, stmt: ast.Update) -> None:
        """``UPDATE t SET col = literal, ... WHERE <full-pk equality>``:
        the live old row under the pk, found in the table's history, is
        retracted and the new row inserted (one marked delete and one
        insert, journaled as rows)."""
        entry = self._dml_entry(stmt.table, "UPDATE")
        if not entry.stream_key:
            raise ValueError(f"{stmt.table} has no PRIMARY KEY; UPDATE "
                             "needs a full-pk WHERE")
        schema = entry.schema
        width = len(schema)
        pk = list(entry.stream_key)
        eq: dict[int, object] = {}
        for c in Planner._conjuncts(stmt.where):
            if not (isinstance(c, ast.BinaryOp) and c.op == "equal"):
                raise ValueError("UPDATE WHERE must be a conjunction of "
                                 "full-pk equalities")
            left, right = c.left, c.right
            if isinstance(left, ast.Literal) \
                    and isinstance(right, ast.ColumnRef):
                left, right = right, left
            if not isinstance(left, ast.ColumnRef):
                raise ValueError("UPDATE WHERE must compare columns to "
                                 "literals")
            i = self._column_index(schema, left.name, stmt.table)
            eq[i] = _coerce_const(_const_value(right), schema[i])
        if set(eq) != set(pk):
            raise ValueError("UPDATE WHERE must pin exactly the full "
                             "primary key")
        sets: dict[int, object] = {}
        for col, expr in stmt.assignments:
            i = self._column_index(schema, col, stmt.table)
            if i in pk:
                raise ValueError("UPDATE cannot assign a primary-key column "
                                 "(retract + insert instead)")
            if i in sets:
                raise ValueError(f"UPDATE assigns {col!r} twice")
            sets[i] = _coerce_const(_const_value(expr), schema[i])
        live = entry.dml.live_rows(pk, tuple(eq[i] for i in pk))
        if not live:
            raise ValueError(f"UPDATE matched no live row in {stmt.table!r}")
        if len(live) > 1:
            raise ValueError(f"UPDATE pk matched {len(live)} live rows in "
                             f"{stmt.table!r} (history is inconsistent)")
        old = live[0]
        rows = mark_deletes([old], width) + [
            tuple(sets.get(i, old[i]) for i in range(width))]
        entry.dml.insert(rows)
        self._journal(stmt.table, rows)

    @staticmethod
    def _column_index(schema: Schema, name: str, table: str) -> int:
        if name not in schema.names():
            raise ValueError(f"column {name!r} does not exist in {table!r}")
        return schema.index_of(name)

    # -- sources ----------------------------------------------------------
    def _create_source(self, stmt: ast.CreateSource):
        connector = stmt.with_options.get("connector")
        if connector is None and stmt.is_table:
            return self._dml_table(stmt)
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

    def _dml_table(self, stmt: ast.CreateSource):
        """CREATE TABLE without a connector: an INSERT-fed table whose
        PRIMARY KEY is its stream key; ``WITH (retract = 'true')`` makes
        it retractable (DELETE and UPDATE, and plans that retract)."""
        schema, wm, auto = declared_schema(stmt)
        dml = TableDmlManager(schema, auto_width_cols=auto)
        if self._replaying and self.meta_store is not None:
            # cold start: the history is back before any MV plans (auto
            # widths) or rewinds its cursor into it
            hist = self.meta_store.dml_rows(stmt.name)
            if hist:
                dml.insert(hist)
        cap = self.config.chunk_capacity
        device = self.device

        def factory(split_id: int = 0, num_splits: int = 1):
            return dml.new_reader(cap, device)

        pk = [schema.index_of(c) for c in stmt.primary_key] \
            if stmt.primary_key else None
        retract = str(stmt.with_options.get("retract", "false")).lower() \
            in ("true", "1", "yes")
        self.catalog.create(
            CatalogEntry(stmt.name, "source", schema, reader_factory=factory,
                         watermark=wm, append_only=not retract,
                         definition=str(stmt), dml=dml, stream_key=pk),
            stmt.if_not_exists)
        return None

    def _refresh_dml_widths(self) -> None:
        """Re-derive the tables' auto VARCHAR widths before a plan (the
        observed maximum; running jobs keep theirs)."""
        for entry in self.catalog.list("source"):
            if entry.dml is not None and entry.dml.auto_width_cols:
                entry.schema = entry.dml.refresh_schema()

    def _datagen_source(self, stmt: ast.CreateSource):
        schema, wm, _ = declared_schema(stmt)
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
        self._refresh_dml_widths()
        self.planner.parallel_hint = int(
            self.session_config.get("streaming_parallelism"))
        plan = self.planner.plan(stmt.query, eowc=stmt.emit_on_window_close)
        job, mv_exec, state_index, dag_meta, is_new = self._build_job(
            plan, stmt.name)
        self.catalog.create(CatalogEntry(
            stmt.name, "mview", mv_exec.in_schema, job=job,
            mv_executor=mv_exec, mv_state_index=state_index,
            append_only=not hasattr(mv_exec, "pk_indices"),
            stream_key=list(getattr(mv_exec, "pk_indices", [])) or None,
            definition=str(stmt),
            dag_nodes=dag_meta[0] if dag_meta else None,
            dag_sources=dag_meta[1] if dag_meta else None))
        if is_new:
            self.jobs.append(job)
        return None

    def _create_sink(self, stmt: ast.CreateSink):
        """``CREATE SINK s AS SELECT ...`` or ``CREATE SINK s FROM rel``
        (the reference's :2147): the plan ends in a ``SinkExecutor`` over
        the connector the WITH options name."""
        if stmt.name in self.catalog:
            if stmt.if_not_exists:
                return None
            raise ValueError(f"{stmt.name!r} already exists")
        query = stmt.query if stmt.query is not None else ast.Select(
            (ast.SelectItem(ast.Star(), None),), ast.TableRef(stmt.from_rel))
        sink = create_sink(stmt.with_options)
        self._refresh_dml_widths()
        self.planner.parallel_hint = int(
            self.session_config.get("streaming_parallelism"))
        plan = self.planner.plan(query, sink=sink)
        job, sink_exec, _, dag_meta, is_new = self._build_job(plan,
                                                              stmt.name)
        self.catalog.create(CatalogEntry(
            stmt.name, "sink", sink_exec.in_schema, job=job,
            mv_executor=sink_exec,
            dag_nodes=dag_meta[0] if dag_meta else None,
            dag_sources=dag_meta[1] if dag_meta else None,
            definition=str(stmt)))
        if is_new:
            self.jobs.append(job)
        return None

    def _build_job(self, plan, name: str):
        """The runtime job of a plan, shared by MVs and sinks (the
        reference's :917).  With ``streaming_parallelism`` above 1 (0: every
        lane) an eligible plan runs vnode-sharded over the engine's lanes
        (``_try_sharded_job``, ``_try_sharded_dag_plan``).  Returns ``(job, terminal executor,
        state index, (dag node ids, dag source names) or None,
        is_new_job)``."""
        ckpt_freq = int(self.system_params.get("checkpoint_frequency"))
        par = int(self.session_config.get("streaming_parallelism"))
        if par == 0:
            par = self.lanes
        if par > 1:
            sharded = (self._try_sharded_dag_plan if isinstance(plan, DagPlan)
                       else self._try_sharded_job)(plan, name, par, ckpt_freq)
            if sharded is not None:
                return sharded
        if isinstance(plan, DagPlan):
            return self._build_dag_job(plan, name, ckpt_freq)
        job = StreamingJob(plan.reader, plan.fragment, name,
                           checkpoint_frequency=ckpt_freq,
                           device=self.device,
                           checkpoint_store=self.checkpoint_store)
        terminal = plan.fragment.executors[plan.mv_index]
        return job, terminal, (plan.mv_index,), None, True

    # -- sharded jobs ------------------------------------------------------
    def _try_sharded_job(self, plan, name: str, par: int, ckpt_freq: int):
        """Shard a unary plan with one hash aggregation over
        min(``par``, lanes) lanes (the reference's :1742-1899), or None
        when it is not eligible: a source that generates per lane
        (``impl``, ``next_base``), a prefix of filters, windows,
        projections and watermark filters, and after the aggregation
        filters, projections, materializations, sinks or one global
        top-N (not with a sink).  An append-only plan whose calls are all
        two-phase (no FILTER, no DISTINCT) becomes the partial aggregation
        before the exchange and the translated global aggregation after
        it; the keyed half runs without a spill ring.  A global top-N
        keeps ``limit + offset`` rows a lane, and the serving read applies
        the order and limit over the merged lanes (``serving_topn``).
        Returns ``_build_job``'s tuple."""
        from risingwave_tpu_torch.stream.executor import (
            FilterExecutor,
            HopWindowExecutor,
            ProjectExecutor,
        )
        from risingwave_tpu_torch.stream.hash_agg import HashAggExecutor
        from risingwave_tpu_torch.stream.partial_agg import (
            TWO_PHASE_KINDS,
            PartialAggExecutor,
            translated_global_calls,
        )
        from risingwave_tpu_torch.stream.sharded import (
            ShardedJob,
            ShardedStreamingJob,
        )
        from risingwave_tpu_torch.stream.sink import SinkExecutor
        from risingwave_tpu_torch.stream.top_n import GroupTopNExecutor
        from risingwave_tpu_torch.stream.watermark import (
            WatermarkFilterExecutor,
        )

        reader = plan.reader
        if not (hasattr(reader, "impl") and hasattr(reader, "next_base")):
            return None
        execs = plan.fragment.executors
        agg_idx = None
        for i, ex in enumerate(execs):
            if isinstance(ex, HashAggExecutor):
                if agg_idx is not None:
                    return None
                agg_idx = i
        if agg_idx is None:
            return None
        prefix = execs[:agg_idx]
        if any(not isinstance(ex, (FilterExecutor, HopWindowExecutor,
                                   ProjectExecutor, WatermarkFilterExecutor))
               for ex in prefix):
            return None
        topn_spec = None
        has_sink = False
        for ex in execs[agg_idx + 1:]:
            if isinstance(ex, GroupTopNExecutor) and not ex.group_by \
                    and ex.rank_alias is None:
                topn_spec = (ex.order_by, ex.limit, ex.offset)
                continue
            if isinstance(ex, SinkExecutor):
                has_sink = True
                continue
            if not isinstance(ex, (FilterExecutor, ProjectExecutor,
                                   MaterializeExecutor,
                                   AppendOnlyMaterialize)):
                return None
        if topn_spec is not None and has_sink:
            return None  # a sink must see the global band
        agg = execs[agg_idx]
        n = min(par, self.lanes)
        if n < 2:
            return None
        local_execs = list(prefix)
        keyed_execs = list(execs[agg_idx:])
        n_keys = len(agg.group_by)
        # two-phase is retraction-unsafe (the partial min/max ignore signs,
        # the global row count counts partial rows): append-only only
        two_phase = plan.append_only and all(
            a.kind in TWO_PHASE_KINDS and a.filter is None
            and not a.distinct for a in agg.aggs)

        def exchange_key_fn(c):
            if two_phase:  # the partial rows lead with the group keys
                return [c.column(i) for i in range(n_keys)]
            return [e.eval(c) for _, e in agg.group_by]

        if two_phase:
            partial = PartialAggExecutor(agg.in_schema, agg.group_by,
                                         agg.aggs)
            global_agg = HashAggExecutor(
                partial.out_schema,
                [(nm, InputRef(i)) for i, (nm, _) in enumerate(agg.group_by)],
                translated_global_calls(agg.aggs, n_keys),
                table_size=agg.table_size,
                emit_capacity=agg.emit_capacity,
                # the group keys keep their positions in the partial
                # output: window cleaning and EOWC carry over
                watermark_group_idx=agg.watermark_group_idx,
                watermark_lag=agg.watermark_lag,
                watermark_src_col=agg.watermark_src_col,
                emit_on_window_close=agg.emit_on_window_close)
            local_execs.append(partial)
            keyed_execs = [global_agg] + list(execs[agg_idx + 1:])
        for ex in keyed_execs:
            if getattr(ex, "spill_ring", 0):
                ex.spill_ring = 0
        if topn_spec is not None:
            # a lane's band must cover the global rank offset + limit
            order_by, limit, offset = topn_spec
            keyed_execs = [
                GroupTopNExecutor(ex.in_schema, group_by=[],
                                  order_by=ex.order_by, limit=limit + offset,
                                  offset=0, pool_size=ex.pool_size,
                                  emit_capacity=ex.emit_capacity,
                                  append_only=ex.append_only)
                if isinstance(ex, GroupTopNExecutor) and not ex.group_by
                else ex for ex in keyed_execs]
        if self.device.type == "cuda":
            for ex in local_execs + keyed_execs:
                why = ex.cuda_refusal() if hasattr(ex, "cuda_refusal") \
                    else None
                if why is not None:
                    raise PlanError(f"{why} (on CUDA; the CPU runs it)")
        sharded = ShardedJob(n, reader.impl, reader.cap, local_execs,
                             exchange_key_fn, keyed_execs, self.device)
        job = ShardedStreamingJob(sharded, reader, name,
                                  checkpoint_frequency=ckpt_freq,
                                  checkpoint_store=self.checkpoint_store,
                                  max_lanes=self.lanes)
        terminal = keyed_execs[-1]
        if topn_spec is not None:
            terminal.serving_topn = topn_spec
        return job, terminal, (len(local_execs) + len(keyed_execs) - 1,), \
            None, True

    def _try_sharded_dag_plan(self, plan: DagPlan, name: str, par: int,
                              ckpt_freq: int):
        """Shard a join-shaped DAG plan over min(``par``, lanes) lanes
        (the reference's :1901-1967), or None when it is not eligible:
        no MV taps, at least one hash join and no temporal join or
        dynamic filter, prefixes of filters, windows, projections and
        watermark filters, and after the joins filters, projections,
        materializations or an inner join's aggregation whose group keys
        cover the equi keys (``_agg_shard_safe``).  Every join input
        exchanges by its side's equi keys; join output stays on its lane
        (a joined row's stream key holds its join key).  Returns
        ``_build_job``'s tuple."""
        from risingwave_tpu_torch.stream.executor import (
            FilterExecutor,
            HopWindowExecutor,
            ProjectExecutor,
        )
        from risingwave_tpu_torch.stream.hash_agg import HashAggExecutor
        from risingwave_tpu_torch.stream.watermark import (
            WatermarkFilterExecutor,
        )

        if any(isinstance(r, MvTap) for r in plan.sources.values()):
            return None
        joins = [i for i, n in enumerate(plan.nodes)
                 if isinstance(n, JoinNode)]
        if not joins or any(isinstance(plan.nodes[i], SideNode)
                            for i in joins):
            return None
        join_inputs = set()
        for i in joins:
            join_inputs.update((plan.nodes[i].left, plan.nodes[i].right))
        for i, n in enumerate(plan.nodes):
            if isinstance(n, JoinNode):
                continue
            if ("node", i) in join_inputs or n.input[0] == "source":
                if any(not isinstance(ex, (FilterExecutor, HopWindowExecutor,
                                           ProjectExecutor,
                                           WatermarkFilterExecutor))
                       for ex in n.fragment.executors):
                    return None
                continue
            for ex in n.fragment.executors:
                if isinstance(ex, (FilterExecutor, ProjectExecutor,
                                   MaterializeExecutor,
                                   AppendOnlyMaterialize)):
                    continue
                if isinstance(ex, HashAggExecutor) and \
                        self._agg_shard_safe(ex, n, plan):
                    continue
                return None
        n = min(par, self.lanes)
        if n < 2:
            return None
        exchanges = {}
        for i in joins:
            join = plan.nodes[i].join
            exchanges[(i, "left")] = (
                lambda c, ks=join.left_keys: _join_exchange_keys(ks, c))
            exchanges[(i, "right")] = (
                lambda c, ks=join.right_keys: _join_exchange_keys(ks, c))
        job = DagJob(plan.sources, plan.nodes, name,
                     checkpoint_frequency=ckpt_freq, device=self.device,
                     checkpoint_store=self.checkpoint_store, lanes=n,
                     exchanges=exchanges, max_lanes=self.lanes)
        terminal = plan.nodes[plan.mv_node].fragment.executors[plan.mv_index]
        return job, terminal, (plan.mv_node, plan.mv_index), \
            (list(range(len(plan.nodes))), list(plan.sources)), True

    @staticmethod
    def _agg_shard_safe(agg, node, plan: DagPlan) -> bool:
        """Every group of ``agg`` lives on one lane (the reference's
        :1608): its fragment consumes an INNER join directly (an outer
        join's NULL-padded rows live on the unmatched side's lane), only
        filters precede it, its group keys cover the join's equi-key
        columns (rows route by join key), and it is the chain's only
        aggregation."""
        from risingwave_tpu_torch.stream.executor import FilterExecutor
        from risingwave_tpu_torch.stream.hash_agg import HashAggExecutor

        kind, key = node.input
        if kind != "node" or not isinstance(plan.nodes[key], JoinNode):
            return False
        join = plan.nodes[key].join
        if getattr(join, "join_type", None) != "inner":
            return False
        for ex in node.fragment.executors:
            if ex is agg:
                break
            if not isinstance(ex, FilterExecutor):
                return False
        if not all(isinstance(k, InputRef) for k in join.left_keys):
            return False
        group_idx = {g.index for _, g in agg.group_by
                     if isinstance(g, InputRef)}
        if not {k.index for k in join.left_keys} <= group_idx:
            return False
        return all(not isinstance(ex, HashAggExecutor) or ex is agg
                   for ex in node.fragment.executors)

    def _plan_mesh_attach(self, plan: DagPlan, taps: dict,
                          mesh_jobs: set) -> None:
        """MV-on-MV over a sharded join job (the reference's :1330, its
        per-key-safe case): a chain of projections, filters and
        materializations attaches per lane (a joined row's changelog
        lives on its join key's lane).  Everything that needs an exchange
        on the attach edge raises a ``PlanError``, as do the shapes the
        reference refuses there."""
        from risingwave_tpu_torch.stream.executor import (
            FilterExecutor,
            ProjectExecutor,
        )

        nxt = "the cross-shard attach (an exchange on the attach edge) " \
            "is the next slice of the port"
        if any(not isinstance(self.catalog.get(t.name).job, DagJob)
               or self.catalog.get(t.name).job.n_shards == 1
               for t in taps.values()):
            raise PlanError("MV-on-MV joining a sharded job with an "
                            f"un-sharded job: {nxt}")
        if len(mesh_jobs) > 1:
            raise PlanError(f"MV-on-MV joining two sharded MVs: {nxt}")
        if len(taps) != len(plan.sources):
            raise PlanError("MV-on-MV over a sharded join job cannot add "
                            f"new sources: {nxt}")
        for n in plan.nodes:
            if isinstance(n, JoinNode):
                raise PlanError(f"a join over a sharded job: {nxt}")
            for ex in n.fragment.executors:
                if not isinstance(ex, (FilterExecutor, ProjectExecutor,
                                       MaterializeExecutor,
                                       AppendOnlyMaterialize)):
                    raise PlanError(
                        "MV-on-MV over a sharded job supports project/"
                        "filter/materialize chains (got "
                        f"{type(ex).__name__}): {nxt}")

    # -- DAG jobs: joins, cascades, shared upstreams -----------------------
    def _ensure_dag(self, entry: CatalogEntry) -> tuple[DagJob, int]:
        """Upgrade an MV's job to a ``DagJob`` in place, its states kept,
        so that downstream MVs and sinks can attach (the reference's
        :952); returns (job, materialize node id)."""
        job = entry.job
        if isinstance(job, DagJob):
            return job, entry.mv_state_index[0]
        src_name = f"_src_{entry.name}"
        dag = DagJob({src_name: job.source},
                     [FragNode(job.fragment, ("source", src_name))],
                     name=job.name,
                     checkpoint_frequency=job.checkpoint_frequency,
                     device=self.device,
                     checkpoint_store=job.checkpoint_store,
                     states=(job.states,))
        dag.epoch = job.epoch
        dag.barriers_seen = job.barriers_seen
        dag.committed_epoch = job.committed_epoch
        dag.maintenance_interval = job.maintenance_interval
        dag.snapshot_interval = job.snapshot_interval
        # the checkpoint pipeline migrates with the job: the uploader's
        # queue keeps in-flight epochs ahead of the reseed below; the
        # shadow is dropped (the tree changed shape: the reseed re-bases)
        dag.sealed_epoch = job.sealed_epoch
        dag._uploader = job._uploader
        dag.upload_window = job.upload_window
        dag.metrics = job.metrics
        dag.stall_seconds = job.stall_seconds
        dag.spill_reads = job.spill_reads
        # the spill tiers keep what they absorbed, under the DAG's keys
        dag._spill_tiers = {(0, j): (f"0_{j}", tier) for (_, j), (_, tier)
                            in job._spill_tiers.items()}
        self.jobs[self.jobs.index(job)] = dag
        entry.job = dag
        entry.mv_state_index = (0,) + tuple(entry.mv_state_index)
        entry.dag_nodes = [0]
        entry.dag_sources = [src_name]
        # the retained checkpoints hold the StreamingJob-shaped tree (not
        # while replaying: the states are fresh, and the durable
        # checkpoint already holds the final topology's)
        if not self._replaying:
            dag.reseed_checkpoint()
        return dag, 0

    def _merge_dag_jobs(self, a: DagJob, b: DagJob) -> DagJob:
        """Fuse job ``b`` into ``a`` (a plan tapping MVs of two jobs):
        its sources and nodes move over with remapped ids, and its
        catalog entries follow (the reference's :1681, one device; the
        merge of sharded jobs is the next slice)."""
        if a.n_shards > 1 or b.n_shards > 1:
            raise PlanError("MV-on-MV joining sharded jobs: the cross-shard "
                            "attach is the next slice of the port")
        offset = len(a.nodes)
        rename: dict[str, str] = {}
        for sname, reader in b.sources.items():
            new_name = sname
            i = 1
            while new_name in a.sources:
                new_name = f"{sname}_{i}"
                i += 1
            rename[sname] = new_name
            a.sources[new_name] = reader

        def remap(ref):
            kind, key = ref
            if kind == "node":
                return ("node", offset + key)
            return ("source", rename[key])

        for n in b.nodes:
            if n is None:
                a.nodes.append(None)
            elif isinstance(n, FragNode):
                a.nodes.append(dataclasses.replace(n, input=remap(n.input)))
            else:
                a.nodes.append(dataclasses.replace(
                    n, left=remap(n.left), right=remap(n.right)))
        a.states = tuple(a.states) + tuple(b.states)
        for (idx, j), (_, tier) in b._spill_tiers.items():
            a._spill_tiers[(offset + idx, j)] = (f"{offset + idx}_{j}",
                                                 tier)
        a._rebuild()
        for entry in self.catalog.list():
            if entry.job is b:
                entry.job = a
                entry.mv_state_index = (
                    (offset + entry.mv_state_index[0],)
                    + tuple(entry.mv_state_index[1:])
                    if entry.mv_state_index is not None else None)
                if entry.dag_nodes is not None:
                    entry.dag_nodes = [offset + i for i in entry.dag_nodes]
                if entry.dag_sources is not None:
                    entry.dag_sources = [rename[x] for x in entry.dag_sources]
        if b in self.jobs:
            self.jobs.remove(b)
        return a

    def _mv_snapshot_chunk(self, entry: CatalogEntry) -> Chunk:
        """The upstream MV's live rows as ONE insert chunk on the device
        (the reference's :1122, one device): the occupied slots of a
        ``MaterializeExecutor`` table, or the filled span of an
        ``AppendOnlyMaterialize`` ring.  Its columns are the MV's own
        stores, and its capacity the table's or the ring's size.  A
        sharded job's chunk is lane-stacked (``[lanes, cap, ...]``, the
        reference's :1138): each lane replays its own partition."""
        st = entry.job.states
        for i in entry.mv_state_index:
            st = st[i]
        ex = entry.mv_executor
        lead = (entry.job.n_shards,) if getattr(entry.job, "n_shards",
                                                1) > 1 else ()
        if isinstance(ex, MaterializeExecutor):
            valid = st.table.occupied
            cap = ex.table_size
            vn_set, n_vn = self._mv_vnode_set(entry)
            if vn_set is not None:
                # a partition replays only its owned vnodes' rows (the
                # reference's :1164-1170)
                valid = self._vnode_filtered_mv_state(
                    st, vn_set, n_vn).table.occupied
        elif isinstance(ex, AppendOnlyMaterialize):
            cursor = st.cursor[..., None] if lead else st.cursor
            valid = torch.arange(ex.ring_size, dtype=torch.int64,
                                 device=self.device) < cursor
            cap = ex.ring_size
        else:
            raise PlanError("cannot backfill from a sink")
        return Chunk(tuple(st.values),
                     torch.zeros(lead + (cap,), dtype=torch.int8,
                                 device=self.device),
                     valid, ex.in_schema)

    def _build_dag_job(self, plan: DagPlan, name: str, ckpt_freq: int):
        """A plan without MV taps is a new ``DagJob`` (one device, not
        staged).  A plan that taps MVs attaches to their job (the
        reference's :1207-1330): every tap is validated before any job
        changes, the upstream jobs are upgraded and merged, the plan's
        readers are added under fresh names, its nodes are added with
        their refs remapped, each new input slot that consumes a tap is
        backfilled exactly once from the MV's snapshot, the temporal
        joins' builds are primed and the checkpoint is re-seeded (not
        while replaying the DDL log)."""
        taps = {n: r for n, r in plan.sources.items()
                if isinstance(r, MvTap)}
        if not taps:
            job = DagJob(plan.sources, plan.nodes, name,
                         checkpoint_frequency=ckpt_freq, device=self.device,
                         checkpoint_store=self.checkpoint_store)
            self._prime_temporal_builds(job, range(len(job.nodes)))
            terminal = plan.nodes[plan.mv_node].fragment.executors[
                plan.mv_index]
            return job, terminal, (plan.mv_node, plan.mv_index), \
                (list(range(len(plan.nodes))), list(plan.sources)), True
        for tap in taps.values():
            entry = self.catalog.get(tap.name)
            if not isinstance(entry.job, (DagJob, StreamingJob)):
                raise PlanError(
                    f"MV-on-MV over {type(entry.job).__name__} (sharded "
                    "upstream): next round")
            if getattr(entry.job, "n_vnodes", None) is not None:
                # the reference's _plan_partition_attach (:1453)
                raise PlanError(
                    f"MV-on-MV over the vnode partition {tap.name!r}: "
                    "the partition attach is not ported yet")
        mesh_jobs ={self.catalog.get(t.name).job for t in taps.values()
                     if getattr(self.catalog.get(t.name).job, "n_shards",
                                1) > 1}
        if mesh_jobs:
            self._plan_mesh_attach(plan, taps, mesh_jobs)
        tap_entries: dict[str, CatalogEntry] = {}
        target: DagJob | None = None
        for sname, tap in taps.items():
            entry = self.catalog.get(tap.name)
            ujob, _ = self._ensure_dag(entry)
            if target is None:
                target = ujob
            elif ujob is not target:
                target = self._merge_dag_jobs(target, ujob)
            tap_entries[sname] = entry
        # the tapped node ids are read after every merge (merges remap)
        tap_refs = {sname: self.catalog.get(tap.name).mv_state_index[0]
                    for sname, tap in taps.items()}
        base = len(target.nodes)
        src_rename: dict[str, str] = {}
        for sname, reader in plan.sources.items():
            if sname in taps:
                continue
            new_name = sname
            i = 1
            while new_name in target.sources:
                new_name = f"{sname}_{i}"
                i += 1
            src_rename[sname] = new_name
            target.add_source(new_name, reader)

        def remap(ref):
            kind, key = ref
            if kind == "node":
                return ("node", base + key)
            if key in tap_refs:
                return ("node", tap_refs[key])
            return ("source", src_rename[key])

        rewritten = []
        for n in plan.nodes:
            if isinstance(n, FragNode):
                rewritten.append(dataclasses.replace(n, input=remap(n.input)))
            else:
                rewritten.append(dataclasses.replace(
                    n, left=remap(n.left), right=remap(n.right)))
        ids = target.add_nodes(rewritten)
        # backfill each NEW input slot that consumes a tapped MV, once per
        # slot (a self-join backfills both sides, left first)
        tap_by_node = {tap_refs[s]: e for s, e in tap_entries.items()}
        snapshots: dict[int, Chunk] = {}
        for nid in ids:
            node = target.nodes[nid]
            slots = [(node.input, None)] if isinstance(node, FragNode) \
                else [(node.left, "left"), (node.right, "right")]
            for ref, side in slots:
                if ref[0] == "node" and ref[1] in tap_by_node:
                    if ref[1] not in snapshots:
                        snapshots[ref[1]] = self._mv_snapshot_chunk(
                            tap_by_node[ref[1]])
                    target.backfill_node(nid, [snapshots[ref[1]]], side=side)
        self._prime_temporal_builds(target, ids)
        if not self._replaying:
            target.reseed_checkpoint()
        terminal = rewritten[plan.mv_node].fragment.executors[plan.mv_index]
        return target, terminal, (ids[plan.mv_node], plan.mv_index), \
            (ids, list(src_rename.values())), False

    @staticmethod
    def _prime_temporal_builds(job: DagJob, node_ids) -> None:
        """Drain each temporal join's build-side table before any probe
        chunk flows: the build table holds the table's whole current
        state when the MV is created."""
        for nid in node_ids:
            node = job.nodes[nid]
            if not isinstance(node, TemporalJoinNode):
                continue
            ref = node.right
            while ref[0] == "node":
                up = job.nodes[ref[1]]
                if not isinstance(up, FragNode):
                    break  # a join feeding the build: left as it is
                ref = up.input
            if ref[0] != "source":
                continue
            reader = job.sources.get(ref[1])
            if not isinstance(reader, TableSourceReader):
                continue
            for _ in range(1 << 16):
                if reader.pending() == 0:
                    break
                job.run_chunk(ref[1])

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

    # -- the vnode scale plane (cluster/scale) ----------------------------
    def adopt_job(self, ddl: list[str], name: str,
                  recover: bool = True) -> int:
        """Replay a shipped job's DDL, skipping objects this engine already
        has, then recover the job from its last durable checkpoint (the
        reference's :2450).  Returns the recovered committed epoch (0: a
        fresh job)."""
        for sql in ddl:
            for text, stmt in parse_with_text(sql):
                nm = getattr(stmt, "name", None)
                if isinstance(stmt, (ast.CreateSource,
                                     ast.CreateMaterializedView,
                                     ast.CreateSink)) \
                        and nm in self.catalog:
                    continue
                if isinstance(stmt, ast.CreateFunction) \
                        and nm in self.functions:
                    continue
                if isinstance(stmt, ast.DropStatement) \
                        and nm not in self.catalog:
                    continue  # dropped before this engine ever saw it
                self.execute(text)
        entry = self.catalog.get(name)
        if entry.job is None:
            raise ValueError(f"{name!r} did not produce a streaming job")
        if recover:
            entry.job.recover()
        return entry.job.committed_epoch

    @staticmethod
    def _job_sources(job) -> list:
        """Every source reader of a job."""
        if isinstance(job, DagJob):
            return list(job.sources.values())
        src = getattr(job, "source", None)
        return [src] if src is not None else []

    def _table_of_reader(self, reader) -> str | None:
        rows = getattr(reader, "_rows", None)
        if rows is None:
            return None
        for e in self.catalog.list("source"):
            if e.dml is not None and rows is e.dml._history:
                return e.name
        return None

    def _dml_tables_of(self, job) -> list[str]:
        """Names of the DML tables this job's sources read."""
        out: list[str] = []
        for src in self._job_sources(job):
            t = self._table_of_reader(src)
            if t is not None and t not in out:
                out.append(t)
        return out

    @staticmethod
    def _trace_input_col(prefix_execs, col: int) -> int | None:
        """Trace an output column of an executor chain back to an input
        column of the chain's first executor, or None when a hop is not a
        plain InputRef."""
        idx = int(col)
        for ex in reversed(list(prefix_execs)):
            if isinstance(ex, FilterExecutor):
                continue
            if isinstance(ex, HopWindowExecutor):
                # window_start is appended; input columns keep positions
                if idx >= len(ex.in_schema):
                    return None
                continue
            if isinstance(ex, ProjectExecutor):
                if idx >= len(ex.exprs):
                    return None
                e = ex.exprs[idx][1]
                if not isinstance(e, InputRef):
                    return None
                idx = e.index
                continue
            return None
        return idx

    def _trace_source_col(self, prefix_execs, dist_expr) -> int | None:
        """Raw source-column index of a distribution-key expression
        evaluated after ``prefix_execs``, or None when untraceable."""
        if not isinstance(dist_expr, InputRef):
            return None
        return self._trace_input_col(prefix_execs, dist_expr.index)

    def partition_job(self, name: str, n_vnodes: int,
                      ckpt_key: str) -> dict:
        """Rebuild a freshly adopted job as ONE partition of a
        vnode-partitioned job (the reference's :2580): a
        ``VnodeGateExecutor`` masks rows to the owned vnode set, and the
        checkpoint lineage moves to ``ckpt_key``.  Eligible shapes, each
        refused with a ``PlanError`` in the reference's words otherwise:
        a linear job ``stateless prefix -> one HashAggExecutor -> project /
        filter -> Materialize`` (the gate before the agg, routed by the
        leading GROUP BY key), or a two-source hash-join ``DagJob``
        (``_partition_dag_job``).  The spec's ``shuffle_cols`` name the
        raw source column each DML table routes by; the port has no
        exchange-lite, so every partition reads the whole source
        (replicate mode) and the gate filters."""
        from risingwave_tpu_torch.cluster.scale.gate import VnodeGateExecutor
        from risingwave_tpu_torch.stream.fragment import Fragment
        from risingwave_tpu_torch.stream.hash_agg import HashAggExecutor

        entry = self.catalog.get(name)
        job = entry.job
        if hasattr(job, "vnode_gate_idx") or hasattr(job, "vnode_gates"):
            # already a partition on this engine: re-point the lineage
            if job.n_vnodes != n_vnodes:
                raise PlanError(
                    f"{name!r}: vnode ring mismatch "
                    f"({job.n_vnodes} vs {n_vnodes})"
                )
            job.ckpt_key = ckpt_key
            return {
                "partitioned": True,
                "dml_tables": self._dml_tables_of(job),
                "shuffle_cols": getattr(job, "shuffle_cols", {}),
                "edge_kinds": getattr(job, "edge_kinds", {}),
            }
        if entry.kind != "mview":
            raise PlanError(
                f"{name!r} is not a streaming MV: not scale-eligible"
            )
        if isinstance(job, DagJob):
            return self._partition_dag_job(entry, n_vnodes, ckpt_key)
        if not isinstance(job, StreamingJob):
            raise PlanError(
                f"{name!r} is not a linear streaming MV: not "
                "scale-eligible"
            )
        riders = [e for e in self.catalog.list() if e.job is job]
        if riders != [entry]:
            raise PlanError(
                f"{name!r} shares its job with other MVs/sinks: not "
                "scale-eligible"
            )
        if job.barriers_seen:
            raise PlanError(
                f"{name!r} already ran unpartitioned barriers: "
                "partitioning happens at adoption"
            )
        execs = list(job.fragment.executors)
        aggs = [i for i, ex in enumerate(execs)
                if isinstance(ex, HashAggExecutor)]
        if len(aggs) != 1 or not isinstance(execs[-1],
                                            MaterializeExecutor):
            raise PlanError(
                f"{name!r}: scale-eligible jobs are "
                "source → agg → materialize"
            )
        agg_idx = aggs[0]
        agg = execs[agg_idx]
        for ex in execs[:agg_idx]:
            if not isinstance(ex, (FilterExecutor, ProjectExecutor,
                                   HopWindowExecutor)):
                raise PlanError(
                    f"{name!r}: stateful/watermark prefix executor "
                    f"{type(ex).__name__}: not scale-eligible"
                )
        for ex in execs[agg_idx + 1:-1]:
            if not isinstance(ex, (FilterExecutor, ProjectExecutor)):
                raise PlanError(
                    f"{name!r}: post-agg executor {type(ex).__name__}: "
                    "not scale-eligible"
                )
        if (agg.emit_on_window_close or agg._distinct_aggs
                or agg._minput_aggs
                or agg.watermark_group_idx is not None):
            raise PlanError(
                f"{name!r}: DISTINCT/minput/EOWC/watermark "
                "aggregations are not scale-eligible"
            )
        dist_expr = agg.group_by[0][1]
        f = dist_expr.return_field(agg.in_schema)
        if f.nullable or not _is_int_dtype(f.data_type.physical_dtype):
            raise PlanError(
                f"{name!r}: distribution key {agg.group_by[0][0]!r} "
                "must be a NOT NULL integer-family column"
            )
        # spill-to-host draining is not wired for partitioned handover:
        # overflow stays a loud error
        for ex in execs:
            if getattr(ex, "spill_ring", 0):
                ex.spill_ring = 0
        gate = VnodeGateExecutor(agg.in_schema, dist_expr, n_vnodes)
        frag = Fragment(execs[:agg_idx] + [gate] + execs[agg_idx:],
                        name=f"{name}_part")
        part = StreamingJob(
            job.source, frag, name,
            checkpoint_frequency=job.checkpoint_frequency,
            device=self.device, checkpoint_store=job.checkpoint_store,
        )
        part.maintenance_interval = job.maintenance_interval
        part.snapshot_interval = job.snapshot_interval
        part.metrics = job.metrics
        part.ckpt_key = ckpt_key
        part.vnode_gate_idx = agg_idx
        part.n_vnodes = n_vnodes
        part.vnodes = frozenset(range(n_vnodes))
        self.jobs[self.jobs.index(job)] = part
        entry.job = part
        entry.mv_state_index = (entry.mv_state_index[0] + 1,) \
            + tuple(entry.mv_state_index[1:])
        tables = self._dml_tables_of(part)
        src_col = self._trace_source_col(execs[:agg_idx], dist_expr)
        part.shuffle_cols = {t: src_col for t in tables} \
            if src_col is not None else {}
        part.edge_kinds = {t: "source" for t in tables}
        return {
            "partitioned": True,
            "dist": agg.group_by[0][0],
            "dml_tables": tables,
            "shuffle_cols": part.shuffle_cols,
            "edge_kinds": part.edge_kinds,
        }

    def _partition_dag_job(self, entry: CatalogEntry, n_vnodes: int,
                           ckpt_key: str) -> dict:
        """Partition a two-source hash-join ``DagJob`` (the reference's
        :2741): a gate on each source edge routed by that side's FIRST
        equi key, the join rebuilt with DENSE retractable sides (whole-key
        bucket entries, K13d's path: the layout ``handover`` moves), and
        the MV's leading pk column required to carry the preserved side's
        join key, so every keyed state slices and serves in one vnode
        hash domain."""
        from risingwave_tpu_torch.cluster.scale.gate import VnodeGateExecutor
        from risingwave_tpu_torch.stream.fragment import Fragment
        from risingwave_tpu_torch.stream.hash_join import HashJoinExecutor

        name = entry.name
        job = entry.job
        riders = [e for e in self.catalog.list() if e.job is job]
        if riders != [entry]:
            raise PlanError(
                f"{name!r} shares its job with other MVs/sinks: not "
                "scale-eligible"
            )
        if job.barriers_seen:
            raise PlanError(
                f"{name!r} already ran unpartitioned barriers: "
                "partitioning happens at adoption"
            )
        if job.n_shards > 1:
            raise PlanError(
                f"{name!r}: sharded/staged DAGs do not partition "
                "across workers yet (mesh×vnode composition is the "
                "next round)"
            )
        live = [(i, n) for i, n in enumerate(job.nodes) if n is not None]
        if len(live) != 2 or not isinstance(live[0][1], JoinNode) \
                or isinstance(live[0][1], SideNode) \
                or not isinstance(live[1][1], FragNode):
            raise PlanError(
                f"{name!r}: partitioned DAGs are source ⋈ source → "
                "materialize: not scale-eligible"
            )
        jn = live[0][1]
        frag_node = live[1][1]
        join = jn.join
        if not isinstance(join, HashJoinExecutor):
            raise PlanError(
                f"{name!r}: only hash equi-joins partition (got "
                f"{type(join).__name__}): not scale-eligible"
            )
        if join.join_type == "full_outer":
            raise PlanError(
                f"{name!r}: FULL OUTER join has no always-non-NULL "
                "routing column: not scale-eligible"
            )
        if join.left_clean is not None or join.right_clean is not None:
            raise PlanError(
                f"{name!r}: watermark-cleaned join state is not "
                "sliceable: not scale-eligible"
            )
        if jn.left[0] != "source" or jn.right[0] != "source" \
                or jn.left == jn.right:
            raise PlanError(
                f"{name!r}: join sides must read two distinct "
                "sources directly: not scale-eligible"
            )
        if frag_node.input != ("node", live[0][0]):
            raise PlanError(
                f"{name!r}: materialize must consume the join: not "
                "scale-eligible"
            )
        for ks, schema in ((join.left_keys, join.left_schema),
                           (join.right_keys, join.right_schema)):
            k0 = ks[0]
            if not isinstance(k0, InputRef):
                raise PlanError(
                    f"{name!r}: first join key must be a plain "
                    "column: not scale-eligible"
                )
            f = k0.return_field(schema)
            if f.nullable or not _is_int_dtype(f.data_type.physical_dtype):
                raise PlanError(
                    f"{name!r}: routing key {f.name!r} must be a "
                    "NOT NULL integer-family column"
                )
        execs = list(frag_node.fragment.executors)
        mats = [i for i, ex in enumerate(execs)
                if isinstance(ex, MaterializeExecutor)]
        if len(mats) != 1 or mats[0] != len(execs) - 1 or any(
                not isinstance(ex, (FilterExecutor, ProjectExecutor))
                for ex in execs[:-1]):
            raise PlanError(
                f"{name!r}: post-join chain must be project/filter → "
                "materialize: not scale-eligible"
            )
        mv = execs[-1]
        left_pos = join.left_keys[0].index
        if join.emit_pairs:
            right_pos = len(join.left_schema) + join.right_keys[0].index
        else:  # semi/anti: the output is the preserved side alone
            right_pos = join.right_keys[0].index
        if join.join_type == "inner":
            allowed = {left_pos, right_pos}
        elif join.preserve_left:
            allowed = {left_pos}
        else:
            allowed = {right_pos}
        traced = self._trace_input_col(execs[:-1], mv.pk_indices[0])
        if traced is None or traced not in allowed:
            raise PlanError(
                f"{name!r}: the MV's leading pk column must be the "
                "preserved side's join key: not scale-eligible"
            )
        dense = HashJoinExecutor(
            join.left_schema, join.right_schema,
            join.left_keys, join.right_keys,
            table_size=join.table_size,
            left_bucket_cap=join.left_bucket_cap,
            right_bucket_cap=join.right_bucket_cap,
            left_table_size=join.left_table_size,
            right_table_size=join.right_table_size,
            out_capacity=join.out_capacity,
            join_type=join.join_type,
            left_storage="dense", right_storage="dense",
        )
        gate_l = VnodeGateExecutor(join.left_schema, list(join.left_keys),
                                   n_vnodes)
        gate_r = VnodeGateExecutor(join.right_schema,
                                   list(join.right_keys), n_vnodes)
        lname, rname = jn.left[1], jn.right[1]
        for ex in execs:
            if getattr(ex, "spill_ring", 0):
                ex.spill_ring = 0
        part = DagJob(
            dict(job.sources),
            [
                FragNode(Fragment([gate_l], name=f"{name}_gate_l"),
                         ("source", lname)),
                FragNode(Fragment([gate_r], name=f"{name}_gate_r"),
                         ("source", rname)),
                JoinNode(dense, ("node", 0), ("node", 1)),
                FragNode(Fragment(execs, name=f"{name}_part"),
                         ("node", 2)),
            ],
            name=job.name,
            checkpoint_frequency=job.checkpoint_frequency,
            device=self.device, checkpoint_store=job.checkpoint_store,
        )
        part.maintenance_interval = job.maintenance_interval
        part.snapshot_interval = job.snapshot_interval
        part.metrics = job.metrics
        part.ckpt_key = ckpt_key
        part.vnode_gates = [(0, 0), (1, 0)]
        part.n_vnodes = n_vnodes
        part.vnodes = frozenset(range(n_vnodes))
        self.jobs[self.jobs.index(job)] = part
        entry.job = part
        entry.mv_state_index = (3, len(execs) - 1)
        entry.dag_nodes = [0, 1, 2, 3]
        part.shuffle_cols = {}
        for src_name, keys in ((lname, join.left_keys),
                               (rname, join.right_keys)):
            tbl = self._table_of_reader(part.sources[src_name])
            if tbl is not None:
                part.shuffle_cols[tbl] = keys[0].index
        part.edge_kinds = {t: "join" for t in part.shuffle_cols}
        return {
            "partitioned": True,
            "dist": join.left_schema[left_pos].name,
            "dml_tables": self._dml_tables_of(part),
            "shuffle_cols": part.shuffle_cols,
            "edge_kinds": part.edge_kinds,
        }

    def set_job_vnodes(self, name: str, vnodes) -> None:
        """Swap the partition's owned-vnode mask (state, not code).  The
        gates' dropped counters ride along untouched: they audit the
        whole life of the partition (the reference's :2935)."""
        entry = self.catalog.get(name)
        job = entry.job
        job.vnodes = frozenset(int(v) for v in vnodes)

        def with_mask(gate, old_state):
            dropped = old_state[1] if isinstance(old_state, tuple) \
                else torch.zeros((), dtype=torch.int64, device=self.device)
            return (gate.make_mask(job.vnodes, self.device), dropped)

        states = list(job.states)
        if hasattr(job, "vnode_gates"):
            for ni, ei in job.vnode_gates:
                gate = job.nodes[ni].fragment.executors[ei]
                node_states = list(states[ni])
                node_states[ei] = with_mask(gate, node_states[ei])
                states[ni] = tuple(node_states)
        else:
            gi = job.vnode_gate_idx
            states[gi] = with_mask(job.fragment.executors[gi], states[gi])
        job.states = tuple(states)

    def _gate_states(self, job) -> list:
        if hasattr(job, "vnode_gates"):
            return [job.states[ni][ei] for ni, ei in job.vnode_gates]
        if hasattr(job, "vnode_gate_idx"):
            return [job.states[job.vnode_gate_idx]]
        return []

    def partition_stats(self) -> dict:
        """Per partitioned job: owned vnodes, the gates' dropped-row
        counters (one host read per job) and the readers' filtered rows
        (the port's readers filter nothing: replicate mode)."""
        out: dict = {}
        for job in self.jobs:
            if getattr(job, "n_vnodes", None) is None:
                continue
            drops = [st[1] for st in self._gate_states(job)
                     if isinstance(st, tuple)]
            dropped = int(torch.stack(drops).sum()) if drops else 0
            out[job.name] = {
                "vnodes": sorted(job.vnodes),
                "gate_dropped": dropped,
                "reader_filtered": sum(
                    getattr(s, "filtered_rows", 0)
                    for s in self._job_sources(job)
                ),
                "shuffle_cols": dict(getattr(job, "shuffle_cols", {})),
            }
        return out

    def repartition_job(self, name: str, vnodes, transfers: list,
                        rewind_epoch: int | None = None) -> dict:
        """One handover step on this engine's partition (the reference's
        :3050): rewind to the handover epoch if the partition ran ahead,
        clear the gained vnodes' stale entries (K26), transplant each
        donor's checkpoint slice (the probe kernel's claim, then K27),
        swap the owned mask, then reseal the post-transplant state under
        this partition's lineage.  ``transfers``: ``[{"ckpt": donor
        lineage, "epoch": e, "vnodes": [...]}]``, read from the shared
        checkpoint store.  ``handover_ms`` gives the milliseconds of each
        step (clear, load, slice, transplant, reseal)."""
        from risingwave_tpu_torch.cluster.scale.handover import (
            clear_job_vnodes,
            slice_job_states,
            transplant_job,
        )
        from risingwave_tpu_torch.stream.runtime import restore_source

        entry = self.catalog.get(name)
        job = entry.job
        if not hasattr(job, "vnode_gate_idx") \
                and not hasattr(job, "vnode_gates"):
            raise PlanError(f"{name!r} is not a partitioned job")
        is_dag = isinstance(job, DagJob)
        if rewind_epoch is not None and (
                job.committed_epoch != rewind_epoch
                or job.sealed_epoch != rewind_epoch):
            job.recover(rewind_epoch)

        def src_state():
            if is_dag:
                return {n: (s.state() if hasattr(s, "state") else {})
                        for n, s in job.sources.items()}
            return job.source.state() if hasattr(job.source, "state") \
                else {}

        def check_cursor(ours, donor) -> None:
            if ("offset" in ours and "offset" in donor
                    and ours["offset"] != donor["offset"]):
                raise RuntimeError(
                    f"handover cursor mismatch for {name!r}: "
                    f"local {ours['offset']} vs donor {donor['offset']}"
                )

        ms = dict.fromkeys(("clear", "load", "slice", "transplant",
                            "reseal"), 0.0)

        def lap(step: str, t0: float) -> float:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t1 = time.perf_counter()
            ms[step] += (t1 - t0) * 1e3
            return t1

        stats = []
        cleared = 0
        if transfers:
            t = time.perf_counter()
            gained = sorted(set(int(v) for tr in transfers
                                for v in tr["vnodes"]))
            job.states, cleared = clear_job_vnodes(
                job, job.states, gained, job.n_vnodes)
            t = lap("clear", t)
            fresh = job.barriers_seen == 0 and job.committed_epoch == 0
            for tr in transfers:
                loaded = self.checkpoint_store.load(tr["ckpt"],
                                                    int(tr["epoch"]))
                if loaded is None:
                    raise RuntimeError(
                        f"donor checkpoint {tr['ckpt']}@{tr['epoch']} "
                        "not found in the shared store"
                    )
                _, d_states, d_src = loaded
                t = lap("load", t)
                sl = slice_job_states(job, d_states, tr["vnodes"],
                                      job.n_vnodes)
                t = lap("slice", t)
                job.states, moved = transplant_job(job, job.states, sl)
                t = lap("transplant", t)
                if fresh:
                    # every donor sealed the same round at the same
                    # cursor: any donor's is the handover epoch's
                    if is_dag:
                        for sname, src in job.sources.items():
                            restore_source(src, d_src.get(sname, {}))
                    else:
                        restore_source(job.source, d_src)
                    fresh = False
                else:
                    ours = src_state()
                    if is_dag:
                        for sname in job.sources:
                            check_cursor(ours.get(sname, {}),
                                         d_src.get(sname, {}))
                    else:
                        check_cursor(ours, d_src)
                stats.append({"ckpt": tr["ckpt"],
                              "vnodes": len(tr["vnodes"]),
                              "entries": moved})
        self.set_job_vnodes(name, vnodes)
        durable = 0
        if transfers and self.checkpoint_store is not None:
            # durably seal the post-transplant state under this
            # partition's lineage at its committed epoch (0 for a fresh
            # recipient): a restart between the transplant and the next
            # seal must not re-adopt a lineage missing the moved state
            t = time.perf_counter()
            job.drain_uploads()
            self.checkpoint_store.invalidate(job.ckpt_key)
            self.checkpoint_store.save(job.ckpt_key, job.committed_epoch,
                                       job.states, src_state())
            job._shadow = None
            lap("reseal", t)
            durable = job.committed_epoch
        return {"vnodes": len(job.vnodes), "cleared": cleared,
                "transfers": stats, "durable_epoch": durable,
                "handover_ms": ms}

    def _mv_vnode_set(self, entry: CatalogEntry):
        """``(vnode set, n_vnodes)`` a read of this MV narrows to, or
        ``(None, None)`` (the reference's :3767)."""
        n_vn = getattr(entry.job, "n_vnodes", None)
        if n_vn is None:
            return None, None
        return entry.job.vnodes, n_vn

    def _vnode_filtered_mv_state(self, st, vn_set, n_vn):
        """A materialize state narrowed to one vnode set (the reference's
        :3165): occupancy masked by the stored leading-pk vnode (K26's
        read form), so stale slots a handover left behind never surface
        in reads."""
        from risingwave_tpu_torch.cluster.scale.handover import vnode_sweep
        from risingwave_tpu_torch.cluster.scale.vnode import (
            vnode_member_mask,
        )
        from risingwave_tpu_torch.state.hash_table import HashTable
        from risingwave_tpu_torch.stream.materialize import MvState

        member = vnode_member_mask(vn_set, n_vn, st.table.device)
        occ = vnode_sweep(st.table, member, n_vn, read=True)
        table = HashTable(st.table.key_cols, occ, st.table.tombstone,
                          st.table.size)
        return MvState(table, st.values, st.overflow)

    # -- serving ----------------------------------------------------------
    def _mv_rows(self, entry: CatalogEntry) -> list[tuple]:
        """The MV's rows: live, or with ``SET query_epoch = e`` those of
        the job's retained checkpoint of epoch ``e`` (the reference's
        time travel, ``engine.py:3779-3830``).  A sharded job's lanes are
        merged on the host; a partition's rows narrow to its owned vnodes
        (``_vnode_filtered_mv_state``), live or travelled."""
        from risingwave_tpu_torch.stream.sharded import ShardedStreamingJob

        vn_set, n_vn = self._mv_vnode_set(entry)
        qe = int(self.session_config.get("query_epoch"))
        if qe:
            if self.checkpoint_store is None:
                raise PlanError("query_epoch needs a durable data_dir")
            ckpt = entry.job.ckpt_key
            epochs = self.checkpoint_store.epochs(ckpt)
            if qe not in epochs:
                raise PlanError(f"epoch {qe} is not retained for "
                                f"{entry.name} (retained: {epochs})")
            _, state, _ = self.checkpoint_store.load(ckpt, qe)
            for i in entry.mv_state_index:
                state = state[i]
            if isinstance(entry.job, ShardedStreamingJob) or \
                    getattr(entry.job, "n_shards", 1) > 1:
                # the checkpoint's stacked lanes, merged on the host
                leaves, spec = flatten(state)
                rows = []
                for s in range(leaves[0].shape[0]):
                    rows.extend(entry.mv_executor.to_host(
                        unflatten(spec, [x[s] for x in leaves])))
                return rows
            if vn_set is not None:
                state = self._vnode_filtered_mv_state(state, vn_set, n_vn)
            return entry.mv_executor.to_host(state)
        if isinstance(entry.job, ShardedStreamingJob):
            return entry.job.mv_rows(entry.mv_executor,
                                     entry.mv_state_index[0])
        if isinstance(entry.job, DagJob) and vn_set is None:
            return entry.job.mv_rows(entry.mv_executor, entry.mv_state_index)
        state = entry.job.states
        for i in entry.mv_state_index:
            state = state[i]
        if vn_set is not None:
            state = self._vnode_filtered_mv_state(state, vn_set, n_vn)
        return entry.mv_executor.to_host(state)

    def _apply_serving_topn(self, entry: CatalogEntry, rows: list) -> list:
        """The global order and limit over a sharded top-N MV's merged
        lane bands (the reference's :3857): each lane's band is a
        superset slice of the global top-k."""
        spec = getattr(entry.mv_executor, "serving_topn", None)
        if spec is None or not rows:
            return rows
        order_by, limit, offset = spec
        schema = entry.mv_executor.in_schema
        for e, desc in reversed(list(order_by)):
            if not isinstance(e, InputRef):
                raise NotImplementedError(
                    "serving a sharded top-N ordered by expressions")
            k = e.index
            nullable = schema[k].nullable
            # NULLs last ascending, first descending (PostgreSQL's order)
            rows.sort(key=lambda r: ((r[k] is None, r[k]) if nullable
                                     else r[k]), reverse=desc)
        end = None if limit is None else offset + limit
        return rows[offset:end]

    def _needs_batch_exec(self, select: ast.Select) -> bool:
        """The reference's split (engine.py:3876): a plain projection of
        one MV takes the fast path; aggregates, GROUP BY, joins, derived
        tables, subqueries in WHERE and base-table scans go to
        ``_serve_batch``."""
        if not isinstance(select.from_, ast.TableRef):
            return True
        if select.from_.name not in self.catalog:
            return False  # the fast path raises the proper error
        if self.catalog.get(select.from_.name).kind != "mview":
            return True
        if select.group_by or select.having is not None \
                or self.planner._has_agg(select):
            return True

        def has_sub(e) -> bool:
            if isinstance(e, (ast.ScalarSubquery, ast.InSubquery,
                              ast.ExistsSubquery)):
                return True
            for a in ("left", "right", "operand"):
                v = getattr(e, a, None)
                if v is not None and has_sub(v):
                    return True
            return any(has_sub(x) for x in getattr(e, "args", ())
                       if not isinstance(x, ast.Star))

        return select.where is not None and has_sub(select.where)

    def _serve(self, select: ast.Select):
        """``SELECT <columns> FROM <mv> [ORDER BY] [LIMIT] [OFFSET]``,
        evaluated on the host over the MV's rows; what is not a plain
        projection of one MV goes to ``_serve_batch``."""
        if self._needs_batch_exec(select):
            return self._serve_batch(select)
        if select.where is not None:
            raise NotImplementedError("serving WHERE is not ported yet")
        entry = self.catalog.get(select.from_.name)
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
        rows = self._apply_serving_topn(entry, self._mv_rows(entry))
        rows = [tuple(r[i] for i in idxs) for r in rows]
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

    #: the global aggregates ``_serve_batch`` evaluates on the host, typed
    #: as the reference's batch result: a count is an int64, an integer sum
    #: widens to int64, min and max keep the column's type
    _SERVE_AGGS = {
        "count": lambda v: np.int64(len(v)),
        "min": lambda v: min(v) if v else None,
        "max": lambda v: max(v) if v else None,
        "sum": lambda v: _typed_sum(v) if v else None,
    }

    def _serve_batch(self, select: ast.Select):
        """The reads ``_needs_batch_exec`` sends here.  The reference
        (engine.py:1017) runs the planner's dataflow over bounded
        snapshot readers; of that, one piece is ported: ``SELECT
        agg(col | *), ... FROM <mv>`` with COUNT, MIN, MAX and SUM of
        columns, NULLs skipped, over the MV's rows on the host, with the
        reference's answers: no row over an empty MV, numpy-typed values,
        and min/max over strings wider than 8 device bytes refused.  The
        rest of the batch executor (GROUP BY, WHERE, ORDER BY / LIMIT /
        OFFSET on an aggregate, joins, subqueries, base tables) is not
        ported and raises."""
        from_ = select.from_
        if not (isinstance(from_, ast.TableRef) and from_.name in self.catalog
                and self.catalog.get(from_.name).kind == "mview"
                and self.planner._has_agg(select)) \
                or select.group_by or select.having is not None \
                or select.where is not None:
            raise NotImplementedError(
                "serving reads other than global aggregates over one "
                "materialized view are not ported yet")
        if select.order_by or select.limit is not None or select.offset:
            raise NotImplementedError(
                "serving ORDER BY / LIMIT / OFFSET over an aggregate is "
                "not ported yet")
        entry = self.catalog.get(from_.name)
        scope = Scope.of(entry.schema, from_.alias or from_.name)
        calls, names = [], []
        for name, e in self.planner._expand_items(select.items, scope):
            if not (isinstance(e, ast.FuncCall) and e.name in
                    self._SERVE_AGGS and len(e.args) == 1
                    and not e.distinct and e.filter_where is None):
                raise NotImplementedError(
                    "serving reads aggregate columns with COUNT, MIN, MAX "
                    "or SUM only")
            arg = e.args[0]
            if isinstance(arg, ast.Star) and e.name == "count":
                i = None
            elif isinstance(arg, ast.ColumnRef):
                i = scope.resolve(arg.name, arg.table)
                f = entry.schema[i]
                if e.name in ("min", "max") and f.data_type.is_string \
                        and f.str_width > 8:
                    # the reference's planner refuses it (planner.py:1342)
                    raise PlanError(
                        f"{e.name} over strings wider than 8 device "
                        "bytes: next round")
            else:
                raise NotImplementedError(
                    "serving aggregates take a column or COUNT(*)")
            calls.append((e.name, i))
            names.append(name)
        self._last_columns = names
        rows = self._mv_rows(entry)
        if not rows:
            # the reference's simple aggregation emits no row over an
            # empty input
            return []
        out = []
        for kind, i in calls:
            vals = rows if i is None else [r[i] for r in rows
                                           if r[i] is not None]
            out.append(self._SERVE_AGGS[kind](vals))
        return [tuple(out)]

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



def _typed_sum(vals):
    """A SUM over host values typed as the reference's: an integer sum
    (int16, int32, int64 or a Python int) is an int64, a float sum keeps
    its numpy type."""
    if all(isinstance(v, (int, np.integer)) and not isinstance(
            v, (bool, np.bool_)) for v in vals):
        return np.int64(sum(int(v) for v in vals))
    return sum(vals)


def _const_value(e):
    """A constant VALUES expression evaluated on the host (the
    reference's, engine.py:4023)."""
    if isinstance(e, ast.Literal):
        return e.value
    if isinstance(e, ast.IntervalLit):
        return e.micros
    if isinstance(e, ast.UnaryOp) and e.op == "neg":
        return -_const_value(e.operand)
    if isinstance(e, ast.Cast):
        v = _const_value(e.operand)
        return _coerce_const(v, Field("?", DataType.from_sql(e.type_name)))
    raise ValueError(f"INSERT VALUES must be constants, got {e!r}")


def _coerce_const(v, field: Field):
    """One DML value checked and converted to its column's type when the
    statement runs (the reference's, engine.py:4038): a bad constant
    fails the statement and never reaches a job."""
    t = field.data_type
    if v is None:
        if not field.nullable:
            raise ValueError(f"NULL value for NOT NULL column {field.name} "
                             "(declare the column `NULL` to allow NULLs)")
        return None
    try:
        if t.is_string:
            return str(v)
        if t in (DataType.FLOAT32, DataType.FLOAT64, DataType.DECIMAL):
            return float(v)
        if t == DataType.BOOLEAN:
            if isinstance(v, str):
                raise ValueError(v)
            return bool(v)
        if isinstance(v, str) and t in (DataType.TIMESTAMP,
                                        DataType.TIMESTAMPTZ, DataType.DATE):
            from datetime import date, datetime, timedelta, timezone

            if t == DataType.DATE:
                return (date.fromisoformat(v) - date(1970, 1, 1)).days
            dt = datetime.fromisoformat(v.replace("Z", "+00:00"))
            if dt.tzinfo is not None:
                dt = dt.astimezone(timezone.utc).replace(tzinfo=None)
            return (dt - datetime(1970, 1, 1)) // timedelta(microseconds=1)
        if isinstance(v, float):
            return int(round(v))  # SQL casts round
        return int(v)
    except (TypeError, ValueError) as e:
        raise ValueError(f"invalid value {v!r} for column {field.name} "
                         f"({t.value})") from e
