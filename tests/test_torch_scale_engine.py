"""Port parity: the vnode scale plane through the Engine API a compute
worker calls.

``ScaleDriver`` (``cluster/scale/driver.py``, the meta's calls without
RPC) drives the same scenario over reference engines and over port
engines (``device="cpu"``), each an ``Engine(..., role="compute")`` over
one shared store directory per package:

- (a) a Nexmark ``bid`` source without a watermark and ``SELECT auction,
  count(*), sum(price), max(price) FROM bid GROUP BY auction`` over 24
  vnodes (not a power of two), scaled 2 -> 3 -> 2;
- (b) ``tests/test_scale.py``'s ``JOIN_DDL`` (``ja LEFT JOIN jb``) over 16
  vnodes, scaled 1 -> 2 -> 1 under retraction churn: the pads of ``ja``
  rows retract as their ``jb`` matches arrive, half of them while scaled.

At every step ``partition_job``'s specs, ``partition_stats``,
``repartition_job``'s cleared counts and transfers, the union of the
partitions' reads, each partition's state tree and each lineage's stored
checkpoints (epoch kinds, payload arrays byte for byte) equal the
reference's; at the end the union equals the port's linear engine over
the same input.  Also: ``partition_job``'s refusals word for word (bench's
q1, q5, q7 and q8 among them), and several ``CheckpointStore`` instances
committing into one directory from their uploader threads.  Tolerance:
none.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import json
import os
import threading

import jax
import numpy as np
import pytest

from bench import QUERIES, SOURCES
from risingwave_tpu.sql import Engine as JEngine
from risingwave_tpu.sql.planner import PlanError as JPlanError
from risingwave_tpu.sql.planner import PlannerConfig as JConfig
from risingwave_tpu_torch.cluster.scale.driver import ScaleDriver
from risingwave_tpu_torch.compat import state_mismatches
from risingwave_tpu_torch.sql import Engine
from risingwave_tpu_torch.sql.planner import PlanError, PlannerConfig

BID = """CREATE SOURCE bid (
    auction BIGINT, bidder BIGINT, price BIGINT,
    channel VARCHAR, url VARCHAR, date_time TIMESTAMP
) WITH (connector = 'nexmark', nexmark.table = 'bid',
        nexmark.event.rate = '100000')"""
AGG = """CREATE MATERIALIZED VIEW scale_agg AS
SELECT auction, count(*) AS bids, sum(price) AS volume,
       max(price) AS max_price FROM bid GROUP BY auction"""
AGG_READ = "SELECT auction, bids, volume, max_price FROM scale_agg"
AGG_SIZES = dict(chunk_capacity=512, agg_table_size=1 << 10,
                 agg_emit_capacity=256, mv_table_size=1 << 10)

JOIN_DDL = [
    "CREATE TABLE ja (k BIGINT, v BIGINT)",
    "CREATE TABLE jb (k BIGINT, w BIGINT)",
    """CREATE MATERIALIZED VIEW jmv AS
       SELECT ja.k AS k, ja.v AS v, jb.w AS w
       FROM ja LEFT JOIN jb ON ja.k = jb.k""",
]
JOIN_READ = "SELECT k, v, w FROM jmv"
NO_MAINTENANCE = "ALTER SYSTEM SET maintenance_interval_checkpoints = 1000000"
JOIN_SIZES = dict(chunk_capacity=128, agg_table_size=1 << 8,
                  agg_emit_capacity=128, mv_table_size=1 << 10,
                  mv_ring_size=1 << 10, join_table_size=1 << 8,
                  join_bucket_cap=16, join_pool_size=1 << 10,
                  join_out_capacity=256)


def _norm(rows):
    return sorted(tuple(None if x is None else int(x) for x in r)
                  for r in rows)


def _store_files(d, lineage):
    """A lineage's retained epochs (kinds in order, the committed one's
    position) and their payload arrays as raw bytes; epochs are wall-clock
    values, so positions stand in for them."""
    with open(os.path.join(d, "MANIFEST.json")) as f:
        m = json.load(f)["jobs"][lineage]
    epochs = sorted(int(e) for e in m["epochs"])
    payloads = []
    for e in epochs:
        with np.load(os.path.join(d, lineage, f"epoch_{e}.npz")) as z:
            payloads.append({k: (z[k].shape, z[k].dtype.str,
                                 z[k].tobytes()) for k in z.files})
    return ([m["kind"][str(e)] for e in epochs],
            epochs.index(int(m["committed"])), payloads)


def _strip(res):
    """``scale`` results without the epochs and timings (wall-clock)."""
    for r in res["recipients"]:
        r.pop("durable_epoch")
        r.pop("handover_ms", None)
    return res


class _Pair:
    """The reference's and the port's drivers, run step by step; each
    step's observations are kept for the tests."""

    def __init__(self, tmp, ddl, name, n_vnodes, sizes, read):
        self.dirs = (str(tmp / "ref"), str(tmp / "port"))
        self.ref = ScaleDriver(
            lambda w: JEngine(JConfig(**sizes), data_dir=self.dirs[0],
                              role="compute"), ddl, name, n_vnodes)
        self.port = ScaleDriver(
            lambda w: Engine(PlannerConfig(**sizes), data_dir=self.dirs[1],
                             role="compute", device="cpu"),
            ddl, name, n_vnodes)
        self.read = read
        self.steps: list[dict] = []

    def both(self, fn) -> list:
        return [fn(d) for d in (self.ref, self.port)]

    def observe(self, tag: str, scaled=None) -> None:
        r, p = self.ref, self.port
        self.steps.append({
            "tag": tag,
            "scaled": scaled,
            "stats": (r.stats(), p.stats()),
            "rows": (_norm(r.rows(self.read)), _norm(p.rows(self.read))),
            "workers": (sorted(r.engines), sorted(p.engines)),
            "states": {w: state_mismatches(jax.device_get(r.job(w).states),
                                           p.job(w).states)
                       for w in p.engines},
            "stores": {w: (_store_files(self.dirs[0], r.lineages[w]),
                           _store_files(self.dirs[1], p.lineages[w]))
                       for w in p.engines},
        })


@pytest.fixture(scope="module")
def agg_run(tmp_path_factory):
    """(a): 2 -> 3 -> 2 partitions of the bid aggregation, 2 barriers a
    step, then the port's linear engine over the same 6 barriers."""
    pair = _Pair(tmp_path_factory.mktemp("scale_agg"), [BID, AGG],
                 "scale_agg", 24, AGG_SIZES, AGG_READ)
    pair.both(lambda d: d.start([1, 2]))
    pair.both(lambda d: d.tick(2, 1))
    pair.observe("2 partitions")
    for workers in ([1, 2, 3], [1, 2]):
        res = pair.both(lambda d: _strip(d.scale(workers)))
        pair.observe(f"{len(workers)} partitions, just scaled", res)
        pair.both(lambda d: d.tick(2, 1))
        pair.observe(f"{len(workers)} partitions")
    lin = Engine(PlannerConfig(**AGG_SIZES), device="cpu")
    for sql in (BID, AGG):
        lin.execute(sql)
    lin.tick(barriers=6, chunks_per_barrier=1)
    return pair, _norm(lin.execute(AGG_READ))


def _ingest_a(d, base, n, keys=23):
    rows = [((base + i) % keys, 7 * (base + i) + 1) for i in range(n)]
    d.execute_dml("INSERT INTO ja VALUES "
                  + ",".join(f"({k},{v})" for k, v in rows))


def _ingest_b(d, ks):
    d.execute_dml("INSERT INTO jb VALUES "
                  + ",".join(f"({k},{1000 + 3 * k})" for k in ks))


@pytest.fixture(scope="module")
def join_run(tmp_path_factory):
    """(b): 1 -> 2 -> 1 partitions of the LEFT JOIN: half of jb's keys
    before any ja row, the other half (retracting pads) while scaled
    out, then the port's linear engine over the same DML."""
    # no maintenance pass (the reference compiles its checks per engine,
    # ~6 s each); every step still compares every state leaf, counters
    # included
    pair = _Pair(tmp_path_factory.mktemp("scale_join"),
                 JOIN_DDL + [NO_MAINTENANCE], "jmv", 16, JOIN_SIZES,
                 JOIN_READ)
    pair.both(lambda d: d.start([1]))
    pair.both(lambda d: _ingest_b(d, range(0, 23, 2)))
    pair.both(lambda d: _ingest_a(d, 0, 100))
    # one round reads a chunk of each table: every INSERT below is one
    pair.both(lambda d: d.tick(1, 1))
    pair.observe("1 partition")
    res = pair.both(lambda d: _strip(d.scale([1, 2])))
    pair.observe("2 partitions, just scaled", res)
    pair.both(lambda d: _ingest_b(d, range(1, 23, 2)))
    pair.both(lambda d: _ingest_a(d, 100, 80))
    pair.both(lambda d: d.tick(1, 1))
    pair.observe("2 partitions")
    res = pair.both(lambda d: _strip(d.scale([1])))
    pair.both(lambda d: _ingest_a(d, 180, 40))
    pair.both(lambda d: d.tick(1, 1))
    pair.observe("1 partition again", res)
    lin = Engine(PlannerConfig(**JOIN_SIZES), device="cpu")
    for sql in JOIN_DDL + pair.port.dml_log:
        lin.execute(sql)
    lin.execute("FLUSH")
    return pair, _norm(lin.execute(JOIN_READ))


def _check_steps(pair):
    for st in pair.steps:
        tag = st["tag"]
        assert st["workers"][0] == st["workers"][1], tag
        assert st["stats"][1] == st["stats"][0], tag
        assert st["rows"][1] == st["rows"][0], tag
        assert all(m == [] for m in st["states"].values()), \
            (tag, st["states"])
        for w, (ref, port) in st["stores"].items():
            assert port == ref, (tag, w)
        if st["scaled"] is not None:
            assert st["scaled"][1] == st["scaled"][0], tag


def test_agg_specs_equal(agg_run):
    pair, _ = agg_run
    assert pair.port.specs == pair.ref.specs
    assert pair.port.specs[1]["dist"] == "auction"


def test_agg_steps_equal_reference(agg_run):
    pair, _ = agg_run
    _check_steps(pair)
    moves = [st["scaled"][1] for st in pair.steps if st["scaled"]]
    assert [m["moved_vnodes"] for m in moves] == [8, 8]
    assert all(t["entries"] > 0 for m in moves for r in m["recipients"]
               for t in r["transfers"])
    # scaling back in: the regained vnodes' stale entries were cleared
    assert sum(r["cleared"] for r in moves[1]["recipients"]) > 0
    stats = pair.steps[-1]["stats"][1]
    assert sum(s["gate_dropped"] for s in stats.values()) > 0


def test_agg_union_equals_linear(agg_run):
    pair, linear = agg_run
    assert pair.steps[-1]["rows"][1] == linear
    assert len(linear) > 20


def test_partition_reads_narrow_to_vnodes(agg_run):
    """A partition's time-travel read (``SET query_epoch``) and the
    backfill chunk of its MV narrow to its vnodes, as the live read does;
    the time-travel rows equal the reference partition's."""
    pair, _ = agg_run
    for w in pair.port.engines:
        reads = []
        for drv in (pair.ref, pair.port):
            eng = drv.engines[w]
            live = _norm(eng.execute(AGG_READ))
            eng.execute(f"SET query_epoch = {drv.job(w).committed_epoch}")
            try:
                reads.append(_norm(eng.execute(AGG_READ)))
            finally:
                eng.execute("SET query_epoch = 0")
            assert reads[-1] == live
        assert reads[1] == reads[0] and reads[1]
        eng = pair.port.engines[w]
        chunk = eng._mv_snapshot_chunk(eng.catalog.get("scale_agg"))
        assert int(chunk.valid.sum()) == len(reads[1])
        stale = eng.catalog.get("scale_agg").job.states[-1].table.occupied
        assert int(stale.sum()) >= len(reads[1])


def test_join_specs_equal(join_run):
    pair, _ = join_run
    assert pair.port.specs == pair.ref.specs
    assert pair.port.specs[1]["shuffle_cols"] == {"ja": 0, "jb": 0}


def test_join_steps_equal_reference(join_run):
    pair, _ = join_run
    _check_steps(pair)
    moves = [st["scaled"][1] for st in pair.steps if st["scaled"]]
    assert [m["moved_vnodes"] for m in moves] == [8, 8]
    assert moves[0]["recipients"][0]["transfers"][0]["entries"] > 0
    assert moves[1]["recipients"][0]["cleared"] > 0


def test_join_union_equals_linear(join_run):
    pair, linear = join_run
    rows = pair.steps[-1]["rows"][1]
    assert rows == linear and len(rows) == 220
    assert all(r[2] is not None for r in rows)


def test_partition_attach_refused(join_run):
    pair, _ = join_run
    eng = pair.port.engines[1]
    with pytest.raises(PlanError, match="partition attach"):
        eng.execute("CREATE MATERIALIZED VIEW j2 AS SELECT k, v FROM jmv")


#: ineligible shapes: (setup DDL, the MV's name)
REFUSED = {
    **{q: ([SOURCES.format(rate="10000"), QUERIES[q]], "bench_mv")
       for q in ("q1", "q5", "q7", "q8")},
    "distinct": (["CREATE TABLE t (k BIGINT, v BIGINT)",
                  "CREATE MATERIALIZED VIEW m AS SELECT k, "
                  "count(DISTINCT v) AS c FROM t GROUP BY k"], "m"),
    "nullable_key": (["CREATE TABLE t (k BIGINT NULL, v BIGINT)",
                      "CREATE MATERIALIZED VIEW m AS SELECT k, count(*) "
                      "AS c FROM t GROUP BY k"], "m"),
    "full_outer": (JOIN_DDL[:2] + [
        "CREATE MATERIALIZED VIEW m AS SELECT ja.k AS k, ja.v AS v, "
        "jb.w AS w FROM ja FULL OUTER JOIN jb ON ja.k = jb.k"], "m"),
    "pk_not_join_key": (JOIN_DDL[:2] + [
        "CREATE MATERIALIZED VIEW m AS SELECT ja.v AS v, ja.k AS k, "
        "jb.w AS w FROM ja LEFT JOIN jb ON ja.k = jb.k"], "m"),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_partition_job_refusals_match_reference(case):
    ddl, name = REFUSED[case]
    words = []
    for eng, err in ((JEngine(JConfig(**JOIN_SIZES)), JPlanError),
                     (Engine(PlannerConfig(**JOIN_SIZES), device="cpu"),
                      PlanError)):
        for sql in ddl:
            eng.execute(sql)
        with pytest.raises(err) as e:
            eng.partition_job(name, 16, f"{name}@p1")
        words.append(str(e.value))
    assert words[1] == words[0]


def test_shared_store_across_engines(tmp_path):
    """Three compute engines on one directory tick in threads, their
    uploaders committing concurrently: the manifest keeps every lineage,
    and each lineage loads back its job's state."""
    from risingwave_tpu_torch.common.tree import flatten
    from risingwave_tpu_torch.storage.checkpoint_store import (
        CheckpointStore,
    )

    engines = []
    for i in range(3):
        eng = Engine(PlannerConfig(**JOIN_SIZES), data_dir=str(tmp_path),
                     role="compute", device="cpu")
        eng.execute("CREATE TABLE t (k BIGINT, v BIGINT)")
        eng.execute("CREATE MATERIALIZED VIEW m AS SELECT k, count(*) AS c, "
                    "sum(v) AS s FROM t GROUP BY k")
        eng.jobs[0].ckpt_key = f"m@p{i + 1}"
        eng.execute("INSERT INTO t VALUES " + ",".join(
            f"({k % (7 + i)},{k})" for k in range(300)))
        engines.append(eng)

    def run(eng):
        for _ in range(6):
            eng.tick(barriers=1, chunks_per_barrier=1)

    threads = [threading.Thread(target=run, args=(e,)) for e in engines]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not os.path.exists(tmp_path / "catalog.jsonl")
    store = CheckpointStore(str(tmp_path))
    for i, eng in enumerate(engines):
        job = eng.jobs[0]
        assert store.committed_epoch(f"m@p{i + 1}") == job.committed_epoch
        _, states, src = store.load(f"m@p{i + 1}")
        got, want = flatten(states)[0], flatten(job.states)[0]
        assert len(got) == len(want) and all(
            np.array_equal(a.numpy(), b.numpy()) for a, b in zip(got, want))
        assert src == job.source.state()


def test_manifest_txn_holds_under_concurrent_stores(tmp_path):
    """More writer threads than cores, each its own ``CheckpointStore`` on
    one directory committing its own lineage, the interpreter switching
    threads as often as it can: the manifest keeps every lineage's every
    retained epoch (a lost read-modify-write would drop one)."""
    import sys

    import torch

    from risingwave_tpu_torch.storage.checkpoint_store import (
        CheckpointStore,
    )

    n_threads, n_epochs = (os.cpu_count() or 1) + 4, 5
    errors = []

    def writer(i):
        try:
            store = CheckpointStore(str(tmp_path), keep_epochs=n_epochs)
            for e in range(1, n_epochs + 1):
                store.save(f"lin@p{i}", e, (torch.full((64,), i * 100 + e),),
                           {"offset": e})
        except Exception as exc:  # reported below, with the thread's id
            errors.append((i, exc))

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=writer, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and errors == []
    store = CheckpointStore(str(tmp_path))
    for i in range(n_threads):
        assert store.epochs(f"lin@p{i}") == list(range(1, n_epochs + 1))
        epoch, (leaf,), src = store.load(f"lin@p{i}")
        assert epoch == n_epochs and src == {"offset": n_epochs}
        assert torch.equal(leaf, torch.full((64,), i * 100 + n_epochs))
