"""Port parity: the vnode-sharded join DAG through SQL (``SET
streaming_parallelism``), the port's 8-lane mesh on the CPU against the
reference's 8 virtual devices (``tests/conftest.py``).

Under ``SET streaming_parallelism = 4`` both engines plan ``bench.py``'s
q8 text as a ``DagJob`` over 4 shards: the person and auction prefixes
(watermark filter, TUMBLE), the hash join with an exchange on each input
(K2 and K24's plain versions on the port's side), the project and the
append-only ring.  After every barrier every stacked leaf is equal, lane
by lane, and the MV rows are equal; they also equal the port's linear q8
over the same chunks (4 rounds a sharded round).  A per-key-safe MV over
the sharded MV attaches mid-stream per lane, backfills from the lanes'
rings and stays equal to the reference's; the shapes that need an
exchange on the attach edge are refused.  Durably, the stacked tree
checkpoints through K11 lanes (lane deltas) and ``recover`` and a cold
start give back the committed rows.  The join->agg over two DML tables at
parallelism 2 spills into per-lane host tiers and equals the reference's
state and rows.  With one lane a parallelism above 1 plans linearly.
Tolerance: none (integer keys, tags by bit pattern).
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import jax
import pytest

from bench import QUERIES, SOURCES
from risingwave_tpu.sql import Engine as JEngine
from risingwave_tpu.sql.planner import PlannerConfig as JConfig
from risingwave_tpu_torch.compat import state_mismatches
from risingwave_tpu_torch.sql import Engine
from risingwave_tpu_torch.sql.planner import PlanError, PlannerConfig
from risingwave_tpu_torch.stream.dag import DagJob

SIZES = dict(chunk_capacity=128, join_pool_size=1 << 12,
             join_out_capacity=256, mv_ring_size=1 << 15)
#: the port's linear run holds the 4 lanes' rows in one pool and ring
LINEAR = dict(SIZES, join_pool_size=1 << 14, mv_ring_size=1 << 17)
NODES = [("FragNode", ["WatermarkFilterExecutor", "HopWindowExecutor"]),
         ("FragNode", ["WatermarkFilterExecutor", "HopWindowExecutor"]),
         ("JoinNode", None),
         ("FragNode", ["ProjectExecutor", "AppendOnlyMaterialize"])]
V2 = ("CREATE MATERIALIZED VIEW v2 AS SELECT id, name FROM bench_mv "
      "WHERE id % 2 = 0")


def _q8(engine, par=4):
    engine.execute(SOURCES.format(rate="10000"))
    if par:
        engine.execute(f"SET streaming_parallelism = {par}")
    engine.execute(QUERIES["q8"])
    return engine


def _rows(engine, mv="bench_mv"):
    return sorted(engine.execute(f"SELECT * FROM {mv}"))


def _same(ref, port):
    bad = state_mismatches(jax.device_get(ref.jobs[0].states),
                           port.jobs[0].states)
    assert not bad, bad[:5]


@pytest.fixture(scope="module")
def q8_pair():
    """One reference engine for the module (its first barrier compiles
    the sharded programs) and the port's, both after no barrier."""
    return (_q8(JEngine(JConfig(**SIZES))),
            _q8(Engine(PlannerConfig(**SIZES), device="cpu", lanes=8)))


def test_q8_sharded_plan_state_and_rows(q8_pair):
    ref, port = q8_pair
    jr, jp = ref.jobs[0], port.jobs[0]
    assert isinstance(jp, DagJob) and jp.n_shards == jr.n_shards == 4
    assert [(type(n).__name__,
             [type(e).__name__ for e in n.fragment.executors]
             if hasattr(n, "fragment") else None) for n in jp.nodes] == NODES
    assert sorted(jp.exchanges) == sorted(jr.exchanges) == \
        [(2, "left"), (2, "right")]
    assert jp._pulls == [("p", 1), ("a", 3)]
    for _ in range(3):
        for e in (ref, port):
            e.tick(barriers=1, chunks_per_barrier=1)
        _same(ref, port)
    got = _rows(port)
    assert got == _rows(ref) and len(got) > 3000
    js = jp.states[2]
    assert int(js.emit_windows.sum()) > int(js.chunks.sum())  # drains
    assert jp.window_reads == 3 * 4 and jp.barrier_reads >= 3
    # the port's linear q8 over the same chunks: 4 rounds a sharded round
    lin = _q8(Engine(PlannerConfig(**LINEAR), device="cpu"), par=0)
    for _ in range(3 * 4):
        lin.jobs[0].chunk_round()
        lin.jobs[0].inject_barrier()
    assert _rows(lin) == got


def test_mv_on_mv_over_sharded_join_matches_reference(q8_pair):
    """A per-key-safe chain attaches per lane mid-stream and backfills
    each lane's ring rows; the cross-shard shapes are refused."""
    ref, port = q8_pair
    for e in (ref, port):
        e.tick(barriers=1, chunks_per_barrier=1)
        e.execute(V2)
        assert len(e.jobs) == 1
    _same(ref, port)
    for _ in range(2):
        for e in (ref, port):
            e.tick(barriers=1, chunks_per_barrier=1)
        _same(ref, port)
    got = _rows(port, "v2")
    assert got == _rows(ref, "v2") and len(got) > 1000
    assert got == sorted((i, n) for i, n, _ in _rows(port) if i % 2 == 0)
    for sql in (
            "CREATE MATERIALIZED VIEW va AS SELECT id, count(*) AS n "
            "FROM bench_mv GROUP BY id",
            "CREATE MATERIALIZED VIEW vc AS SELECT count(*) AS n "
            "FROM bench_mv",
            "CREATE MATERIALIZED VIEW vt AS SELECT id, reserve FROM "
            "bench_mv ORDER BY reserve DESC LIMIT 5",
            "CREATE MATERIALIZED VIEW vj AS SELECT v.id AS id FROM "
            "bench_mv v JOIN TUMBLE(person, date_time, INTERVAL '1' "
            "SECOND) p2 ON v.id = p2.id",
            "CREATE MATERIALIZED VIEW vs AS SELECT a.id AS id FROM v2 a "
            "JOIN v2 b ON a.id = b.id"):
        with pytest.raises(PlanError, match="next slice"):
            port.execute(sql)
    assert len(port.jobs[0].nodes) == 5  # nothing half-attached
    with pytest.raises(NotImplementedError):
        port.execute("ALTER MATERIALIZED VIEW bench_mv SET PARALLELISM 2")


def test_sharded_join_recovers_from_checkpoint(tmp_path):
    """Lane deltas (K11 lanes), ``recover`` and a cold start."""
    cfg = PlannerConfig(**SIZES)
    eng = _q8(Engine(cfg, data_dir=str(tmp_path), device="cpu", lanes=8))
    job = eng.jobs[0]
    for _ in range(4):
        eng.tick(barriers=1, chunks_per_barrier=1)
    want = _rows(eng)
    committed = job.committed_epoch
    store = eng.checkpoint_store
    kinds = [store.checkpoint_kind("bench_mv", e)
             for e in store.epochs("bench_mv")]
    assert "delta" in kinds, kinds
    assert job._shadow.shard_rows == 4 and job._shadow.lanes[0] == (4, 1)
    job.chunk_round()  # uncommitted work, lost by the recover
    job.recover()
    assert job.committed_epoch == committed and _rows(eng) == want
    cold = Engine(cfg, data_dir=str(tmp_path), device="cpu", lanes=8)
    assert cold.jobs[0].n_shards == 4 and _rows(cold) == want
    for e in (eng, cold):
        e.tick(barriers=1, chunks_per_barrier=1)
    assert _rows(cold) == _rows(eng) and len(_rows(eng)) > len(want)
    with pytest.raises(RuntimeError, match="lanes"):
        Engine(cfg, data_dir=str(tmp_path), device="cpu", lanes=2)


SPILL = dict(chunk_capacity=128, agg_table_size=64, agg_emit_capacity=256,
             join_table_size=1 << 10, join_bucket_cap=32,
             join_out_capacity=1 << 12, mv_table_size=1 << 10,
             mv_ring_size=1 << 12, agg_spill_ring=1 << 10)
N_GROUPS = 220  # past the 64-slot agg table


def _spill_engine(engine, par):
    if par:
        engine.execute(f"SET streaming_parallelism = {par}")
    engine.execute("CREATE TABLE item (id BIGINT, grp BIGINT, "
                   "PRIMARY KEY (id))")
    engine.execute("CREATE TABLE hit (item BIGINT, w BIGINT)")
    for i in range(0, N_GROUPS, 64):
        engine.execute("INSERT INTO item VALUES " + ",".join(
            f"({k},{k % 7})" for k in range(i, min(i + 64, N_GROUPS))))
    rows = [(i, 10 * i + r) for i in range(N_GROUPS) for r in range(2)]
    for i in range(0, len(rows), 64):
        engine.execute("INSERT INTO hit VALUES " + ",".join(
            f"({a},{b})" for a, b in rows[i:i + 64]))
    engine.execute(
        "CREATE MATERIALIZED VIEW mv AS SELECT h.item AS k, count(*) AS n, "
        "sum(h.w) AS s FROM hit h JOIN item i ON h.item = i.id "
        "GROUP BY h.item")
    engine.execute("FLUSH")
    engine.tick(barriers=4)
    return engine


def test_sharded_dag_spill_over_join_matches_reference():
    ref = _spill_engine(JEngine(JConfig(**SPILL)), 2)
    port = _spill_engine(Engine(PlannerConfig(**SPILL), device="cpu",
                                lanes=8), 2)
    job = port.jobs[0]
    assert isinstance(job, DagJob) and job.n_shards == ref.jobs[0].n_shards
    assert job.n_shards == 2
    _same(ref, port)
    want = [(i, 2, 20 * i + 1) for i in range(N_GROUPS)]
    assert _rows(port, "mv") == sorted(
        map(tuple, ref.execute("SELECT * FROM mv"))) == want
    tiers = {key: t for key, (_, t) in job._spill_tiers.items()}
    assert sorted(tiers) == [(1, 0, 0), (1, 0, 1)]
    assert all(t.rows_absorbed > 0 for t in tiers.values())
    assert sum(t.rows_absorbed for t in tiers.values()) == sum(
        t.rows_absorbed for ts in ref.jobs[0]._spill_tiers.values()
        for t in ts)
    lin = _spill_engine(Engine(PlannerConfig(**SPILL), device="cpu"), 0)
    assert _rows(lin, "mv") == want


def test_one_lane_plans_linearly():
    eng = _q8(Engine(PlannerConfig(**SIZES), device="cpu"))
    job = eng.jobs[0]
    assert isinstance(job, DagJob) and job.n_shards == 1
    assert job._shadow_shard_rows() is None and not job.exchanges
