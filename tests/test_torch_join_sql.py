"""Port parity: the join matrix through SQL — Nexmark q101 (left outer
join of auctions with each auction's max bid), q103 (semi join: auctions
with at least 20 bids) and q104 (anti join: auctions without fewer than
20 bids), their SQL text as RisingWave's Nexmark suite publishes it, plus
q8 with dense join storage forced, q8 as a LEFT JOIN, and q101 with a
one-sided ON condition pushed below the outer join.

Each query runs through the reference engine and the port's engine
(``device="cpu"``) on bench.py's bid source and an auction source with
``item_name`` and ``category``, at 10,000 events/s, chunk 256, a snapshot
every 2 checkpoints.  After every barrier the MV rows and every state
tensor (the aggregation with its spill ring, the pool and the dense join
sides, the MV) must be equal; ``recover()`` must restore both, and
q101's reference state carried into a fresh port engine must continue
identically.  Tolerance: none — the path is integer end to end.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import jax
import pytest

from bench import QUERIES, SOURCES
from risingwave_tpu.sql import Engine as JEngine
from risingwave_tpu.sql.planner import PlannerConfig as JConfig
from risingwave_tpu_torch.compat import state_from_numpy, state_mismatches
from risingwave_tpu_torch.sql import Engine
from risingwave_tpu_torch.sql.planner import PlannerConfig
from risingwave_tpu_torch.stream.hash_join import PoolSideState, SideState

#: bench.py's sources, the auction source with item_name and category
JOIN_SOURCES = SOURCES.replace(
    "id BIGINT, seller BIGINT, reserve BIGINT, expires TIMESTAMP,",
    "id BIGINT, item_name VARCHAR, seller BIGINT, reserve BIGINT,\n"
    "    expires TIMESTAMP, category BIGINT,")

#: RisingWave's Nexmark q101, q103 and q104, as published
JOIN_QUERIES = {
    "q101": """
CREATE MATERIALIZED VIEW nexmark_q101 AS
SELECT
    a.id AS auction_id,
    a.item_name AS auction_item_name,
    b.max_price AS current_highest_bid
FROM auction a
LEFT OUTER JOIN (
    SELECT
        b1.auction,
        MAX(b1.price) max_price
    FROM bid b1
    GROUP BY b1.auction
) b ON a.id = b.auction;
""",
    "q103": """
CREATE MATERIALIZED VIEW nexmark_q103 AS
SELECT
    a.id AS auction_id,
    a.item_name AS auction_item_name
FROM auction a
WHERE a.id IN (
    SELECT b.auction FROM bid b
    GROUP BY b.auction
    HAVING COUNT(*) >= 20
);
""",
    "q104": """
CREATE MATERIALIZED VIEW nexmark_q104 AS
SELECT
    a.id AS auction_id,
    a.item_name AS auction_item_name
FROM auction a
WHERE a.id NOT IN (
    SELECT b.auction FROM bid b
    GROUP BY b.auction
    HAVING COUNT(*) < 20
);
""",
}

SIZES = dict(chunk_capacity=256, agg_table_size=1 << 10,
             agg_emit_capacity=128, join_table_size=1 << 10,
             join_bucket_cap=8, join_pool_size=1 << 14,
             join_out_capacity=256, mv_table_size=1 << 14,
             mv_ring_size=1 << 16)
RATE = "10000"

#: (sql, extra config) of each case; the q8 cases were refused before
#: the join matrix and dense storage were ported
CASES = {
    "q101": (JOIN_QUERIES["q101"], {}),
    "q103": (JOIN_QUERIES["q103"], {}),
    "q104": (JOIN_QUERIES["q104"], {}),
    "q101_on": (JOIN_QUERIES["q101"].replace(
        "b ON a.id = b.auction", "b ON a.id = b.auction AND "
        "b.max_price > 5000000"), {}),
    "q8_left": (QUERIES["q8"].replace("JOIN TUMBLE", "LEFT JOIN TUMBLE"),
                {}),
    # dense buckets deep enough for the hot seller's auctions of a window
    "q8_dense": (QUERIES["q8"], dict(
        join_force_dense=True, join_left_bucket_cap=8,
        join_left_table_size=1 << 12,
        join_right_bucket_cap=1024, join_right_table_size=256)),
}


def _start(engine, sql):
    engine.execute(JOIN_SOURCES.format(rate=RATE))
    engine.execute(sql)
    engine.execute("ALTER SYSTEM SET snapshot_interval_checkpoints = 2")
    return engine


def _rows(engine):
    name = engine.jobs[0].name
    return sorted(engine.execute(f"SELECT * FROM {name}"), key=repr)


def _assert_same(jeng, teng):
    assert _rows(teng) == _rows(jeng)
    assert state_mismatches(jax.device_get(jeng.jobs[0].states),
                            teng.jobs[0].states) == []


def _join(engine):
    return next(n.join for n in engine.jobs[0].nodes if hasattr(n, "join"))


@pytest.mark.parametrize("case", sorted(CASES))
def test_join_query_rows_state_and_recover(case):
    sql, extra = CASES[case]
    jeng = _start(JEngine(JConfig(**SIZES, **extra)), sql)
    teng = _start(Engine(PlannerConfig(**SIZES, **extra), device="cpu"), sql)
    join = _join(teng)
    assert join.join_type == _join(jeng).join_type
    assert (join.left_storage, join.right_storage) == \
        (_join(jeng).left_storage, _join(jeng).right_storage)
    for _ in range(4):
        for e in (jeng, teng):
            e.tick(barriers=1, chunks_per_barrier=2)
        _assert_same(jeng, teng)
    jstate = teng.jobs[0].states[[type(n).__name__ for n in
                                  teng.jobs[0].nodes].index("JoinNode")]
    assert len(_rows(teng)) > 0
    if case.startswith("q10"):
        # auctions on a pool, the aggregation's retractable output dense
        assert isinstance(jstate.left, PoolSideState)
        assert isinstance(jstate.right, SideState)
        assert int(jstate.right.count.sum()) > 0
    for e in (jeng, teng):
        e.recover()
    _assert_same(jeng, teng)
    for e in (jeng, teng):
        e.tick(barriers=2, chunks_per_barrier=2)
    _assert_same(jeng, teng)
    if case != "q101":
        return
    # the reference's running state, carried into a fresh port engine
    carried = _start(Engine(PlannerConfig(**SIZES), device="cpu"), sql)
    cjob = carried.jobs[0]
    cjob.states = state_from_numpy(jax.device_get(jeng.jobs[0].states))
    for name, src in cjob.sources.items():
        src.offset = jeng.jobs[0].sources[name].offset
    for e in (jeng, carried):
        e.tick(barriers=2, chunks_per_barrier=2)
    _assert_same(jeng, carried)


def test_join_plans_shapes():
    """The plan shapes of the reference: q101 and q104's nodes, the
    left outer / semi / anti join types, the agg's spill ring, and the
    semi/anti output holding the auction columns only."""
    eng = Engine(PlannerConfig(**SIZES), device="cpu")
    eng.execute(JOIN_SOURCES.format(rate=RATE))
    for q, jt in (("q101", "left_outer"), ("q103", "left_semi"),
                  ("q104", "left_anti")):
        eng.execute(JOIN_QUERIES[q])
        job = eng.jobs[-1]
        execs = [[type(e).__name__ for e in n.fragment.executors]
                 if hasattr(n, "fragment") else type(n.join).__name__
                 for n in job.nodes]
        agg = ["HashAggExecutor", "ProjectExecutor"] if q == "q101" \
            else ["HashAggExecutor", "FilterExecutor", "ProjectExecutor"]
        assert execs == [["WatermarkFilterExecutor"],
                         ["WatermarkFilterExecutor"], agg,
                         "HashJoinExecutor",
                         ["ProjectExecutor", "MaterializeExecutor"]]
        assert job.nodes[2].fragment.executors[0].spill_ring == 4 * 256
        join = job.nodes[3].join
        assert join.join_type == jt
        assert (join.left_storage, join.right_storage) == ("pool", "dense")
        names = [f.name for f in join.out_schema]
        if jt == "left_outer":
            assert [f.nullable for f in join.out_schema][-2:] == [True, True]
        else:
            assert names[:2] == ["id", "item_name"] and "auction" not in names
