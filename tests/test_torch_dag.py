"""Port parity: Nexmark q8 (the windowed person x auction join) end to
end through the SQL ``Engine``, as a ``DagJob``.

``bench.py``'s source DDL and q8 text run unchanged through the
reference engine and the port's engine (``device="cpu"``) at 10,000
events/s, chunk 256, pools of 2^14 rows on both sides and emission
windows of 64 rows: each barrier drains amplified chunks over several
windows, cleans closed windows from both sides, and ``rebuild_pool``
and ``compact_pool`` fire.  (At the 2 events/s of the q1/q5/q7 tests,
persons arrive 25 s apart and no 1-second window ever holds a pair.)
After every barrier the ring rows must be equal in order and every
state tensor (watermarks, both join sides, counters, the ring) equal;
``recover()`` must restore both; and the reference's state carried into
a fresh port engine must continue identically.  Tolerance: none — the
path is integer end to end and tags compare by bit pattern.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import jax
import pytest

from bench import QUERIES, SOURCES
from risingwave_tpu.sql import Engine as JEngine
from risingwave_tpu.sql.planner import PlannerConfig as JConfig
from risingwave_tpu_torch.compat import state_from_numpy, state_mismatches
from risingwave_tpu_torch.sql import Engine
from risingwave_tpu_torch.sql.planner import PlanError, PlannerConfig
from risingwave_tpu_torch.stream.dag import DagJob

SIZES = dict(chunk_capacity=256, join_pool_size=1 << 14,
             join_out_capacity=64, mv_ring_size=1 << 16)
RATE = "10000"


def _start(engine):
    engine.execute(SOURCES.format(rate=RATE))
    engine.execute(QUERIES["q8"])
    engine.execute("ALTER SYSTEM SET snapshot_interval_checkpoints = 2")
    return engine


def _rows(engine):
    return engine.execute("SELECT * FROM bench_mv")


def _assert_same(jeng, teng):
    assert _rows(teng) == _rows(jeng)
    assert state_mismatches(jax.device_get(jeng.jobs[0].states),
                            teng.jobs[0].states) == []
    assert teng.metrics.get("stream_rows_total", job="bench_mv") == \
        jeng.metrics.get("stream_rows_total", job="bench_mv")


def test_q8_engine_rows_state_recover_and_carried_state():
    jeng = _start(JEngine(JConfig(**SIZES)))
    teng = _start(Engine(PlannerConfig(**SIZES), device="cpu"))
    job = teng.jobs[0]
    assert isinstance(job, DagJob)
    assert [type(n).__name__ for n in job.nodes] == \
        ["FragNode", "FragNode", "JoinNode", "FragNode"]
    assert job._pulls == [("p", 1), ("a", 3)]
    assert job.nodes[2].join.left_clean == (1, 1_000_000, 2)
    assert job.nodes[2].join.right_clean == (1, 1_000_000, 4)
    for _ in range(8):
        for e in (jeng, teng):
            e.tick(barriers=1, chunks_per_barrier=4)
        _assert_same(jeng, teng)
    js = teng.jobs[0].states[2]
    assert len(_rows(teng)) > 20_000
    assert int(js.emit_windows) > int(js.chunks)  # multi-window drains
    assert job.rehash_fired.get("rebuild_pool", 0) >= 2
    assert job.rehash_fired.get("compact_pool", 0) >= 1
    # 16 join chunks a barrier, one emission-total read each; one read
    # of the rehash conditions a barrier, and one more per rebuild
    assert job.window_reads == 8 * 16
    assert job.barrier_reads == 8 + job.rehash_fired["rebuild_pool"]
    rows = teng.metrics.get("stream_rows_total", job="bench_mv")
    assert rows == 8 * 4 * 4 * 256

    # recover rewinds both to the last snapshot (barrier 8)
    for e in (jeng, teng):
        e.recover()
    _assert_same(jeng, teng)
    for e in (jeng, teng):
        e.tick(barriers=2, chunks_per_barrier=4)
    _assert_same(jeng, teng)

    # the reference's running state, carried into a fresh port engine
    carried = _start(Engine(PlannerConfig(**SIZES), device="cpu"))
    cjob = carried.jobs[0]
    cjob.states = state_from_numpy(jax.device_get(jeng.jobs[0].states))
    for name, src in cjob.sources.items():
        src.offset = jeng.jobs[0].sources[name].offset
    for e in (jeng, carried):
        e.tick(barriers=3, chunks_per_barrier=4)
    assert _rows(carried) == _rows(jeng)
    assert state_mismatches(jax.device_get(jeng.jobs[0].states),
                            cjob.states) == []


@pytest.mark.parametrize("query,config", [
    # a full outer join cannot push a one-sided ON condition down
    (QUERIES["q8"].replace("JOIN TUMBLE", "FULL JOIN TUMBLE").replace(
        "p.window_start = a.window_start",
        "p.window_start = a.window_start AND a.reserve > 10"), {}),
    # aggregation over the join, HAVING against a correlated scalar
    # subquery (an uncorrelated one peels into a dynamic filter:
    # ``tests/test_torch_q102_sql.py``)
    (QUERIES["q8"].replace("p.name AS name, a.reserve AS reserve",
                           "count(*) AS n").replace(
        ";", " GROUP BY p.id HAVING count(*) > (SELECT count(*) FROM bid b "
        "WHERE b.auction = p.id);"), {}),
    # a non-equality ON condition
    (QUERIES["q8"].replace("p.id = a.seller", "p.id > a.seller"), {}),
    # WHERE over the join
    (QUERIES["q8"].replace(";", " WHERE a.reserve > 10;"), {}),
    # a residual ON condition on an inner join
    (QUERIES["q8"].replace("p.id = a.seller", "p.id = a.seller AND "
                           "p.id < a.reserve"), {}),
    # a nested (three-way) join
    (QUERIES["q8"].replace(
        "ON p.id = a.seller AND p.window_start = a.window_start",
        "ON p.id = a.seller AND p.window_start = a.window_start "
        "JOIN bid b ON b.auction = a.id"), {}),
])
def test_unported_join_plans_raise(query, config):
    """What the port still refuses (the LEFT JOIN and dense-storage cases
    that stood here plan now: ``tests/test_torch_join_sql.py``; so does an
    aggregation over a join)."""
    eng = Engine(PlannerConfig(**SIZES, **config), device="cpu")
    eng.execute(SOURCES.format(rate=RATE))
    with pytest.raises(PlanError):
        eng.execute(query)
