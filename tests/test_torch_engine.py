"""Port parity: Nexmark q1, q5 and q7 end to end through the SQL
``Engine``.

``bench.py``'s source DDL and query text run unchanged through the
reference engine and the port's engine (``device="cpu"``) at a small
size: chunk 256, agg tables 2^10, emit 128, MV tables 2^10 (q7) or
2^14 (q5, which keeps every window), a 2^14 ring (q1), 7 barriers with a
snapshot every 2 checkpoints.  The MV rows must be identical, every
executor state equal slot for slot, and ``recover()`` must restore the
same MV on both.  Tolerance: none — q5 and q7 are integer end to end,
and q1's NUMERIC price is a scaled int64 printed by the same formula.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import jax
import numpy as np
import pytest
import torch

from bench import QUERIES, SOURCES
from risingwave_tpu.sql import Engine as JEngine
from risingwave_tpu.sql.planner import PlannerConfig as JConfig
from risingwave_tpu_torch.compat import state_mismatches
from risingwave_tpu_torch.connector.nexmark import NexmarkGenerator
from risingwave_tpu_torch.sql import Engine
from risingwave_tpu_torch.sql.planner import PlanError, PlannerConfig

SIZES = dict(chunk_capacity=256, agg_table_size=1 << 10,
             agg_emit_capacity=128, mv_table_size=1 << 10)
#: q5's MV keeps every (auction, window) it has seen: thousands at 2/s
SIZES_Q5_Q1 = dict(SIZES, mv_table_size=1 << 14, mv_ring_size=1 << 14)


def _start(engine, rate: str, query: str = "q7"):
    engine.execute(SOURCES.format(rate=rate))
    engine.execute(QUERIES[query])
    engine.execute("ALTER SYSTEM SET snapshot_interval_checkpoints = 2")
    return engine


def _value(v):
    return float(v) if isinstance(v, (float, np.floating)) else int(v)


def _rows(engine, sql="SELECT * FROM bench_mv"):
    return [tuple(_value(v) for v in r) for r in engine.execute(sql)]


def _assert_same_state(jeng, teng):
    """Every executor state (watermark, aggs, MV or ring) equal."""
    jst = jax.device_get(jeng.jobs[0].states)
    tst = teng.jobs[0].states
    assert [type(s).__name__ for s in tst] == \
        [type(s).__name__ for s in jst]
    stateful = [i for i, s in enumerate(tst) if s != ()]
    assert len(stateful) >= 2
    for i in stateful:
        assert state_mismatches(jst[i], tst[i], f"states[{i}]") == []


# rate 1M/s: one hot window; rate 2/s: hundreds of windows, watermark
# cleaning, tombstones, rehash at maintenance
@pytest.mark.parametrize("rate", ["1000000", "2"])
def test_q7_engine_rows_state_and_recover(rate):
    jeng = _start(JEngine(JConfig(**SIZES)), rate)
    teng = _start(Engine(PlannerConfig(**SIZES), device="cpu"), rate)
    for e in (jeng, teng):
        e.tick(barriers=7, chunks_per_barrier=4)
    assert _rows(teng) == _rows(jeng)
    assert len(_rows(teng)) > 0
    _assert_same_state(jeng, teng)
    assert teng.metrics.get("stream_rows_total", job="bench_mv") == \
        jeng.metrics.get("stream_rows_total", job="bench_mv")
    ordered = "SELECT * FROM bench_mv ORDER BY bids DESC, window_start LIMIT 5"
    assert _rows(teng, ordered) == _rows(jeng, ordered)
    assert teng.query("SELECT bids, window_start FROM bench_mv")[0] == \
        ["bids", "window_start"]

    # recover rewinds both to the last snapshot (barrier 6 of 7)
    for e in (jeng, teng):
        e.recover()
    assert _rows(teng) == _rows(jeng)
    _assert_same_state(jeng, teng)
    for e in (jeng, teng):
        e.tick(barriers=2, chunks_per_barrier=4)
    assert _rows(teng) == _rows(jeng)
    _assert_same_state(jeng, teng)


def test_entry_points_without_device_need_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(PlannerConfig(**SIZES))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        NexmarkGenerator()


# q5: pane tumble -> pane agg -> hop expand of the pane deltas ->
# retractable final agg; q1: NUMERIC project into the append-only ring
@pytest.mark.parametrize("rate", ["1000000", "2"])
@pytest.mark.parametrize("query,ordered", [
    ("q5", "SELECT * FROM bench_mv ORDER BY bids DESC, auction, "
           "window_start LIMIT 5"),
    ("q1", "SELECT auction, price, date_time FROM bench_mv "
           "ORDER BY price DESC, date_time LIMIT 5"),
])
def test_q5_q1_engine_rows_state_and_recover(query, ordered, rate):
    jeng = _start(JEngine(JConfig(**SIZES_Q5_Q1)), rate, query)
    teng = _start(Engine(PlannerConfig(**SIZES_Q5_Q1), device="cpu"), rate,
                  query)
    assert repr(teng.jobs[0].fragment) == repr(jeng.jobs[0].fragment)
    for e in (jeng, teng):
        e.tick(barriers=7, chunks_per_barrier=4)
    assert _rows(teng) == _rows(jeng)
    assert len(_rows(teng)) > 0
    _assert_same_state(jeng, teng)
    assert _rows(teng, ordered) == _rows(jeng, ordered)
    for e in (jeng, teng):
        e.recover()
    assert _rows(teng) == _rows(jeng)
    _assert_same_state(jeng, teng)
    for e in (jeng, teng):
        e.tick(barriers=2, chunks_per_barrier=4)
    assert _rows(teng) == _rows(jeng)
    _assert_same_state(jeng, teng)


def test_pane_plan_needing_retractable_min_max_raises():
    """A HOP max() plans through panes, whose final agg needs min/max
    over a retractable input: that materialized-input state is ported
    now, so the plan no longer raises; the final agg keeps the max in
    buckets of max(64, 2k) values and the MV has rows
    (tests/test_torch_minput.py holds it against the reference)."""
    from risingwave_tpu_torch.stream.hash_agg import HashAggExecutor

    eng = Engine(PlannerConfig(**SIZES), device="cpu")
    eng.execute(SOURCES.format(rate="1000000"))
    eng.execute(QUERIES["q5"].replace("count(*) AS bids",
                                      "max(price) AS top"))
    aggs = [ex for ex in eng.jobs[0].fragment.executors
            if isinstance(ex, HashAggExecutor)]
    assert [a._minput_aggs for a in aggs] == [[], [0]]
    assert aggs[-1].minput_bucket_cap == 64
    eng.tick(barriers=2, chunks_per_barrier=2)
    assert len(eng.execute("SELECT * FROM bench_mv")) > 0


@pytest.mark.parametrize("sql,error", [
    # q8 and its outer-join forms run (tests/test_torch_dag.py,
    # tests/test_torch_join_sql.py); a full outer join cannot push an ON
    # condition on one side below the join
    pytest.param(QUERIES["q8"].replace("JOIN TUMBLE", "FULL JOIN TUMBLE")
                 .replace("a.window_start;",
                          "a.window_start AND a.reserve > 10;"),
                 PlanError, id="q8_full_outer"),
])
def test_unported_plans_raise(sql, error):
    eng = Engine(PlannerConfig(**SIZES), device="cpu")
    eng.execute(SOURCES.format(rate="1000000"))
    with pytest.raises(error):
        eng.execute(sql)
