"""Port parity: Nexmark q7 end to end through the SQL ``Engine``.

``bench.py``'s source DDL and q7 text run unchanged through the
reference engine and the port's engine (``device="cpu"``) at a small
size: chunk 256, tables 2^10, emit 128, 7 barriers with a snapshot
every 2 checkpoints.  The MV rows must be identical, the agg state
equal slot for slot, and ``recover()`` must restore the same MV on
both.  Tolerance: none — q7 is integer end to end.
"""

import jax
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


def _start(engine, rate: str):
    engine.execute(SOURCES.format(rate=rate))
    engine.execute(QUERIES["q7"])
    engine.execute("ALTER SYSTEM SET snapshot_interval_checkpoints = 2")
    return engine


def _rows(engine, sql="SELECT * FROM bench_mv"):
    return [tuple(int(v) for v in r) for r in engine.execute(sql)]


def _assert_same_state(jeng, teng):
    jst = jax.device_get(jeng.jobs[0].states)
    tst = teng.jobs[0].states
    assert [type(s).__name__ for s in tst] == \
        [type(s).__name__ for s in jst]
    for i in (0, 2, 4):  # watermark, hash agg, materialize
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


@pytest.mark.parametrize("query,error", [
    ("q5", NotImplementedError),   # HOP pane aggregation: queued
    ("q8", PlanError),             # join: queued
])
def test_unported_plans_raise(query, error):
    eng = Engine(PlannerConfig(**SIZES), device="cpu")
    eng.execute(SOURCES.format(rate="1000000"))
    with pytest.raises(error):
        eng.execute(QUERIES[query])
