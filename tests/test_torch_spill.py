"""Port parity: the aggregation's spill ring and its host tier.

An aggregation without watermark cleaning diverts the rows its table
cannot hold into a spill ring (``HashAggExecutor.spill_ring``), which
drains at snapshot barriers into a host tier (``stream/spill.py``) whose
changelog joins the device's downstream.  With the agg table forced
small, the same inputs go through the reference and the port (plain
versions on the CPU):

- the capture itself on both of the reference's branches (per-row, and
  pre-aggregated with the segments' overflow scattered back through the
  sort), ring overflow included: every state tensor equal;
- Nexmark q101 through both engines (``DagJob``: the tier's changelog
  runs through the agg's projection into the join) and a keyed count
  per auction (``StreamingJob``): MV rows, every state tensor and the
  tier's state equal after every barrier and after ``recover()``;
- a durable q101 (``Engine(config, data_dir=...)``): the tier is saved
  under its own store key, and a cold start equals an engine that never
  stopped, tier included.

Tolerance: none — every value here is integer.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import jax
import numpy as np
import pytest

from risingwave_tpu.common.chunk import Chunk as JChunk
from risingwave_tpu.common.types import (
    DataType as JDT,
    Field as JField,
    Schema as JSchema,
)
from risingwave_tpu.expr.agg import AggCall as JAggCall
from risingwave_tpu.expr.node import InputRef as JRef
from risingwave_tpu.sql import Engine as JEngine
from risingwave_tpu.sql.planner import PlannerConfig as JConfig
from risingwave_tpu.stream import hash_agg as jhash_agg
from risingwave_tpu_torch.common.chunk import Chunk
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.compat import state_mismatches
from risingwave_tpu_torch.expr.agg import AggCall
from risingwave_tpu_torch.expr.node import InputRef
from risingwave_tpu_torch.sql import Engine
from risingwave_tpu_torch.sql.planner import PlannerConfig
from risingwave_tpu_torch.stream import hash_agg as thash_agg
from tests.test_torch_join_sql import JOIN_QUERIES, JOIN_SOURCES

COLS = [("k", "INT64", False), ("s", "VARCHAR", False),
        ("v", "INT64", True)]
JS = JSchema(tuple(JField(n, getattr(JDT, t), nullable=nl,
                          **({"str_width": 8} if t == "VARCHAR" else {}))
                   for n, t, nl in COLS))
TS = Schema(tuple(Field(n, getattr(DataType, t), nullable=nl,
                        **({"str_width": 8} if t == "VARCHAR" else {}))
                  for n, t, nl in COLS))


def _aggs(ring):
    kw = dict(table_size=8, emit_capacity=16, spill_ring=ring)
    j = jhash_agg.HashAggExecutor(
        JS, [("k", JRef(0))], [JAggCall("count_star", None),
                               JAggCall("sum", JRef(2))], **kw)
    t = thash_agg.HashAggExecutor(
        TS, [("k", InputRef(0))], [AggCall("count_star", None),
                                   AggCall("sum", InputRef(2))], **kw)
    return j, t


def _chunk_pair(rng, n, cap):
    keys = rng.integers(0, 40, n)
    vals = np.array([None if x % 5 == 0 else int(x) for x in
                     rng.integers(0, 1000, n)], object)
    arrays = [keys, np.array([f"s{k % 7}" for k in keys], object), vals]
    return (JChunk.from_numpy(JS, arrays, capacity=cap),
            Chunk.from_numpy(TS, arrays, capacity=cap))


@pytest.mark.parametrize("preagg", [False, True])
def test_spill_capture_matches_reference(preagg, monkeypatch):
    """Rows past a full 8-slot table divert into a 48-row ring, in chunk
    order, until the ring is full; the rest count as overflow."""
    monkeypatch.setattr(jhash_agg, "accel_tuned", lambda: preagg)
    monkeypatch.setattr(thash_agg, "accel_tuned", lambda device: preagg)
    j, t = _aggs(ring=48)
    jst, tst = j.init_state(), t.init_state("cpu")
    apply = jax.jit(j.apply)
    rng = np.random.default_rng(7)
    for n in (12, 32, 32):
        jc, tc = _chunk_pair(rng, n, cap=32)
        jst, _ = apply(jst, jc)
        tst, _ = t.apply(tst, tc)
        assert state_mismatches(jax.device_get(jst), tst) == []
    assert int(tst.spill_count) == 48 and int(tst.overflow) > 0
    # the drain empties the ring into a chunk of the diverted rows
    jst, jd = j.drain_spill(jst)
    tst, td = t.drain_spill(tst)
    assert int(td.valid.sum()) == 48 and int(tst.spill_count) == 0
    np.testing.assert_array_equal(np.asarray(jd.valid), td.valid.numpy())
    np.testing.assert_array_equal(np.asarray(jd.ops), td.ops.numpy())
    assert state_mismatches(jax.device_get(jst), tst) == []


SPILL_SIZES = dict(chunk_capacity=256, agg_table_size=16,
                   agg_emit_capacity=128, agg_spill_table_size=1 << 11,
                   join_table_size=1 << 11, join_bucket_cap=8,
                   join_pool_size=1 << 14, join_out_capacity=256,
                   mv_table_size=1 << 14)
COUNT_SQL = """
CREATE MATERIALIZED VIEW bid_counts AS
SELECT auction, COUNT(*) AS n, MAX(price) AS top FROM bid GROUP BY auction;
"""


def _start(engine, sql):
    engine.execute(JOIN_SOURCES.format(rate="10000"))
    engine.execute(sql)
    return engine


def _tier_states(engine):
    """The spill tiers' states of an engine's job: the port keeps
    ``(suffix, tier)`` per aggregation, the reference's ``DagJob`` a
    list of per-shard tiers and its ``StreamingJob`` ``_spill``."""
    job = engine.jobs[0]
    if hasattr(job, "_spill"):
        return [t.state for *_, t in job._spill]
    return [t[1].state if isinstance(t, tuple) else t[0].state
            for _, t in sorted(getattr(job, "_spill_tiers", {}).items())]


def _assert_same(jeng, teng):
    name = teng.jobs[0].name
    q = f"SELECT * FROM {name}"
    assert sorted(teng.execute(q), key=repr) == \
        sorted(jeng.execute(q), key=repr)
    assert state_mismatches(jax.device_get(jeng.jobs[0].states),
                            teng.jobs[0].states) == []
    jt, tt = _tier_states(jeng), _tier_states(teng)
    assert len(tt) == 1
    if not jt:
        # the reference's DagJob builds its tier at the first drain
        assert not teng.jobs[0]._spill_tiers[(2, 0)][1].rows_absorbed
        return
    assert state_mismatches(jax.device_get(jt[0]), tt[0]) == []


@pytest.mark.parametrize("query", ["q101", "counts"])
def test_spill_tier_rows_state_and_recover(query):
    sql = JOIN_QUERIES["q101"] if query == "q101" else COUNT_SQL
    jeng = _start(JEngine(JConfig(**SPILL_SIZES)), sql)
    teng = _start(Engine(PlannerConfig(**SPILL_SIZES), device="cpu"), sql)
    for e in (jeng, teng):
        e.execute("ALTER SYSTEM SET snapshot_interval_checkpoints = 2")
    for _ in range(4):
        for e in (jeng, teng):
            e.tick(barriers=1, chunks_per_barrier=2)
        _assert_same(jeng, teng)
    tier = _tier_states(teng)[0]
    assert int(tier.table.occupied.sum()) > 0  # groups live on the host
    assert teng.jobs[0].spill_reads == 2
    for e in (jeng, teng):
        e.recover()
    _assert_same(jeng, teng)
    for e in (jeng, teng):
        e.tick(barriers=2, chunks_per_barrier=2)
    _assert_same(jeng, teng)


def test_durable_spill_tier_cold_start(tmp_path):
    """The tier's epochs are saved under ``<job>@spill<node>_<exec>``; a
    cold start rewinds it with the job, and the MV, every device tensor
    and the tier then continue as in an engine that never stopped."""
    sql = JOIN_QUERIES["q101"]
    cfg = PlannerConfig(**dict(SPILL_SIZES, agg_table_size=4))
    d = str(tmp_path / "data")
    eng = _start(Engine(cfg, data_dir=d, device="cpu"), sql)
    ref = _start(Engine(cfg, device="cpu"), sql)
    for e in (eng, ref):
        e.tick(barriers=4, chunks_per_barrier=2)
    job = eng.jobs[0]
    assert job._spill_tiers[(2, 0)][1].rows_absorbed > 0
    assert eng.checkpoint_store.epochs(job._spill_key("2_0")) != []
    del eng
    cold = Engine(cfg, data_dir=d, device="cpu")
    for e in (cold, ref):
        e.tick(barriers=2, chunks_per_barrier=2)
    name = ref.jobs[0].name
    assert sorted(cold.execute(f"SELECT * FROM {name}"), key=repr) == \
        sorted(ref.execute(f"SELECT * FROM {name}"), key=repr)
    from risingwave_tpu_torch.compat import state_to_numpy
    assert state_mismatches(state_to_numpy(ref.jobs[0].states),
                            cold.jobs[0].states) == []
    assert state_mismatches(state_to_numpy(_tier_states(ref)[0]),
                            _tier_states(cold)[0]) == []
