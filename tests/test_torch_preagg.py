"""Port parity: the agg's pre-aggregation branch (kernel K5's plain
version), the segment primitives, ``mask_indices`` (kernel K7's plain
version) and the ring append (kernel K8-ring's plain version).

The pre-aggregation branch is what the reference runs on an
accelerator.  Both packages choose it through ``accel_tuned``; the tests
force it on the CPU on both sides (the reference's
``risingwave_tpu.stream.hash_agg.accel_tuned`` and the port's
``risingwave_tpu_torch.stream.hash_agg.accel_tuned`` return True), feed
the same numpy chunks and compare every state tensor and every emitted
row.  Tolerance: none — every aggregate here is integer.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import risingwave_tpu.common.compact as jcompact
import risingwave_tpu.stream.hash_agg as jhash_agg
import risingwave_tpu_torch.stream.hash_agg as thash_agg
from bench import QUERIES, SOURCES
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
from risingwave_tpu.stream.materialize import AppendOnlyMaterialize as JRing
from risingwave_tpu_torch.common import compact as tcompact
from risingwave_tpu_torch.common.chunk import Chunk
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.compat import state_from_numpy, state_mismatches
from risingwave_tpu_torch.expr.agg import AggCall
from risingwave_tpu_torch.expr.node import InputRef
from risingwave_tpu_torch.sql import Engine
from risingwave_tpu_torch.sql.planner import PlannerConfig
from risingwave_tpu_torch.stream.materialize import AppendOnlyMaterialize

CAP = 64
SIZE = 1 << 8


@pytest.fixture
def preagg_both(monkeypatch):
    """Force the accelerator (pre-aggregation) branch on both sides."""
    monkeypatch.setattr(jhash_agg, "accel_tuned", lambda: True)
    monkeypatch.setattr(thash_agg, "accel_tuned", lambda device: True)


def _schemas(cols):
    return (JSchema(tuple(JField(n, getattr(JDT, t), nullable=nl)
                          for n, t, nl in cols)),
            Schema(tuple(Field(n, getattr(DataType, t), nullable=nl)
                         for n, t, nl in cols)))


def _chunks(jschema, tschema, arrays, ops):
    ops = np.asarray(ops, np.int8)
    return (JChunk.from_numpy(jschema, arrays, ops, capacity=CAP),
            Chunk.from_numpy(tschema, arrays, ops, capacity=CAP))


# ---------------------------------------------------------------------------
# segment primitives and mask_indices


def test_segment_primitives_identical():
    rng = np.random.default_rng(11)
    n = 500
    neq = rng.random(n - 1) < 0.2
    vals = rng.integers(-10**12, 10**12, n).astype(np.int64)
    j_starts = jcompact.segment_starts(jnp.asarray(neq))
    t_starts = tcompact.segment_starts(torch.from_numpy(neq))
    np.testing.assert_array_equal(np.asarray(j_starts), t_starts.numpy())
    j_pos = jcompact.segment_start_positions(j_starts)
    t_pos = tcompact.segment_start_positions(t_starts)
    np.testing.assert_array_equal(np.asarray(j_pos), t_pos.numpy())
    np.testing.assert_array_equal(
        np.asarray(jcompact.segmented_sum(jnp.asarray(vals), j_pos)),
        tcompact.segmented_sum(torch.from_numpy(vals), t_pos).numpy())
    ends = np.concatenate([neq, [True]])
    j_id = jnp.cumsum(j_starts.astype(jnp.int32))
    t_id = torch.cumsum(t_starts.to(torch.int32), 0, dtype=torch.int32)
    for mode in ("min", "max"):
        want = np.asarray(jcompact.segmented_minmax_at_ends(
            j_id, jnp.asarray(vals), j_pos, mode))
        got = tcompact.segmented_minmax_at_ends(
            t_id, torch.from_numpy(vals), t_pos, mode).numpy()
        np.testing.assert_array_equal(got[ends], want[ends])
        if mode == "min":  # the min stands on every row of its segment
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,density,k", [
    (1 << 12, 0.01, 64),     # fewer set bits than k: fill past them
    (1 << 12, 0.5, 64),      # more set bits than k: the first k
    (1000, 0.3, 1000),       # ragged length, k == n
    (17, 0.0, 8),            # empty mask
])
def test_mask_indices_identical_on_both_reference_branches(n, density, k,
                                                           monkeypatch):
    rng = np.random.default_rng(n + k)
    mask = rng.random(n) < density
    got = tcompact.mask_indices(torch.from_numpy(mask), k, n).numpy()
    assert got.dtype == np.int32
    for accel in (False, True):   # nonzero (CPU) and top_k (accelerator)
        monkeypatch.setattr(jcompact, "accel_tuned", lambda a=accel: a)
        want = np.asarray(jcompact.mask_indices(jnp.asarray(mask), k, n))
        np.testing.assert_array_equal(got, want)


def test_accel_tuned_follows_the_device():
    assert tcompact.accel_tuned("cuda") and tcompact.accel_tuned(
        torch.device("cuda", 0))
    assert not tcompact.accel_tuned("cpu")


# ---------------------------------------------------------------------------
# the pre-aggregation branch of HashAggExecutor

# (name, type, nullable): a window key, a nullable int32 key, values
AGG_COLS = [("ws", "TIMESTAMP", False), ("k2", "INT32", True),
            ("price", "INT64", False), ("qty", "INT32", True)]


def _agg_pair(calls, retractable: bool):
    jschema, tschema = _schemas(AGG_COLS)
    group = [("ws", 0), ("k2", 1)]
    kw = dict(table_size=SIZE, emit_capacity=32, watermark_group_idx=0,
              watermark_lag=10, watermark_src_col=0,
              retractable_input=retractable)
    jex = jhash_agg.HashAggExecutor(
        jschema, [(n, JRef(i)) for n, i in group],
        [JAggCall(k, None if a is None else JRef(a)) for k, a in calls], **kw)
    tex = thash_agg.HashAggExecutor(
        tschema, [(n, InputRef(i)) for n, i in group],
        [AggCall(k, None if a is None else InputRef(a)) for k, a in calls],
        **kw)
    return jschema, tschema, jex, tex


def _agg_chunk(rng, jschema, tschema, retractable: bool):
    """Few distinct keys (long runs after the sort), NULL keys and
    values, and for a retractable input deletes and U-/U+ pairs."""
    n = int(rng.integers(CAP // 2, CAP + 1))
    ws = rng.integers(0, 6, n).astype(np.int64) * 10
    k2 = np.asarray([None if v < 0.15 else int(v * 4) for v in
                     rng.random(n)], object)
    price = rng.integers(-10**6, 10**6, n).astype(np.int64)
    qty = np.asarray([None if v < 0.2 else int(v * 100)
                      for v in rng.random(n)], object)
    ops = np.zeros(n, np.int8)
    if retractable:
        ops = rng.choice(np.asarray([0, 1, 2, 3], np.int8), n)
        pairs = rng.random(n // 2) < 0.5    # some adjacent U-/U+ pairs
        for i in np.nonzero(pairs)[0]:
            ops[2 * i], ops[2 * i + 1] = 2, 3
    jc, tc = _chunks(jschema, tschema, [ws, k2, price, qty], ops)
    drop = rng.random(CAP) < 0.1           # some invisible rows
    return (jc.with_valid(jc.valid & jnp.asarray(~drop)),
            tc.with_valid(tc.valid & torch.from_numpy(~drop)))


def _run_agg_pair(rng, jschema, tschema, jex, tex, retractable, n_chunks=4):
    apply, flush = jax.jit(jex.apply), jax.jit(jex.flush)
    jst, tst = jex.init_state(), tex.init_state("cpu")
    for step in range(n_chunks):
        jc, tc = _agg_chunk(rng, jschema, tschema, retractable)
        jst, _ = apply(jst, jc)
        tst, _ = tex.apply(tst, tc)
        assert state_mismatches(jax.device_get(jst), tst) == []
        for _ in range(20):
            if int(jex.pending_flush(jst)) == 0:
                break
            jst, jout = flush(jst, 0)
            tst, tout = tex.flush(tst, 0)
            assert jout.to_rows() == tout.to_rows()
        assert int(tex.pending_flush(tst)) == 0
        assert state_mismatches(jax.device_get(jst), tst) == []
        if step == 1:   # cleaning frees slots the next chunk reclaims
            jst = jex.clean_below(jst, 0, 20)
            tst = tex.clean_below(tst, 0, 20)
    return jst, tst


@pytest.mark.parametrize("retractable,calls", [
    (False, [("max", 2), ("count_star", None), ("sum", 3), ("min", 3),
             ("count", 3)]),
    (True, [("count_star", None), ("sum", 2), ("sum0", 3), ("count", 3)]),
])
def test_preagg_branch_equals_reference_preagg(preagg_both, retractable,
                                               calls):
    rng = np.random.default_rng(21 + retractable)
    jschema, tschema, jex, tex = _agg_pair(calls, retractable)
    jst, tst = _run_agg_pair(rng, jschema, tschema, jex, tex, retractable)
    assert int(tst.table.occupied.sum()) > 0
    if not retractable:
        assert int(tst.inconsistency) == 0


def test_preagg_branch_with_colliding_hashes(preagg_both, monkeypatch):
    """Distinct keys with equal hashes must stay distinct segments and
    groups: both sides hash every key to one of two values."""
    def weak_j(cols):
        return jnp.asarray(cols[0], jnp.int64).astype(jnp.uint64) // \
            np.uint64(10) % np.uint64(2)

    def weak_t(cols):
        return cols[0] // 10 % 2

    monkeypatch.setattr(jhash_agg, "hash64_columns", weak_j)
    monkeypatch.setattr(thash_agg, "hash64_columns", weak_t)
    rng = np.random.default_rng(5)
    jschema, tschema, jex, tex = _agg_pair(
        [("count_star", None), ("sum", 2), ("max", 2)], False)
    jst, tst = _run_agg_pair(rng, jschema, tschema, jex, tex, False)
    assert int(tst.table.occupied.sum()) > 2


@pytest.mark.parametrize("query", ["q5", "q1"])
def test_engine_from_carried_reference_state(preagg_both, query):
    """q5 end to end with the pre-aggregation branch in the pane agg
    AND the final agg (whose input is the pane deltas, U-/U+ included),
    and q1's ring, from a reference state carried into the port mid-run
    (``compat.state_from_numpy``: pane agg, final agg, MV, ring)."""
    sizes = dict(chunk_capacity=256, agg_table_size=1 << 10,
                 agg_emit_capacity=64, mv_table_size=1 << 14,
                 mv_ring_size=1 << 14)
    engines = []
    for eng in (JEngine(JConfig(**sizes)),
                Engine(PlannerConfig(**sizes), device="cpu")):
        eng.execute(SOURCES.format(rate="2"))
        eng.execute(QUERIES[query])
        engines.append(eng)
    jeng, teng = engines
    jeng.tick(barriers=3, chunks_per_barrier=4)
    jjob, tjob = jeng.jobs[0], teng.jobs[0]
    tjob.states = state_from_numpy(jax.device_get(jjob.states))
    tjob.source.offset = jjob.source.offset
    for e in engines:
        e.tick(barriers=4, chunks_per_barrier=4)
    rows = [e.execute("SELECT * FROM bench_mv") for e in engines]
    assert rows[0] == rows[1] and len(rows[1]) > 100
    jst = jax.device_get(jjob.states)
    for i, st in enumerate(tjob.states):
        if st != ():
            assert state_mismatches(jst[i], st, f"states[{i}]") == []


# ---------------------------------------------------------------------------
# ring append with string and nullable columns

RING_COLS = [("a", "INT64", False), ("s", "VARCHAR", True),
             ("p", "DECIMAL", True)]


def test_ring_append_strings_nulls_and_laps():
    rng = np.random.default_rng(8)
    jschema, tschema = _schemas(RING_COLS)
    jex = JRing(jschema, ring_size=128)
    tex = AppendOnlyMaterialize(tschema, ring_size=128)
    jst, tst = jex.init_state(), tex.init_state("cpu")
    apply = jax.jit(jex.apply)
    for _ in range(5):
        a = rng.integers(0, 10**9, CAP).astype(np.int64)
        s = np.asarray([None if v < 0.2 else f"v{int(v * 1e6)}"
                        for v in rng.random(CAP)], object)
        p = np.asarray([None if v < 0.2 else round(v * 1000, 3)
                        for v in rng.random(CAP)], object)
        jc, tc = _chunks(jschema, tschema, [a, s, p], [0] * CAP)
        keep = rng.random(CAP) < 0.7
        jc = jc.with_valid(jc.valid & jnp.asarray(keep))
        tc = tc.with_valid(tc.valid & torch.from_numpy(keep))
        jst, _ = apply(jst, jc)
        tst, _ = tex.apply(tst, tc)
        assert state_mismatches(jax.device_get(jst), tst) == []
    assert int(tst.overflow) > 0
    assert jex.to_host(jax.device_get(jst)) == tex.to_host(tst)
