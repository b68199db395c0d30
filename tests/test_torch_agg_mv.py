"""Port parity: ``HashAggExecutor`` (kernel C's plain version) and the
materialize executors (kernel D's plain version).

Each test runs the reference executor into a state that holds
tombstones and a half-full table, carries that state into the port with
``compat.state_from_numpy``, then feeds both the same chunks and
compares every state tensor and every emitted row.  Tolerance: none —
the aggregates here are integer (count/sum/min/max), so results are
exact.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.common.chunk import Chunk as JChunk
from risingwave_tpu.common.types import (
    DataType as JDT,
    Field as JField,
    Schema as JSchema,
)
from risingwave_tpu.expr.agg import AggCall as JAggCall
from risingwave_tpu.expr.node import InputRef as JRef
from risingwave_tpu.stream.hash_agg import HashAggExecutor as JAgg
from risingwave_tpu.stream.materialize import (
    AppendOnlyMaterialize as JRing,
    MaterializeExecutor as JMv,
)
from risingwave_tpu.stream.message import Watermark as JWatermark
from risingwave_tpu_torch.common.chunk import Chunk
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.compat import (
    state_from_numpy,
    state_mismatches,
    state_to_numpy,
)
from risingwave_tpu_torch.expr.agg import AggCall
from risingwave_tpu_torch.expr.node import InputRef
from risingwave_tpu_torch.stream.hash_agg import HashAggExecutor
from risingwave_tpu_torch.stream.materialize import (
    AppendOnlyMaterialize,
    MaterializeExecutor,
)
from risingwave_tpu_torch.stream.message import Watermark

CAP = 64
SIZE = 1 << 8

# (name, type, nullable) of the agg input: window, price, quantity
IN_COLS = [("ws", "TIMESTAMP", False), ("price", "INT64", False),
           ("qty", "INT32", True)]


def _schemas(cols):
    return (JSchema(tuple(JField(n, getattr(JDT, t), nullable=nl)
                          for n, t, nl in cols)),
            Schema(tuple(Field(n, getattr(DataType, t), nullable=nl)
                         for n, t, nl in cols)))


def _chunks(jschema, tschema, arrays, ops):
    ops = np.asarray(ops, np.int8)
    return (JChunk.from_numpy(jschema, arrays, ops, capacity=CAP),
            Chunk.from_numpy(tschema, arrays, ops, capacity=CAP))


def _agg_pair(emit_capacity: int):
    jschema, tschema = _schemas(IN_COLS)
    calls = [("max", 1), ("count_star", None), ("sum", 2), ("min", 1),
             ("count", 2)]
    jex = JAgg(jschema, [("ws", JRef(0))],
               [JAggCall(k, None if a is None else JRef(a)) for k, a in calls],
               table_size=SIZE, emit_capacity=emit_capacity,
               watermark_group_idx=0, watermark_lag=10, watermark_src_col=0)
    tex = HashAggExecutor(
        tschema, [("ws", InputRef(0))],
        [AggCall(k, None if a is None else InputRef(a)) for k, a in calls],
        table_size=SIZE, emit_capacity=emit_capacity,
        watermark_group_idx=0, watermark_lag=10, watermark_src_col=0)
    return jschema, tschema, jex, tex


def _agg_chunk(rng, jschema, tschema, lo, hi, deletes=False):
    n = int(rng.integers(CAP // 2, CAP + 1))
    ws = rng.integers(lo, hi, n).astype(np.int64)
    price = rng.integers(-10**6, 10**6, n).astype(np.int64)
    qty = np.asarray([None if v < 0.2 else int(v * 100)
                      for v in rng.random(n)], object)
    ops = np.zeros(n, np.int8)
    if deletes:
        ops[rng.random(n) < 0.2] = 1
    return _chunks(jschema, tschema, [ws, price, qty], ops)


def _assert_out_equal(jout, tout):
    assert (jout is None) == (tout is None)
    if jout is not None:
        assert jout.to_rows() == tout.to_rows()


def _agg_reference_state(rng, jschema, tschema, jex):
    """A reference agg state with live groups, tombstones and dirt."""
    apply, flush = jax.jit(jex.apply), jax.jit(jex.flush)
    st = jex.init_state()
    for i in range(4):
        jc, _ = _agg_chunk(rng, jschema, tschema, 0, 150)
        st, _ = apply(st, jc)
        if i == 1:
            st, _ = flush(st, 0)
            st = jex.clean_below(st, 0, 60)
    assert int(st.table.tombstone_count()) > 0
    return st


@pytest.mark.parametrize("emit_capacity", [16, 256])
def test_hash_agg_apply_flush_clean_from_carried_state(emit_capacity):
    rng = np.random.default_rng(emit_capacity)
    jschema, tschema, jex, tex = _agg_pair(emit_capacity)
    jst = _agg_reference_state(rng, jschema, tschema, jex)
    tst = state_from_numpy(jax.device_get(jst))
    assert state_mismatches(jax.device_get(jst), tst) == []
    apply, flush = jax.jit(jex.apply), jax.jit(jex.flush)
    for step in range(3):
        jc, tc = _agg_chunk(rng, jschema, tschema, 50, 220,
                            deletes=step == 2)
        jst, jout = apply(jst, jc)
        tst, tout = tex.apply(tst, tc)
        _assert_out_equal(jout, tout)
        assert state_mismatches(jax.device_get(jst), tst) == []
        # drain the flush like the runtime does
        for _ in range(20):
            if int(jex.pending_flush(jst)) == 0:
                break
            jst, jout = flush(jst, 0)
            tst, tout = tex.flush(tst, 0)
            _assert_out_equal(jout, tout)
            assert state_mismatches(jax.device_get(jst), tst) == []
        assert int(tex.pending_flush(tst)) == 0
    wm_value = 120
    jst = jex.on_watermark(jst, JWatermark(0, jnp.int64(wm_value)))
    tst = tex.on_watermark(tst, Watermark(0, torch.tensor(wm_value)))
    assert state_mismatches(jax.device_get(jst), tst) == []
    assert int(tst.inconsistency) > 0  # deletes hit min/max states


def test_hash_agg_maybe_rehash_identical():
    rng = np.random.default_rng(5)
    jschema, tschema, jex, tex = _agg_pair(256)
    apply = jax.jit(jex.apply)
    jst = jex.init_state()
    for _ in range(6):
        jc, _ = _agg_chunk(rng, jschema, tschema, 0, 200)
        jst, _ = apply(jst, jc)
    jst = jex.clean_below(jst, 0, 170)
    tst = state_from_numpy(jax.device_get(jst))
    assert int(tst.table.tombstone_count()) > SIZE // 4
    jst = jex.maybe_rehash(jst)
    tst = tex.maybe_rehash(tst)
    assert int(tst.table.tombstone_count()) == 0
    assert state_mismatches(jax.device_get(jst), tst) == []


MV_COLS = [("ws", "TIMESTAMP", False), ("mx", "INT64", False),
           ("cnt", "INT64", True)]


def _mv_chunk(rng, jschema, tschema, keys, ops):
    n = len(keys)
    mx = rng.integers(0, 10**9, n).astype(np.int64)
    cnt = np.asarray([None if v < 0.2 else int(v * 1000)
                      for v in rng.random(n)], object)
    return _chunks(jschema, tschema, [np.asarray(keys, np.int64), mx, cnt],
                   ops)


def test_materialize_upsert_row_order_from_carried_state():
    rng = np.random.default_rng(2)
    jschema, tschema = _schemas(MV_COLS)
    jex = JMv(jschema, [0], table_size=SIZE)
    tex = MaterializeExecutor(tschema, [0], table_size=SIZE)
    apply = jax.jit(jex.apply)
    jst = jex.init_state()
    for _ in range(2):
        keys = rng.integers(0, 400, CAP)
        jc, _ = _mv_chunk(rng, jschema, tschema, keys, [0] * CAP)
        jst, _ = apply(jst, jc)
    dels = rng.integers(0, 400, CAP)
    jc, _ = _mv_chunk(rng, jschema, tschema, dels, [1] * CAP)
    jst, _ = apply(jst, jc)
    tst = state_from_numpy(jax.device_get(jst))
    assert int(tst.table.tombstone_count()) > 0
    # U-/U+ pairs, [+pk,-pk] ends absent, [-pk,+pk] ends present,
    # deletes of absent keys, plain inserts
    keys = [5, 5, 1001, 1001, 1002, 1002, 7, 7, 2000, 3000, 3000, 3000]
    ops = [2, 3, 0, 1, 1, 0, 1, 0, 1, 0, 0, 1]
    keys += list(rng.integers(0, 400, CAP - len(keys)))
    ops += list(rng.integers(0, 4, CAP - len(ops)))
    for _ in range(2):
        jc, tc = _mv_chunk(rng, jschema, tschema, keys, ops)
        jst, jout = apply(jst, jc)
        tst, tout = tex.apply(tst, tc)
        assert jout.to_rows() == tout.to_rows()
        assert state_mismatches(jax.device_get(jst), tst) == []
    rows = {r[0]: r for r in tex.to_host(tst)}
    assert 1001 not in rows and 1002 in rows
    assert sorted(jex.to_host(jax.device_get(jst))) == \
        sorted(tex.to_host(tst))
    jst = jex.maybe_rehash(jst)
    tst = tex.maybe_rehash(tst)
    assert state_mismatches(jax.device_get(jst), tst) == []


def test_append_only_ring_identical():
    rng = np.random.default_rng(4)
    jschema, tschema = _schemas(MV_COLS)
    jex, tex = JRing(jschema, ring_size=128), AppendOnlyMaterialize(
        tschema, ring_size=128)
    jst, tst = jex.init_state(), tex.init_state("cpu")
    apply = jax.jit(jex.apply)
    for _ in range(4):  # laps the ring: overflow counted on both
        keys = rng.integers(0, 10**6, CAP)
        jc, tc = _mv_chunk(rng, jschema, tschema, keys, [0] * CAP)
        valid = rng.random(CAP) < 0.8
        jc = jc.with_valid(jnp.asarray(valid) & jc.valid)
        tc = tc.with_valid(torch.from_numpy(valid) & tc.valid)
        jst, _ = apply(jst, jc)
        tst, _ = tex.apply(tst, tc)
        assert state_mismatches(jax.device_get(jst), tst) == []
    assert int(tst.overflow) > 0
    assert jex.to_host(jax.device_get(jst)) == tex.to_host(tst)
    assert state_to_numpy(tst).cursor == int(jst.cursor)
