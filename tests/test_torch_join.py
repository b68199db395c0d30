"""Port parity: the inner hash join with pool storage on both sides
(``stream/hash_join.py``) against the reference's ``HashJoinExecutor``.

The same numpy-built chunks go through the reference executor and the
port's (plain versions on the CPU): the ranked pool update
(``_update_side_pool``), ``apply_begin``, every emission window of
``emit_window``, ``clean_below`` and ``maybe_rehash`` (``rebuild_pool``
and ``compact_pool``).  Every window's columns, ops and valid flags and
every state tensor after each step must be equal.  Tolerance: none —
the path is integer end to end.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.common.chunk import Chunk as JChunk, StrCol as JStrCol
from risingwave_tpu.common.types import (
    DataType as JType,
    Field as JField,
    Schema as JSchema,
)
from risingwave_tpu.expr.node import InputRef as JRef
from risingwave_tpu.stream import hash_join as jhj
from risingwave_tpu_torch.common.chunk import Chunk
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.compat import state_from_numpy, state_mismatches
from risingwave_tpu_torch.expr.node import InputRef
from risingwave_tpu_torch.stream import hash_join as hj

OUT_CAP = 16
WINDOW = 1000


def _schemas(F, T, S):
    left = S((F("k", T.INT64), F("w", T.TIMESTAMP),
              F("name", T.VARCHAR, str_width=8)))
    right = S((F("k", T.INT64), F("w", T.TIMESTAMP), F("v", T.INT64)))
    return left, right


JL, JR = _schemas(JField, JType, JSchema)
TL, TR = _schemas(Field, DataType, Schema)


def _joins(pool: int):
    kw = dict(out_capacity=OUT_CAP, join_type="inner", left_storage="pool",
              right_storage="pool", left_pool_size=pool,
              right_pool_size=pool)
    j = jhj.HashJoinExecutor(JL, JR, [JRef(0), JRef(1)], [JRef(0), JRef(1)],
                             **kw)
    t = hj.HashJoinExecutor(TL, TR, [InputRef(0), InputRef(1)],
                            [InputRef(0), InputRef(1)], **kw)
    for ex in (j, t):
        ex.left_clean = ex.right_clean = (1, WINDOW, 1)
    return j, t


def _chunks(side, k, w, payload, cap):
    if side == "left":
        arrays = [k, w, np.array([f"n{x % 97}" for x in payload], object)]
        schemas = (JL, TL)
    else:
        arrays = [k, w, payload]
        schemas = (JR, TR)
    return (JChunk.from_numpy(schemas[0], arrays, capacity=cap),
            Chunk.from_numpy(schemas[1], arrays, capacity=cap))


def _planes(col):
    if hasattr(col, "lens"):
        return [np.asarray(col.data), np.asarray(col.lens)]
    return [np.asarray(col)]


_JIT: dict = {}


def _jitted(j):
    """The reference executor's entry points, jitted once per executor
    (eager JAX would compile every while_loop at every call)."""
    if id(j) not in _JIT:
        _JIT[id(j)] = (
            j,
            jax.jit(j.apply_begin, static_argnums=(2,)),
            jax.jit(j.emit_window, static_argnums=(3,)),
        )
    return _JIT[id(j)][1:]


def _apply_both(j, t, jst, tst, chunks, side):
    """apply_begin on both, then EVERY emission window in order; asserts
    the windows and the states equal.  Returns (jst, tst, windows)."""
    jc, tc = chunks
    j_begin, j_emit = _jitted(j)
    jst, jp = j_begin(jst, jc, side)
    tst, tp = t.apply_begin(tst, tc, side)
    total = int(jp.total)
    assert int(tp.total) == total
    jb, tb = j.build_rows_of(jst, side), t.build_rows_of(tst, side)
    w = 0
    while w == 0 or w * OUT_CAP < total:
        jo, jbound = j_emit(jb, jp, jnp.int32(w), side)
        to, tbound = t.emit_window(tb, tp, w, side)
        jst = jst._replace(emit_overflow=jst.emit_overflow + jbound)
        tst.emit_overflow.add_(tbound)
        np.testing.assert_array_equal(np.asarray(jo.ops), to.ops.numpy())
        np.testing.assert_array_equal(np.asarray(jo.valid),
                                      to.valid.numpy())
        assert [f.name for f in jo.schema] == [f.name for f in to.schema]
        for a, b in zip(jo.columns, to.columns):
            for x, y in zip(_planes(a), _planes(b)):
                np.testing.assert_array_equal(x, y)
        w += 1
    assert state_mismatches(jax.device_get(jst), tst) == []
    return jst, tst, w


def _start(pool):
    j, t = _joins(pool)
    jst = j.init_state()
    tst = state_from_numpy(jax.device_get(jst))
    assert state_mismatches(jax.device_get(jst), t.init_state("cpu")) == []
    return j, t, jst, tst


def test_rank_and_totals_from_sort_equal_the_reference():
    rng = np.random.default_rng(3)
    h = rng.choice(rng.integers(-2**63, 2**63 - 1, 9, dtype=np.int64), 200)
    active = rng.random(200) < 0.8
    vals = rng.random(200) < 0.6
    jr = jhj._rank_by_sorted(jnp.asarray(h.view(np.uint64)),
                             jnp.asarray(active))
    tr = hj._rank_by_sorted(torch.from_numpy(h), torch.from_numpy(active))
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(
        np.asarray(jhj._totals_from_sort(jr[1], jr[2], jnp.asarray(vals))),
        hj._totals_from_sort(tr[1], tr[2], torch.from_numpy(vals)).numpy())


def test_amplified_key_drains_several_windows():
    """One left key with 40 rows, probed by 3 right rows: 120 pairs in
    windows of 16, then the left side probes the right."""
    rng = np.random.default_rng(4)
    j, t, jst, tst = _start(1 << 9)
    k = np.concatenate([np.full(40, 7), rng.integers(100, 130, 24)])
    w = np.where(rng.random(64) < 0.9, 0, WINDOW)
    jst, tst, _ = _apply_both(j, t, jst, tst,
                              _chunks("left", k, w, np.arange(64), 64),
                              "left")
    k2 = np.concatenate([np.full(3, 7), rng.integers(100, 130, 29)])
    w2 = np.zeros(32, np.int64)
    jst, tst, n_w = _apply_both(j, t, jst, tst,
                                _chunks("right", k2, w2, rng.integers(
                                    0, 10**6, 32), 64), "right")
    assert n_w >= 8
    k3 = rng.integers(100, 130, 40)
    jst, tst, n_w = _apply_both(j, t, jst, tst,
                                _chunks("left", k3, np.zeros(40, np.int64),
                                        np.arange(40), 64), "left")
    assert n_w >= 2 and int(tst.emit_rows) > 150


def test_pool_overflow_unclaims_dropped_rows():
    """A 64-row pool: 40 rows land, their window is cleaned and the table
    rebuilt (the pool keeps its 40 dead rows, below the compaction
    point); 32 new rows then claim entries but only 24 pool rows are
    left, so 8 are dropped and their fresh claims tombstoned again."""
    rng = np.random.default_rng(5)
    j, t, jst, tst = _start(64)
    jst, tst, _ = _apply_both(j, t, jst, tst, _chunks(
        "left", rng.integers(0, 12, 40), np.zeros(40, np.int64),
        np.arange(40), 64), "left")
    jst = j.clean_below(jst, "left", 1, jnp.int64(WINDOW))
    tst = t.clean_below(tst, "left", 1, torch.tensor(WINDOW))
    jst = jax.jit(j.maybe_rehash)(jst)
    tst = t.maybe_rehash(tst)
    assert state_mismatches(jax.device_get(jst), tst) == []
    assert int(tst.left.pool_len) == 40
    jst, tst, _ = _apply_both(j, t, jst, tst, _chunks(
        "left", rng.integers(0, 12, 32), np.full(32, WINDOW),
        np.arange(32), 64), "left")
    assert int(tst.left.overflow) == 8
    assert int(tst.left.table.tombstone_count()) == 8
    assert int(tst.left.pool_len) == 64


def test_clean_rebuild_and_compaction_equal_the_reference():
    """Windows 0..5 on both sides, then a watermark clean of windows 0..2:
    the tombstones exceed a quarter of the table (rebuild_pool) and the
    dead rows an eighth of the nearly full pool (compact_pool); a later
    chunk still joins against the rebuilt, compacted state."""
    rng = np.random.default_rng(6)
    pool = 128
    j, t, jst, tst = _start(pool)
    for win in range(6):
        for side in ("left", "right"):
            k = rng.integers(0, 6, 16)
            w = np.full(16, win * WINDOW)
            jst, tst, _ = _apply_both(j, t, jst, tst, _chunks(
                side, k, w, rng.integers(0, 10**6, 16), 64), side)
    for side in ("left", "right"):
        jst = j.clean_below(jst, side, 1, jnp.int64(3 * WINDOW))
        tst = t.clean_below(tst, side, 1, torch.tensor(3 * WINDOW))
    assert state_mismatches(jax.device_get(jst), tst) == []
    assert int(tst.left.table.tombstone_count()) > pool // 4
    assert int(tst.left.pool_len) >= pool - pool // 4
    jst = jax.jit(j.maybe_rehash)(jst)
    tst = t.maybe_rehash(tst)
    assert state_mismatches(jax.device_get(jst), tst) == []
    for s in (tst.left, tst.right):
        assert int(s.table.tombstone_count()) == 0          # rebuilt
        assert int(s.pool_len) == int(s.table.count())      # compacted
    k = rng.integers(0, 6, 16)
    jst, tst, _ = _apply_both(j, t, jst, tst, _chunks(
        "right", k, np.full(16, 4 * WINDOW), np.arange(16), 64), "right")
    assert int(tst.emit_rows) > 0


@pytest.mark.parametrize("kw,error", [
    (dict(join_type="semi_outer"), ValueError),
    (dict(left_storage="bucket"), ValueError),
])
def test_join_variants_construct_and_unknown_ones_raise(kw, error):
    """An unknown join type or storage raises, and every join type of
    ``JOIN_TYPES`` over pool and dense storage constructs
    (``tests/test_torch_join_dense.py`` holds them against the
    reference)."""
    args = dict(out_capacity=OUT_CAP, join_type="inner", left_storage="pool",
                right_storage="pool")
    for jt in hj.JOIN_TYPES:
        for ls in ("pool", "dense"):
            hj.HashJoinExecutor(TL, TR, [InputRef(0)], [InputRef(0)],
                                **dict(args, join_type=jt, left_storage=ls))
    args.update(kw)
    with pytest.raises(error):
        hj.HashJoinExecutor(TL, TR, [InputRef(0)], [InputRef(0)], **args)


def test_dense_side_state_round_trips_through_compat():
    """A dense side's state (``SideState``) round-trips through compat:
    it converts to the port's and compares equal, element for element."""
    j = jhj.HashJoinExecutor(JL, JR, [JRef(0)], [JRef(0)], table_size=16,
                             bucket_cap=4, out_capacity=OUT_CAP)
    ref = jax.device_get(j.init_state())
    port = state_from_numpy(ref)
    assert isinstance(port.left, hj.SideState)
    assert port.left.occupied.shape == (16, 4)
    assert state_mismatches(ref, port) == []


def test_string_columns_survive_the_pool_round_trip():
    """Person names (strings) go through the pool and back out of the
    emission as bytes plus lengths."""
    j, t, jst, tst = _start(1 << 8)
    jc, tc = _chunks("left", np.array([5, 6]), np.zeros(2, np.int64),
                     np.array([1, 2]), 64)
    jst, tst, _ = _apply_both(j, t, jst, tst, (jc, tc), "left")
    jst, tst, _ = _apply_both(j, t, jst, tst, _chunks(
        "right", np.array([6, 5]), np.zeros(2, np.int64), np.array([9, 8]),
        64), "right")
    names = tst.left.rows[2]
    assert isinstance(names, type(tc.columns[2]))
    assert isinstance(jst.left.rows[2], JStrCol)
