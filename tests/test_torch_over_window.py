"""Port parity: the over-window (``stream/over_window.py``) and
watermark cleaning (K19a).

The port's plain versions run on the CPU against the reference's
executors on the same numpy-seeded inputs:

- the reference's five ``tests/test_over_window.py`` cases, as parity
  cases of one test;
- every call kind (row_number, rank, dense_rank, lag, lead, sum, count,
  avg, min, max), ``ROWS 0/1/10 PRECEDING``, ties under one and two
  order keys, string lag/lead and a string partition key, float32,
  float64 (dyadic, so every sum is exact) and int32 arguments,
  retractable chunks (deletes of pool rows, in-chunk +/- pairs, deletes
  of rows the pool lacks), more live rows than the emit window (the
  ``overflow`` gauge), an emit window wider than the pool, no partition
  and no order key: out chunks and every state tensor after each flush;
- the window values of float arguments that do not add exactly;
- ``on_watermark`` / ``clean_below`` on both executors.

The window queries through SQL are in ``test_torch_over_window_sql.py``.

Tolerance: none (integers, dyadic floats and hashes compare bit for
bit), except the float64 sums and averages of non-dyadic float
arguments, which add in another order than XLA's cumsum: relative 1e-12.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import risingwave_tpu.stream.over_window as jow
import risingwave_tpu.stream.top_n as jtop_n
import risingwave_tpu_torch.stream.over_window as tow
import risingwave_tpu_torch.stream.top_n as ttop_n
from risingwave_tpu.common.chunk import Chunk as JChunk, StrCol as JStrCol
from risingwave_tpu.common.types import (
    DataType as JDT,
    Field as JField,
    Schema as JSchema,
)
from risingwave_tpu.expr.node import InputRef as JRef
from risingwave_tpu.stream.message import Watermark as JWatermark
from risingwave_tpu_torch.common.chunk import Chunk, StrCol
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.compat import state_from_numpy, state_mismatches
from risingwave_tpu_torch.expr.node import InputRef
from risingwave_tpu_torch.stream.message import Watermark

W = 6
COLS = [("p", "INT64", 0), ("v", "INT64", 0), ("s", "VARCHAR", W),
        ("f", "FLOAT64", 0), ("g", "FLOAT32", 0), ("i", "INT32", 0),
        ("t", "TIMESTAMP", 0)]
JSCHEMA = JSchema(tuple(JField(n, getattr(JDT, t), str_width=w or 16)
                        for n, t, w in COLS))
TSCHEMA = Schema(tuple(Field(n, getattr(DataType, t), str_width=w or 16)
                       for n, t, w in COLS))
P, V, S_, F, G, I, T = range(7)


def _rows(rng, n, parts=4, dyadic=True):
    """n random rows: few partitions (one hot), small values with ties,
    strings with random bytes past their length."""
    p = np.where(rng.random(n) < 0.6, 0, rng.integers(0, parts, n))
    f = rng.integers(-40, 40, n) / 8.0 if dyadic \
        else rng.standard_normal(n)
    return [p.astype(np.int64), rng.integers(-5, 5, n).astype(np.int64),
            (rng.integers(0, 256, (n, W)).astype(np.uint8),
             rng.integers(0, W + 1, n).astype(np.int32)),
            f.astype(np.float64),
            (rng.integers(-40, 40, n) / 4.0).astype(np.float32),
            rng.integers(-9, 9, n).astype(np.int32),
            rng.integers(0, 30, n).astype(np.int64)]


def _take(cols, idx):
    return [(c[0][idx], c[1][idx]) if isinstance(c, tuple) else c[idx]
            for c in cols]


def _chunks(cols, ops, valid, jschema=JSCHEMA, tschema=TSCHEMA):
    """The same chunk for both packages."""
    jc, tc = [], []
    for c in cols:
        if isinstance(c, tuple):
            jc.append(JStrCol(jnp.asarray(c[0]), jnp.asarray(c[1])))
            tc.append(StrCol(torch.from_numpy(c[0].copy()),
                             torch.from_numpy(c[1].copy())))
        else:
            jc.append(jnp.asarray(c))
            tc.append(torch.from_numpy(c.copy()))
    ops, valid = np.asarray(ops, np.int8), np.asarray(valid, bool)
    return (JChunk(tuple(jc), jnp.asarray(ops), jnp.asarray(valid), jschema),
            Chunk(tuple(tc), torch.from_numpy(ops.copy()),
                  torch.from_numpy(valid.copy()), tschema))


def _mixed_chunk(rng, held, cap):
    """cap rows: fresh inserts, deletes of held rows (one twice), an
    in-chunk +/- pair and a delete of a row never inserted; a few rows
    invisible."""
    fresh = _rows(rng, cap)
    ops = np.zeros(cap, np.int8)
    cols = fresh
    n_held = held[0].shape[0]
    if n_held:
        k = min(cap // 4, n_held)
        victims = rng.choice(n_held, k, replace=False)
        victims[-1] = victims[0]
        kept = _take(fresh, np.arange(k, cap))
        cols = [(np.concatenate([a[0], b[0]]), np.concatenate([a[1], b[1]]))
                if isinstance(a, tuple) else np.concatenate([a, b])
                for a, b in zip(_take(held, victims), kept)]
        ops[:k] = rng.choice([1, 2], k)            # Delete / UpdateDelete
    pair = np.array([cap - 3, cap - 2])
    for c in cols:                                 # an in-chunk +/- pair
        if isinstance(c, tuple):
            c[0][pair[1]], c[1][pair[1]] = c[0][pair[0]], c[1][pair[0]]
        else:
            c[pair[1]] = c[pair[0]]
    ops[cap - 3:] = [0, 1, 1]                      # +, - and a stray -
    valid = rng.random(cap) < 0.9
    valid[cap - 3:] = True
    return cols, ops, valid


def _assert_chunks(jout, tout):
    np.testing.assert_array_equal(np.asarray(jout.ops), tout.ops.numpy())
    np.testing.assert_array_equal(np.asarray(jout.valid), tout.valid.numpy())
    for j, (a, b) in enumerate(zip(jout.columns, tout.columns)):
        if isinstance(a, JStrCol):
            np.testing.assert_array_equal(np.asarray(a.data), b.data.numpy())
            np.testing.assert_array_equal(np.asarray(a.lens), b.lens.numpy())
        else:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f"column {j}")


def _calls(mod, ref, spec):
    return [mod.WindowFuncCall(kind, None if arg is None else ref(arg),
                               off, alias, frame=frame)
            for kind, arg, off, alias, frame in spec]


def _executors(spec, part, order, pool, emit, **kw):
    jex = jow.OverWindowExecutor(
        JSCHEMA, [JRef(i) for i in part], [(JRef(i), d) for i, d in order],
        _calls(jow, JRef, spec), pool_size=pool, emit_capacity=emit, **kw)
    tex = tow.OverWindowExecutor(
        TSCHEMA, [InputRef(i) for i in part],
        [(InputRef(i), d) for i, d in order], _calls(tow, InputRef, spec),
        pool_size=pool, emit_capacity=emit, **kw)
    return jex, tex


# ---------------------------------------------------------------------------
# the reference's tests/test_over_window.py cases

RS = JSchema.of(("p", JDT.INT64), ("v", JDT.INT64))
TS2 = Schema((Field("p", DataType.INT64), Field("v", DataType.INT64)))

REFERENCE_CASES = {
    "row_number_and_running_sum": (
        [("row_number", None, 1, "rn", None), ("sum", 1, 1, "s", None),
         ("count", None, 1, "c", None)],
        [[(0, 1, 30), (0, 1, 10), (0, 2, 5), (0, 1, 20)], [(0, 1, 15)]]),
    "rank_dense_rank_with_ties": (
        [("rank", None, 1, "r", None), ("dense_rank", None, 1, "d", None)],
        [[(0, 1, 10), (0, 1, 10), (0, 1, 20), (0, 1, 30)]]),
    "lag_lead_partition_boundaries": (
        [("lag", 1, 1, "lg", None), ("lead", 1, 1, "ld", None)],
        [[(0, 1, 10), (0, 1, 20), (0, 2, 7)]]),
    "running_min_max": (
        [("min", 1, 1, "lo", None), ("max", 1, 1, "hi", None)],
        [[(0, 1, 20), (0, 1, 10), (0, 1, 30)]]),
    "retraction_rerank": (
        [("row_number", None, 1, "rn", None)],
        [[(0, 1, 10), (0, 1, 20), (0, 1, 30)], [(1, 1, 10)]]),
}


@pytest.mark.parametrize("case", sorted(REFERENCE_CASES))
def test_reference_over_window_cases(case):
    """Each case of the reference's over-window tests (pool 64, emit 32),
    flushed after every chunk: equal out chunks and states."""
    spec, steps = REFERENCE_CASES[case]
    jex = jow.OverWindowExecutor(RS, [JRef(0)], [(JRef(1), False)],
                                 _calls(jow, JRef, spec), pool_size=64,
                                 emit_capacity=32)
    tex = tow.OverWindowExecutor(TS2, [InputRef(0)], [(InputRef(1), False)],
                                 _calls(tow, InputRef, spec), pool_size=64,
                                 emit_capacity=32)
    jst = jex.init_state()
    tst = tex.init_state("cpu")
    assert state_mismatches(jax.device_get(jst), tst) == []
    emitted = 0
    for epoch, rows in enumerate(steps):
        arr = np.asarray(rows, np.int64)
        jc, tc = _chunks([arr[:, 1].copy(), arr[:, 2].copy()], arr[:, 0],
                         np.ones(len(rows), bool), RS, TS2)
        jst, _ = jex.apply(jst, jc)
        tst, out = tex.apply(tst, tc)
        assert out is None
        jst, jout = jex.flush(jst, epoch)
        tst, tout = tex.flush(tst, epoch)
        _assert_chunks(jout, tout)
        assert state_mismatches(jax.device_get(jst), tst) == []
        emitted += int(tout.valid.sum())
    assert emitted > 0
    assert [f.name for f in tex.out_schema] == \
        [f.name for f in jex.out_schema]


# ---------------------------------------------------------------------------
# every call kind, frames, ties, strings, retractions, overflow

ALL_CALLS = [
    ("row_number", None, 1, "rn", None), ("rank", None, 1, "rk", None),
    ("dense_rank", None, 1, "dr", None), ("lag", V, 1, "lg", None),
    ("lead", S_, 2, "ld", None), ("lag", S_, 3, "lgs", None),
    ("sum", V, 1, "sv", None), ("count", None, 1, "c", None),
    ("avg", V, 1, "av", None), ("min", F, 1, "mnf", None),
    ("max", V, 1, "mxv", None), ("min", G, 1, "mng", None),
    ("max", I, 1, "mxi", None), ("sum", F, 1, "s0", (0, 0)),
    ("sum", G, 1, "s1", (1, 0)), ("avg", I, 1, "a10", (10, 0)),
]
FRAME_CALLS = [
    ("count", None, 1, "c1", (1, 0)), ("sum", I, 1, "si", None),
    ("avg", F, 1, "af", (0, 0)), ("sum", V, 1, "s10", (10, 0)),
    ("lead", F, 1, "ldf", None), ("rank", None, 1, "rk", None),
    ("dense_rank", None, 1, "dr", None), ("row_number", None, 1, "rn", None),
]

CASES = {
    # (calls, partition, order, pool, emit, cap)
    "all_calls": (ALL_CALLS, [P], [(V, False)], 64, 24, 20),
    "two_keys_desc_string_partition": (FRAME_CALLS, [S_], [(I, True),
                                                           (T, False)],
                                       64, 48, 16),
    "no_partition": (FRAME_CALLS, [], [(T, False), (V, True)], 64, 64, 16),
    "no_order": (FRAME_CALLS, [P, I], [], 48, 32, 12),
    "emit_wider_than_pool": (ALL_CALLS, [P], [(V, True)], 32, 48, 12),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_flush_matches_reference(case):
    """Four retractable chunks, each followed by a flush: equal out
    chunks and every state tensor (the emitted rows, dead ones included,
    and the overflow gauge)."""
    spec, part, order, pool, emit, cap = CASES[case]
    rng = np.random.default_rng(len(case))
    jex, tex = _executors(spec, part, order, pool, emit)
    jst = jex.init_state()
    tst = state_from_numpy(jax.device_get(jst))
    held = _take(_rows(rng, 0), np.arange(0))
    emitted = 0
    for epoch in range(4):
        cols, ops, valid = _mixed_chunk(rng, held, cap)
        jc, tc = _chunks(cols, ops, valid)
        jst, _ = jex.apply(jst, jc)
        tst, _ = tex.apply(tst, tc)
        jst, jout = jex.flush(jst, epoch)
        tst, tout = tex.flush(tst, epoch)
        _assert_chunks(jout, tout)
        assert state_mismatches(jax.device_get(jst), tst) == []
        emitted += int(tout.valid.sum())
        live = [c.numpy() if not isinstance(c, StrCol)
                else (c.data.numpy(), c.lens.numpy()) for c in tst.rows]
        held = _take(live, np.flatnonzero(tst.valid.numpy()))
    assert emitted > 0 and int(tst.inconsistency) > 0
    if case == "all_calls":
        assert int(tst.overflow) > 0       # more live rows than emitted


def test_float_sums_of_inexact_arguments_within_tolerance():
    """sum/avg of non-dyadic float64 arguments: the ranks and every
    integer output exact, the float outputs within relative 1e-12."""
    rng = np.random.default_rng(12)
    spec = [("sum", F, 1, "sf", None), ("avg", F, 1, "af", (10, 0)),
            ("row_number", None, 1, "rn", None), ("min", F, 1, "mn", None)]
    jex, tex = _executors(spec, [P], [(T, False)], 64, 32)
    jst, tst = jex.init_state(), tex.init_state("cpu")
    cols = _rows(rng, 48, dyadic=False)
    jc, tc = _chunks(cols, np.zeros(48, np.int8), np.ones(48, bool))
    jst, _ = jex.apply(jst, jc)
    tst, _ = tex.apply(tst, tc)
    jorder, jvalid, _, jouts = jex._compute_outputs(jst)
    torder, tvalid, touts = tex._compute_outputs(tst)
    np.testing.assert_array_equal(np.asarray(jorder), torder.numpy())
    np.testing.assert_array_equal(np.asarray(jvalid), tvalid.numpy())
    for (kind, *_), a, b in zip(spec, jouts, touts):
        if kind in ("sum", "avg"):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12)
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


# ---------------------------------------------------------------------------
# watermark cleaning (K19a's plain version)


def test_clean_below_on_both_executors():
    """A watermark drops the pool rows and the emitted rows whose column
    is below its value minus the lag: the group top-N (with its source
    column filter) and the over-window, equal to the reference."""
    rng = np.random.default_rng(19)
    jtop = jtop_n.GroupTopNExecutor(
        JSCHEMA, [JRef(P)], [(JRef(V), True)], limit=3, pool_size=64,
        emit_capacity=32, watermark_col_idx=T, watermark_lag=2,
        watermark_src_col=1)
    ttop = ttop_n.GroupTopNExecutor(
        TSCHEMA, [InputRef(P)], [(InputRef(V), True)], limit=3,
        pool_size=64, emit_capacity=32, watermark_col_idx=T,
        watermark_lag=2, watermark_src_col=1)
    jow_ex, tow_ex = _executors(ALL_CALLS[:6], [P], [(V, False)], 64, 32,
                                watermark_col_idx=T, watermark_lag=3)
    for jex, tex in ((jtop, ttop), (jow_ex, tow_ex)):
        jst, tst = jex.init_state(), tex.init_state("cpu")
        cols = _rows(rng, 40)
        jc, tc = _chunks(cols, np.zeros(40, np.int8), np.ones(40, bool))
        jst, _ = jex.apply(jst, jc)
        tst, _ = tex.apply(tst, tc)
        jst, _ = jex.flush(jst, 0)
        tst, _ = tex.flush(tst, 0)
        before = int(tst.valid.sum()), int(tst.prev_valid.sum())
        for col, value in ((0, 40), (1, 12), (1, 20)):
            jst = jex.on_watermark(jst, JWatermark(col, jnp.int64(value)))
            tst = tex.on_watermark(tst, Watermark(col, torch.tensor(value)))
            assert state_mismatches(jax.device_get(jst), tst) == []
        after = int(tst.valid.sum()), int(tst.prev_valid.sum())
        assert after[0] < before[0] and after[1] < before[1]
        jst, jout = jex.flush(jst, 1)
        tst, tout = tex.flush(tst, 1)
        _assert_chunks(jout, tout)
        assert state_mismatches(jax.device_get(jst), tst) == []
    # the cleaning itself: the plain K19a on a bare pool
    col = torch.tensor([5, 1, 9, 3], dtype=torch.int64)
    valid = torch.tensor([True, True, False, True])
    prev = torch.tensor([2, 8], dtype=torch.int64)
    pvalid = torch.tensor([True, True])
    ttop_n.clean_below(col, valid, prev, pvalid, torch.tensor(4))
    assert valid.tolist() == [True, False, False, False]
    assert pvalid.tolist() == [False, True]
