"""Port parity: DISTINCT aggregates (the dedup the reference runs in
``HashAggExecutor.apply``, kernel K6d's plain version) and the K4 sweep's
plain versions.

The same seeded chunks go through the reference's and the port's
``HashAggExecutor`` (plain versions on the CPU) grouped by an int64 and a
VARCHAR key, with ``COUNT(*)``, ``SUM(v)``, ``COUNT(DISTINCT v)`` and
``SUM(DISTINCT v) FILTER (WHERE f)`` over a nullable ``v``: inserts, then
retractions that drive (group, value) counts back to 0 (their dedup keys
become tombstones), on both of the reference's branches (per row, and
pre-aggregated by sorted runs, with and without the spill ring that
keeps diverted rows out of the dedup).  After every chunk and flush every
state tensor, the dedup tables and counts included, must be equal; then
``maybe_rehash`` (its ``rehash_d`` rebuilds the tombstoned dedup table)
and ``clean_below`` (the dedup keys leave with their group).  A dedup
table of 8 slots overflows and counts the lost rows as the reference
does.  The K4 sweep's plain versions (``clear_where``, ``clear_slots`` of
``HashTable`` and ``TagTable``) are held against the reference's on
random tables.  Tolerance: none — every value here is integer.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import jax
import jax.numpy as jnp
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
from risingwave_tpu.state import hash_table as jht
from risingwave_tpu.stream import hash_agg as jhash_agg
from risingwave_tpu_torch.common.chunk import Chunk
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.compat import state_from_numpy, state_mismatches
from risingwave_tpu_torch.expr.agg import AggCall
from risingwave_tpu_torch.expr.node import InputRef
from risingwave_tpu_torch.stream import hash_agg as thash_agg

COLS = [("k", "INT64", False), ("s", "VARCHAR", False), ("v", "INT64", True),
        ("f", "BOOLEAN", False)]
JS = JSchema(tuple(JField(n, getattr(JDT, t), nullable=nl,
                          **({"str_width": 8} if t == "VARCHAR" else {}))
                   for n, t, nl in COLS))
TS = Schema(tuple(Field(n, getattr(DataType, t), nullable=nl,
                        **({"str_width": 8} if t == "VARCHAR" else {}))
                  for n, t, nl in COLS))
CAP = 32


def _aggs(table=32, dtable=64, ring=0):
    kw = dict(table_size=table, emit_capacity=64, distinct_table_size=dtable,
              spill_ring=ring, retractable_input=True)

    def calls(Agg, Ref):
        return [Agg("count_star", None), Agg("sum", Ref(2)),
                Agg("count", Ref(2), distinct=True),
                Agg("sum", Ref(2), distinct=True, filter=Ref(3))]

    j = jhash_agg.HashAggExecutor(
        JS, [("k", JRef(0)), ("s", JRef(1))], calls(JAggCall, JRef), **kw)
    t = thash_agg.HashAggExecutor(
        TS, [("k", InputRef(0)), ("s", InputRef(1))],
        calls(AggCall, InputRef), **kw)
    return j, t


def _chunk(rows, ops):
    """Both packages' chunks of ``rows`` (k, v, f) with ``ops``."""
    k = np.array([r[0] for r in rows], np.int64)
    arrays = [k, np.array([f"s{x % 3}" for x in k], object),
              np.array([r[1] for r in rows], object),
              np.array([r[2] for r in rows], bool)]
    ops = np.array(ops, np.int8)
    return (JChunk.from_numpy(JS, arrays, ops=ops, capacity=CAP),
            Chunk.from_numpy(TS, arrays, ops=ops, capacity=CAP))


def _script(rng, n_chunks, keys, values):
    """Seeded chunks: mostly inserts, then retractions of live rows (so
    (group, value) counts fall back to 0)."""
    live: list = []
    out = []
    for c in range(n_chunks):
        rows, ops = [], []
        n_del = 0 if c < 2 else min(len(live), int(rng.integers(8, 20)))
        for _ in range(n_del):
            rows.append(live.pop(int(rng.integers(0, len(live)))))
            ops.append(1)
        for _ in range(int(rng.integers(8, CAP - n_del + 1))):
            v = int(rng.integers(0, values))
            r = (int(rng.integers(0, keys)), None if v == 0 else v,
                 bool(rng.integers(0, 2)))
            rows.append(r)
            ops.append(0)
            live.append(r)
        out.append(_chunk(rows, ops))
    return out


def _same(jst, tst):
    assert state_mismatches(jax.device_get(jst), tst) == []


def _same_out(jout, tout):
    np.testing.assert_array_equal(np.asarray(jout.valid), tout.valid.numpy())
    np.testing.assert_array_equal(np.asarray(jout.ops), tout.ops.numpy())
    for jc, tc in zip(jout.columns, tout.columns):
        jl = jax.tree_util.tree_leaves(jc)
        tl = list(tc) if isinstance(tc, tuple) else [tc]
        for a, b in zip(jl, tl):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("branch", ["per_row", "preagg", "preagg_ring"])
def test_distinct_matches_reference(branch, monkeypatch):
    preagg = branch != "per_row"
    monkeypatch.setattr(jhash_agg, "accel_tuned", lambda: preagg)
    monkeypatch.setattr(thash_agg, "accel_tuned", lambda device: preagg)
    ring = branch == "preagg_ring"
    # the ring case's 8-slot group table diverts rows into a 64-row ring
    j, t = _aggs(table=8 if ring else 32, ring=64 if ring else 0)
    jst, tst = j.init_state(), t.init_state("cpu")
    apply = jax.jit(j.apply)
    flush = jax.jit(j.flush)
    rng = np.random.default_rng(11)
    tombs = 0
    for jc, tc in _script(rng, 6, keys=12, values=5):
        jst, _ = apply(jst, jc)
        tst, _ = t.apply(tst, tc)
        _same(jst, tst)
        tombs = max(tombs, int(tst.distinct_tables[0].tombstone_count()))
        jst, jout = flush(jst, 1)
        tst, tout = t.flush(tst, 1)
        _same(jst, tst)
        _same_out(jout, tout)
    # retractions to 0 left tombstones in the dedup tables
    assert tombs > 0
    assert int(tst.distinct_counts[0].min()) >= 0
    if ring:
        assert int(tst.spill_count) > 0
        return
    assert int(tst.overflow) == 0 and int(tst.inconsistency) == 0
    # enough tombstones for rehash_d: more retractions of whole groups
    jc, tc = _chunk([(k, v, True) for k in range(12) for v in (1,)]
                    + [(k, 2, False) for k in range(12)], [0] * 24)
    jst, _ = apply(jst, jc)
    tst, _ = t.apply(tst, tc)
    jc, tc = _chunk([(k, v, f) for k in range(12)
                     for v, f in ((1, True), (2, False))], [1] * 24)
    jst, _ = apply(jst, jc)
    tst, _ = t.apply(tst, tc)
    _same(jst, tst)
    assert int(tst.distinct_tables[0].tombstone_count()) > 64 // 4
    jst = j.maybe_rehash(jst)
    tst = t.maybe_rehash(tst)
    _same(jst, tst)
    assert int(tst.distinct_tables[0].tombstone_count()) == 0
    jst = j.clean_below(jst, 0, 6)
    tst = t.clean_below(tst, 0, 6)
    _same(jst, tst)
    assert int(tst.distinct_tables[0].occupied.sum()) > 0


def test_distinct_overflow_and_spill_tier_size():
    """An 8-slot dedup table overflows: the lost rows count into the
    agg's overflow as the reference counts them; a spill tier's dedup
    table is at least the tier's size."""
    j, t = _aggs(dtable=8)
    jst, tst = j.init_state(), t.init_state("cpu")
    rng = np.random.default_rng(3)
    for jc, tc in _script(rng, 3, keys=12, values=5):
        jst, _ = j.apply(jst, jc)
        tst, _ = t.apply(tst, tc)
        _same(jst, tst)
    assert int(tst.overflow) > 0
    tier = t.make_spill_tier(64)
    assert tier.distinct_table_size == 64
    assert tier._distinct_aggs == [2, 3]


@pytest.mark.parametrize("table", ["hash", "tag"])
def test_table_sweep_plain_matches_reference(table):
    """The K4 sweep's plain versions: by predicate over the table and by
    slot list (sentinel slots dropped, duplicates allowed), on random
    occupancy and tombstones."""
    rng = np.random.default_rng(5)
    size, n = 64, 40
    pred = rng.integers(0, 2, size).astype(bool)
    slots = rng.integers(0, size + 1, n).astype(np.int32)  # size: sentinel
    mask = rng.integers(0, 2, n).astype(bool)
    if table == "hash":
        occ = rng.integers(0, 2, size).astype(bool)
        tomb = ~occ & rng.integers(0, 2, size).astype(bool)
        keys = (rng.integers(0, 99, size).astype(np.int64),)
        make = lambda: jht.HashTable(  # noqa: E731
            tuple(jnp.asarray(k) for k in keys), jnp.asarray(occ),
            jnp.asarray(tomb), size)
    else:
        tags = rng.integers(2, 1 << 62, size).astype(np.uint64)
        tags[rng.integers(0, 2, size).astype(bool)] = 0
        tags[rng.integers(0, 4, size) == 0] = 1
        make = lambda: jht.TagTable(jnp.asarray(tags), size)  # noqa: E731
    for op in ("where", "slots"):
        ref = make()
        port = state_from_numpy(jax.device_get(ref))
        if op == "where":
            ref = ref.clear_where(jnp.asarray(pred))
            port.clear_where(state_from_numpy(pred))
        else:
            ref = ref.clear_slots(jnp.asarray(slots), jnp.asarray(mask))
            port.clear_slots(state_from_numpy(slots), state_from_numpy(mask))
        assert state_mismatches(jax.device_get(ref), port) == []
