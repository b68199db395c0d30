"""Port parity: min/max over a retractable input (the materialized-input
state of the reference's ``HashAggExecutor``, kernel K6m's plain
version) and through SQL.

The same seeded chunks go through the reference's and the port's
``HashAggExecutor(retractable_input=True)`` (plain versions on the CPU),
on both of the reference's branches (per row, and pre-aggregated by
sorted runs), with ``count(*)``, ``sum(v)``, ``min(v)``, ``max(v) FILTER
(WHERE f)`` over a nullable BIGINT and ``min``/``max`` over a DOUBLE, in
buckets of 8 values: inserts, deletes and updates of live rows, +v/-v
pairs inside one chunk, deletes of absent values (misses), a group past
its bucket (overflow), NULL values and filtered rows, ``clean_below``,
groups claimed again on reclaimed slots, and ``maybe_rehash`` with live
buckets.  After every chunk and flush round every state leaf
(``minput_vals`` and ``minput_occ`` included) and every flush chunk must
be equal.  Tolerance: none (the float values are exact binary fractions
and are only compared and moved).

Through both engines on the CPU (chunk 256): ``q5_max`` (Nexmark q5's
HOP windows with q7's ``max(price)``, whose pane plan's global phase
runs the minput state), a ``retract = 'true'`` table's min/max after a
DELETE and an UPDATE, min/max over a LEFT JOIN grouped by the auction id,
a bucket overflow raising the runtime's words, and a cold start of a
durable ``q5_max`` equal to an uninterrupted run, with the minput leaves
in the store's payloads under the reference's member keys and shapes.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import json
import os

import jax
import numpy as np
import pytest

import risingwave_tpu  # noqa: F401
from risingwave_tpu.common.chunk import Chunk as JChunk
from risingwave_tpu.common.types import (
    DataType as JDT,
    Field as JField,
    Schema as JSchema,
)
from risingwave_tpu.expr.agg import AggCall as JAggCall
from risingwave_tpu.expr.node import InputRef as JRef
from risingwave_tpu.stream import hash_agg as jhash_agg
from risingwave_tpu_torch.common.chunk import Chunk
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.compat import state_mismatches
from risingwave_tpu_torch.expr.agg import AggCall
from risingwave_tpu_torch.expr.node import InputRef
from risingwave_tpu_torch.stream import hash_agg as thash_agg

COLS = [("k", "INT64", False), ("v", "INT64", True), ("f", "BOOLEAN", False),
        ("w", "FLOAT64", False)]
JS = JSchema(tuple(JField(n, getattr(JDT, t), nullable=nl)
                   for n, t, nl in COLS))
TS = Schema(tuple(Field(n, getattr(DataType, t), nullable=nl)
                  for n, t, nl in COLS))
CAP = 32
B = 8
W_VALUES = (1.5, -2.25, 0.0, 3.75, 1e6, -0.5)


def _aggs(table=32, emit=8):
    kw = dict(table_size=table, emit_capacity=emit, retractable_input=True,
              minput_bucket_cap=B)

    def calls(Agg, Ref):
        return [Agg("count_star", None), Agg("sum", Ref(1)),
                Agg("min", Ref(1)), Agg("max", Ref(1), filter=Ref(2)),
                Agg("min", Ref(3)), Agg("max", Ref(3))]

    j = jhash_agg.HashAggExecutor(JS, [("k", JRef(0))],
                                  calls(JAggCall, JRef), **kw)
    t = thash_agg.HashAggExecutor(TS, [("k", InputRef(0))],
                                  calls(AggCall, InputRef), **kw)
    return j, t


def _chunk(rows, ops):
    """Both packages' chunks of ``rows`` (k, v, f, w) with ``ops``."""
    arrays = [np.array([r[0] for r in rows], np.int64),
              np.array([r[1] for r in rows], object),
              np.array([r[2] for r in rows], bool),
              np.array([r[3] for r in rows], np.float64)]
    ops = np.array(ops, np.int8)
    return (JChunk.from_numpy(JS, arrays, ops=ops, capacity=CAP),
            Chunk.from_numpy(TS, arrays, ops=ops, capacity=CAP))


def _row(rng, keys):
    v = int(rng.integers(0, 6))
    return (int(rng.integers(0, keys)), None if v == 0 else v,
            bool(rng.integers(0, 2)), W_VALUES[int(rng.integers(0, 6))])


def _script(rng, keys):
    """Seeded chunks: inserts; deletes and updates of live rows; +v/-v
    pairs inside a chunk (either order); deletes of absent values; a
    group filled past its bucket."""
    live: list = []
    out = []
    for c in range(7):
        rows, ops = [], []
        if c >= 2:
            for _ in range(min(len(live), int(rng.integers(4, 9)))):
                rows.append(live.pop(int(rng.integers(0, len(live)))))
                ops.append(1)
            for _ in range(min(len(live), 3)):
                old = live.pop(int(rng.integers(0, len(live))))
                new = (old[0],) + _row(rng, keys)[1:]
                rows += [old, new]
                ops += [2, 3]
                live.append(new)
        if c in (3, 5):
            # +v/-v pairs in one chunk, insert first and delete first
            r = _row(rng, keys)
            rows += [r, r]
            ops += [0, 1]
            r = _row(rng, keys)
            rows += [r, r]
            ops += [1, 0]
        if c == 4:
            # deletes of values never inserted: misses
            rows += [(1, 99, True, 7.0), (2, 98, False, -7.0)]
            ops += [1, 1]
        if c == 6:
            # group 0 past its bucket of B values
            for _ in range(B + 2):
                r = (0, int(rng.integers(1, 6)), True, W_VALUES[1])
                rows.append(r)
                ops.append(0)
        while len(rows) < CAP - 2 and rng.integers(0, 4):
            r = _row(rng, keys)
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
        assert len(jl) == len(tl)
        for a, b in zip(jl, tl):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _drain(j, t, jst, tst, flush):
    """Flush rounds until neither side has pending groups."""
    rounds = 0
    while True:
        pend = int(j.pending_flush(jst))
        assert pend == int(t.pending_flush(tst))
        if pend == 0:
            return jst, tst, rounds
        jst, jout = flush(jst, 1)
        tst, tout = t.flush(tst, 1)
        _same(jst, tst)
        _same_out(jout, tout)
        rounds += 1


@pytest.mark.parametrize("branch", ["per_row", "preagg"])
def test_minput_matches_reference(branch, monkeypatch):
    preagg = branch == "preagg"
    monkeypatch.setattr(jhash_agg, "accel_tuned", lambda: preagg)
    monkeypatch.setattr(thash_agg, "accel_tuned", lambda device: preagg)
    j, t = _aggs()
    assert t._minput_aggs == [2, 3, 4, 5]
    jst, tst = j.init_state(), t.init_state("cpu")
    assert tst.minput_vals[0].shape == (32, B)
    assert tst.minput_vals[2].dtype == tst.minput_vals[2].new_zeros(
        ()).double().dtype
    apply = jax.jit(j.apply)
    flush = jax.jit(j.flush)
    rng = np.random.default_rng(17)
    drains = 0
    for jc, tc in _script(rng, keys=14):
        jst, _ = apply(jst, jc)
        tst, _ = t.apply(tst, tc)
        _same(jst, tst)
        jst, tst, rounds = _drain(j, t, jst, tst, flush)
        drains = max(drains, rounds)
    assert drains > 1                     # more dirty groups than E
    assert int(tst.inconsistency) >= 2    # the misses
    assert int(tst.overflow) > 0          # group 0 past its bucket
    # clean the groups below 7, then claim some of them again: their
    # reclaimed slots must start with empty buckets
    jst = j.clean_below(jst, 0, 7)
    tst = t.clean_below(tst, 0, 7)
    _same(jst, tst)
    jc, tc = _chunk([(k, 3, True, 1.5) for k in range(5)]
                    + [(k, 4, False, -0.5) for k in range(3, 8)], [0] * 10)
    jst, _ = apply(jst, jc)
    tst, _ = t.apply(tst, tc)
    _same(jst, tst)
    jst, tst, _ = _drain(j, t, jst, tst, flush)
    # enough tombstones for a rehash: the buckets move with their groups
    jst = j.clean_below(jst, 0, 12)
    tst = t.clean_below(tst, 0, 12)
    assert int(tst.table.tombstone_count()) > 32 // 4
    live = int(tst.minput_occ[0].sum())
    jst = j.maybe_rehash(jst)
    tst = t.maybe_rehash(tst)
    _same(jst, tst)
    assert int(tst.table.tombstone_count()) == 0
    assert int(tst.minput_occ[0].sum()) == live > 0
    jc, tc = _chunk([(13, 5, True, 3.75), (13, 5, True, 3.75),
                     (12, 2, True, 0.0)], [1, 0, 0])
    jst, _ = apply(jst, jc)
    tst, _ = t.apply(tst, tc)
    _same(jst, tst)
    _drain(j, t, jst, tst, flush)


def test_minput_plain_versions_are_the_reference_order():
    """K6m's plain update and refresh on a hand-made bucket: clears read
    the bucket after the reclaimed slots' reset, inserts claim the free
    entries left after the clears, in row order."""
    import torch

    vals = torch.zeros((4, 4), dtype=torch.int64)
    occ = torch.zeros((4, 4), dtype=torch.bool)
    vals[1] = torch.tensor([5, 7, 5, 9])
    occ[1] = torch.tensor([True, True, True, False])
    vals[2] = torch.tensor([1, 2, 3, 4])
    occ[2] = True
    over = torch.zeros((), dtype=torch.int64)
    bad = torch.zeros((), dtype=torch.int64)
    slots = torch.tensor([1, 1, 1, 2, 2, 3], dtype=torch.int32)
    v = torch.tensor([5, 5, 8, 2, 6, 1])
    signs = torch.tensor([-1, -1, 1, -1, 1, 1])
    active = torch.ones(6, dtype=torch.bool)
    # slot 2 is reclaimed this chunk: its delete of 2 misses
    ins_pos = torch.tensor([4, 4, 4, 2, 4, 4], dtype=torch.int32)
    thash_agg.minput_update_plain(vals, occ, slots, v, signs, active,
                                  ins_pos, over, bad)
    assert occ[1].tolist() == [True, True, False, False]
    assert vals[1].tolist() == [8, 7, 5, 9]
    assert occ[2].tolist() == [True, False, False, False]
    assert vals[2].tolist() == [6, 2, 3, 4]
    assert int(bad) == 1 and int(over) == 0
    prim = torch.zeros(4, dtype=torch.int64)
    thash_agg.minput_refresh_plain(prim, vals, occ,
                                   torch.tensor([1, 2, 0, 4]), "max")
    assert prim.tolist() == [torch.iinfo(torch.int64).min, 8, 6, 0]


# ---------------------------------------------------------------------------
# through SQL

BID_SOURCE = """
CREATE SOURCE bid (
    auction BIGINT, bidder BIGINT, price BIGINT,
    channel VARCHAR, url VARCHAR, date_time TIMESTAMP,
    WATERMARK FOR date_time AS date_time - INTERVAL '4' SECOND
) WITH (connector = 'nexmark', nexmark.table = 'bid',
        nexmark.event.rate = '{rate}');
"""
AUCTION_SOURCE = """
CREATE SOURCE auction (
    id BIGINT, seller BIGINT, reserve BIGINT, expires TIMESTAMP,
    date_time TIMESTAMP,
    WATERMARK FOR date_time AS date_time - INTERVAL '4' SECOND
) WITH (connector = 'nexmark', nexmark.table = 'auction',
        nexmark.event.rate = '{rate}');
"""
Q5_MAX = """
CREATE MATERIALIZED VIEW bench_mv AS
SELECT auction, window_start, max(price) AS max_price, count(*) AS bids
FROM HOP(bid, date_time, INTERVAL '2' SECOND, INTERVAL '10' SECOND)
GROUP BY auction, window_start;
"""
SMALL = dict(chunk_capacity=256, agg_table_size=1 << 10,
             agg_emit_capacity=64, mv_table_size=1 << 12,
             mv_ring_size=1 << 14)


def _engines(ddl, cfg=SMALL, data_dir=None):
    from risingwave_tpu.sql import Engine as JEngine
    from risingwave_tpu.sql.planner import PlannerConfig as JConfig
    from risingwave_tpu_torch.sql import Engine
    from risingwave_tpu_torch.sql.planner import PlannerConfig

    engines = (JEngine(JConfig(**cfg)),
               Engine(PlannerConfig(**cfg), device="cpu", data_dir=data_dir))
    for e in engines:
        for stmt in ddl:
            e.execute(stmt)
    return engines


def _rows(eng, sql="SELECT * FROM bench_mv"):
    return sorted(tuple(v if isinstance(v, (str, type(None))) else
                        float(v) if isinstance(v, float) else int(v)
                        for v in r) for r in eng.execute(sql))


@pytest.fixture(scope="module")
def retract_engines():
    """Both engines over a ``retract = 'true'`` table's min/max in
    buckets of 2 values, after an INSERT, a DELETE and an UPDATE (each
    group then holds at most 2 values), with the MV's rows read then."""
    ddl = ["CREATE TABLE t (id BIGINT, g BIGINT, v BIGINT, "
           "PRIMARY KEY (id)) WITH (retract = 'true');",
           "CREATE MATERIALIZED VIEW m AS SELECT g, min(v) AS lo, "
           "max(v) AS hi FROM t GROUP BY g;"]
    engines = _engines(ddl, dict(SMALL, minput_bucket_cap=2))
    for e in engines:
        e.execute("INSERT INTO t VALUES (1, 1, 10), (2, 1, 20), (3, 2, 7), "
                  "(4, 2, 30)")
        e.tick(barriers=2, chunks_per_barrier=1)
        e.execute("DELETE FROM t VALUES (2, 1, 20)")
        e.execute("UPDATE t SET v = 7 WHERE id = 4")
        e.tick(barriers=2, chunks_per_barrier=1)
    return engines, [_rows(e, "SELECT * FROM m") for e in engines]


def test_retract_table_min_max_after_delete_and_update(retract_engines):
    _, got = retract_engines
    assert got[0] == got[1] == [(1, 10, 10), (2, 7, 7)]


def test_min_max_over_left_join():
    """min/max over a LEFT JOIN's output (retractable: NULL pads are
    retracted when the first bid arrives) grouped by the auction id."""
    ddl = [AUCTION_SOURCE.format(rate="10000"),
           BID_SOURCE.format(rate="10000"),
           "CREATE MATERIALIZED VIEW m AS SELECT a.id, min(b.price) AS lo, "
           "max(b.price) AS hi, count(*) AS n FROM auction a LEFT JOIN bid b "
           "ON a.id = b.auction GROUP BY a.id;"]
    # a hot auction collects hundreds of bids: buckets of 1024 values
    cfg = dict(SMALL, join_table_size=1 << 10, join_pool_size=1 << 14,
               join_out_capacity=1 << 12, minput_bucket_cap=1 << 10)
    engines = _engines(ddl, cfg)
    for e in engines:
        e.tick(barriers=3, chunks_per_barrier=1)
    got = [_rows(e, "SELECT * FROM m") for e in engines]
    assert got[0] == got[1] and len(got[0]) > 10
    assert any(r[1] is None for r in got[0])


def test_bucket_overflow_raises_the_runtime_words(retract_engines):
    """A group past its bucket: both runtimes raise at maintenance with
    the same words."""
    for e in retract_engines[0]:
        e.execute("INSERT INTO t VALUES (5, 1, 1), (6, 1, 2)")
        with pytest.raises(RuntimeError, match="state overflow"):
            e.tick(barriers=2, chunks_per_barrier=1)


def _store_files(d):
    """The job's manifest (epoch kinds in order, the committed epoch's
    position) and each retained epoch's payload arrays as raw bytes."""
    with open(os.path.join(d, "MANIFEST.json")) as f:
        m = json.load(f)["jobs"]["bench_mv"]
    epochs = sorted(int(e) for e in m["epochs"])
    man = {"kinds": [m["kind"][str(e)] for e in epochs],
           "committed": epochs.index(int(m["committed"]))}
    payloads = []
    for e in epochs:
        with np.load(os.path.join(d, "bench_mv", f"epoch_{e}.npz")) as z:
            payloads.append({k: (z[k].shape, z[k].tobytes())
                             for k in z.files})
    return man, payloads


def test_q5_max_store_and_cold_start(tmp_path):
    """q5_max (its pane plan's global phase runs the minput state) durable
    on both engines (a snapshot every 2 checkpoints): equal rows and
    state after every barrier, equal manifests and payload
    arrays (the minput leaves under the reference's member keys and
    shapes), and a cold start of the port from its directory that goes on
    equal to the reference, which never stopped."""
    from risingwave_tpu.sql import Engine as JEngine
    from risingwave_tpu.sql.planner import PlannerConfig as JConfig
    from risingwave_tpu_torch.compat import leaf_paths
    from risingwave_tpu_torch.sql import Engine
    from risingwave_tpu_torch.sql.planner import PlannerConfig

    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    ddl = [BID_SOURCE.format(rate="10000"), Q5_MAX,
           "ALTER SYSTEM SET snapshot_interval_checkpoints = 2"]
    jeng = JEngine(JConfig(**SMALL), data_dir=jdir)
    teng = Engine(PlannerConfig(**SMALL), data_dir=tdir, device="cpu")
    for e in (jeng, teng):
        for stmt in ddl:
            e.execute(stmt)

    def same(a, b):
        assert _rows(b) == _rows(a)
        assert state_mismatches(jax.device_get(a.jobs[0].states),
                                b.jobs[0].states) == []

    for _ in range(4):
        for e in (jeng, teng):
            e.tick(barriers=1, chunks_per_barrier=4)
        same(jeng, teng)
    assert len(_rows(teng)) > 100
    # the pane plan's global agg keeps max(price) in buckets of
    # max(64, 2k) = 64 values; its state does not round-trip through rows
    ex = teng.jobs[0].fragment.executors
    aggs = [i for i, x in enumerate(ex)
            if isinstance(x, thash_agg.HashAggExecutor)]
    assert [ex[i]._minput_aggs for i in aggs] == [[], [0]]
    assert ex[aggs[-1]].minput_bucket_cap == 64
    jex = jeng.jobs[0].fragment.executors
    assert [jex[i].reconstructible_from_rows() for i in aggs] == \
        [ex[i].reconstructible_from_rows() for i in aggs] == [False, False]
    man, payloads = _store_files(tdir)
    assert (man, payloads) == _store_files(jdir)
    # the payload's members are the flattened leaves (``leaf_<i>``): the
    # final agg's two minput leaves, [size, B], where the reference has them
    paths = [p for p, _ in leaf_paths(teng.jobs[0].states)]
    keys = [f"leaf_{i}" for i, p in enumerate(paths) if "minput" in p]
    assert [payloads[-1][k][0] for k in keys] == [(1 << 10, 64)] * 2
    rows = _rows(teng)
    del teng
    # the 4th barrier committed a snapshot: the cold start resumes there
    cold = Engine(PlannerConfig(**SMALL), data_dir=tdir, device="cpu")
    assert _rows(cold) == rows
    for e in (jeng, cold):
        e.tick(barriers=2, chunks_per_barrier=4)
    same(jeng, cold)


@pytest.mark.parametrize("case", ["global_half", "minput", "string_min",
                                  "count"])
def test_reconstructible_from_rows_matches_reference(case):
    """Only the global half of a two-phase pair (plain keys, one
    sum/sum0/min/max per trailing column, no materialized input, no
    packed string) round-trips through its own input rows."""
    kind, schema_s, retract = {
        "global_half": ("sum", False, False),
        "minput": ("min", False, True),
        "string_min": ("min_str", True, False),
        "count": ("count", False, False)}[case]
    out = []
    for DT, F, S, Agg, Ref, mod in (
            (JDT, JField, JSchema, JAggCall, JRef, jhash_agg),
            (DataType, Field, Schema, AggCall, InputRef, thash_agg)):
        v = F("v", DT.VARCHAR, str_width=8) if schema_s \
            else F("v", DT.INT64)
        ex = mod.HashAggExecutor(S((F("k", DT.INT64), v)), [("k", Ref(0))],
                                 [Agg(kind, Ref(1))], table_size=16,
                                 retractable_input=retract)
        out.append(ex.reconstructible_from_rows())
    assert out[0] == out[1] == (case == "global_half")
