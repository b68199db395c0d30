"""Port parity: EMIT ON WINDOW CLOSE (the EOWC flush of the reference's
``HashAggExecutor``, kernel K7e's plain version), the ``EowcSortExecutor``
and EOWC through SQL.

The same seeded chunks go through the reference's and the port's
``HashAggExecutor(emit_on_window_close=True)`` grouped by (k, a nullable
window start), with ``count(*)`` and ``max(v)``, emit capacity 4: before
any watermark nothing is pending and a flush emits nothing; after each
watermark more groups are closed than one flush emits, and the flush
rounds drain them, every state leaf and flush chunk equal to the
reference's; a NULL window never closes; each closed group is emitted
exactly once, and the emitted groups leave the table.  The
``EowcSortExecutor`` runs the reference's ``tests/test_watermark.py``
scripts (chunks built directly) and a seeded out-of-order stream into a
small pool (its overflow included) on both packages.  Through both
engines on the CPU: ``q7_eowc`` (a closing 1 s TUMBLE keyed by auction,
chunk 256), ``tests/test_sql.py``'s EOWC text also held against numpy,
a durable EOWC MV's cold start replaying ``EMIT ON WINDOW CLOSE`` from
the DDL log, and the reference's EOWC ``PlanError``s word for word.
Tolerance: none — every value here is integer.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
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
from risingwave_tpu.stream import watermark as jwatermark
from risingwave_tpu.stream.message import Watermark as JWatermark
from risingwave_tpu_torch.common.chunk import Chunk
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.compat import state_mismatches
from risingwave_tpu_torch.expr.agg import AggCall
from risingwave_tpu_torch.expr.node import InputRef
from risingwave_tpu_torch.stream import hash_agg as thash_agg
from risingwave_tpu_torch.stream import watermark as twatermark
from risingwave_tpu_torch.stream.message import Watermark

COLS = [("k", "INT64", False), ("ws", "TIMESTAMP", True), ("v", "INT64", False)]
JS = JSchema(tuple(JField(n, getattr(JDT, t), nullable=nl)
                   for n, t, nl in COLS))
TS = Schema(tuple(Field(n, getattr(DataType, t), nullable=nl)
                  for n, t, nl in COLS))
CAP = 32
WIN = 100


def _chunk(rows, js=JS, ts=TS, cap=CAP):
    arrays = [np.array([r[i] for r in rows],
                       object if any(r[i] is None for r in rows)
                       else np.int64) for i in range(len(rows[0]))]
    ops = np.zeros(len(rows), np.int8)
    return (JChunk.from_numpy(js, arrays, ops=ops, capacity=cap),
            Chunk.from_numpy(ts, arrays, ops=ops, capacity=cap))


def _same(jst, tst):
    assert state_mismatches(jax.device_get(jst), tst) == []


def _out_rows(out):
    """Valid rows of a port chunk as tuples (NULL as None)."""
    valid = out.valid.numpy()
    cols = []
    for c in out.columns:
        data = c[0] if isinstance(c, tuple) else c
        null = c[1].numpy() if isinstance(c, tuple) else None
        d = data.numpy()
        cols.append([None if null is not None and null[i] else int(d[i])
                     for i in range(d.shape[0])])
    return [tuple(col[i] for col in cols) for i in range(valid.shape[0])
            if valid[i]]


def _same_out(jout, tout):
    np.testing.assert_array_equal(np.asarray(jout.valid), tout.valid.numpy())
    np.testing.assert_array_equal(np.asarray(jout.ops), tout.ops.numpy())
    for jc, tc in zip(jout.columns, tout.columns):
        jl = jax.tree_util.tree_leaves(jc)
        tl = list(tc) if isinstance(tc, tuple) else [tc]
        for a, b in zip(jl, tl):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _eowc_aggs(emit=4):
    kw = dict(table_size=64, emit_capacity=emit, watermark_group_idx=1,
              watermark_lag=WIN, emit_on_window_close=True)

    def calls(Agg, Ref):
        return [Agg("count_star", None), Agg("max", Ref(2))]

    j = jhash_agg.HashAggExecutor(
        JS, [("k", JRef(0)), ("ws", JRef(1))], calls(JAggCall, JRef), **kw)
    t = thash_agg.HashAggExecutor(
        TS, [("k", InputRef(0)), ("ws", InputRef(1))],
        calls(AggCall, InputRef), **kw)
    return j, t


@pytest.mark.parametrize("branch", ["per_row", "preagg"])
def test_eowc_flush_matches_reference(branch, monkeypatch):
    preagg = branch == "preagg"
    monkeypatch.setattr(jhash_agg, "accel_tuned", lambda: preagg)
    monkeypatch.setattr(thash_agg, "accel_tuned", lambda device: preagg)
    j, t = _eowc_aggs()
    jst, tst = j.init_state(), t.init_state("cpu")
    apply, flush = jax.jit(j.apply), jax.jit(j.flush)
    rng = np.random.default_rng(29)
    emitted: list = []
    for c in range(4):
        rows = [(int(rng.integers(0, 6)),
                 None if rng.integers(0, 9) == 0
                 else WIN * int(rng.integers(c, c + 3)),
                 int(rng.integers(0, 1000))) for _ in range(CAP - 4)]
        jc, tc = _chunk(rows)
        jst, _ = apply(jst, jc)
        tst, _ = t.apply(tst, tc)
        _same(jst, tst)
        if c == 0:
            # no watermark yet: nothing is closed
            assert int(t.pending_flush(tst)) == 0
            jst, jout = flush(jst, 1)
            tst, tout = t.flush(tst, 1)
            _same(jst, tst)
            _same_out(jout, tout)
            assert not tout.valid.any()
            continue
        jst = j.on_watermark(jst, JWatermark(0, WIN * (c + 1)))
        tst = t.on_watermark(tst, Watermark(0, torch_scalar(WIN * (c + 1))))
        _same(jst, tst)
        rounds = 0
        while int(j.pending_flush(jst)) > 0:
            assert int(j.pending_flush(jst)) == int(t.pending_flush(tst))
            jst, jout = flush(jst, 1)
            tst, tout = t.flush(tst, 1)
            _same(jst, tst)
            _same_out(jout, tout)
            emitted += _out_rows(tout)
            rounds += 1
        assert int(t.pending_flush(tst)) == 0
        if c == 3:
            assert rounds > 1            # more closed groups than E
    keys = [(k, ws) for k, ws, _, _ in emitted]
    assert len(keys) == len(set(keys)) > 8
    assert all(ws is not None and ws + WIN <= WIN * 4 for _, ws in keys)
    # the NULL window never closes and stays in the table
    occ = tst.table.occupied
    nulls = tst.table.key_cols[1][1]
    assert bool((occ & nulls).any())


def torch_scalar(v):
    import torch

    return torch.tensor(v, dtype=torch.int64)


def test_eowc_slots_plain_against_mask_indices():
    """K7e's plain version: the closed mask's first k slots ascending,
    the size sentinel past the last, and the closed count; nothing
    before the first watermark."""
    import torch

    from risingwave_tpu_torch.common.compact import mask_indices

    g = torch.Generator().manual_seed(7)
    size = 300
    occ = torch.rand(size, generator=g) < 0.7
    key = torch.randint(0, 50, (size,), generator=g) * WIN
    null = torch.rand(size, generator=g) < 0.1
    wm = torch.tensor(2000)
    slots, total = thash_agg.eowc_slots_plain(occ, key, null, WIN, wm, 64)
    closed = occ & ~null & (key + WIN <= 2000)
    assert int(total) == int(closed.sum()) > 64
    assert torch.equal(slots, mask_indices(closed, 64, size))
    slots, total = thash_agg.eowc_slots_plain(
        occ, key, None, WIN, torch.tensor(-(1 << 63)), 8)
    assert int(total) == 0 and bool((slots == size).all())


# ---------------------------------------------------------------------------
# EowcSortExecutor

SORT_COLS = [("ts", "INT64", False), ("v", "INT64", False)]
JSS = JSchema(tuple(JField(n, getattr(JDT, t)) for n, t, _ in SORT_COLS))
TSS = Schema(tuple(Field(n, getattr(DataType, t)) for n, t, _ in SORT_COLS))


def _sort_pair(pool=32, emit=16):
    return (jwatermark.EowcSortExecutor(JSS, 0, pool, emit),
            twatermark.EowcSortExecutor(TSS, 0, pool, emit))


def _sort_chunk(rows, cap=8):
    return _chunk(rows, JSS, TSS, cap)


def test_eowc_sort_reference_script():
    """tests/test_watermark.py:58's script on both: nothing before a
    watermark, then the closed rows in timestamp order."""
    j, t = _sort_pair()
    jst, tst = j.init_state(), t.init_state("cpu")
    jc, tc = _sort_chunk([(300, 3), (100, 1), (200, 2)])
    jst, _ = j.apply(jst, jc)
    tst, _ = t.apply(tst, tc)
    _same(jst, tst)
    outs = []
    for wm in (None, 250, 1000):
        if wm is not None:
            jst = j.on_watermark(jst, JWatermark(0, wm))
            tst = t.on_watermark(tst, Watermark(0, wm))
        jst, jout = j.flush(jst, 1)
        tst, tout = t.flush(tst, 1)
        _same(jst, tst)
        _same_out(jout, tout)
        outs.append([r[1] for r in _out_rows(tout)])
    assert outs == [[], [1, 2], [3]]


def test_eowc_sort_emits_at_the_closing_barrier():
    """tests/test_watermark.py:113's script on the port's fragment: the
    row closed by this barrier's watermark is in the ring already."""
    from risingwave_tpu_torch.stream.fragment import Fragment
    from risingwave_tpu_torch.stream.materialize import AppendOnlyMaterialize

    wf = twatermark.WatermarkFilterExecutor(TSS, ts_col=0, delay_us=0)
    eowc = twatermark.EowcSortExecutor(TSS, ts_col=0, pool_size=32,
                                       emit_capacity=16)
    mv = AppendOnlyMaterialize(TSS, ring_size=64)
    frag = Fragment([wf, eowc, mv])
    assert frag.has_eowc  # the barrier drains again after the watermark
    st = frag.init_states("cpu")
    st, _ = frag.step(st, _sort_chunk([(100, 1), (300, 3)])[1])
    st, _, _ = frag.barrier(st, 1)
    ring = st[2]
    n = int(ring.cursor)
    assert n == 1 and int(ring.values[0][0]) == 100


def test_eowc_sort_random_stream_and_overflow():
    """A seeded out-of-order stream into an 8-row pool with watermarks in
    between: equal pools, flush chunks and overflow counts."""
    j, t = _sort_pair(pool=8, emit=4)
    jst, tst = j.init_state(), t.init_state("cpu")
    rng = np.random.default_rng(3)
    jflush = jax.jit(j.flush)
    for c in range(6):
        rows = [(int(rng.integers(c * 50, c * 50 + 200)), int(x))
                for x in rng.integers(0, 99, int(rng.integers(1, 9)))]
        jc, tc = _sort_chunk(rows)
        jst, _ = j.apply(jst, jc)
        tst, _ = t.apply(tst, tc)
        _same(jst, tst)
        jst = j.on_watermark(jst, JWatermark(0, c * 60))
        tst = t.on_watermark(tst, Watermark(0, c * 60))
        while int(j.pending_flush(jst)):
            assert int(j.pending_flush(jst)) == int(t.pending_flush(tst))
            jst, jout = jflush(jst, 1)
            tst, tout = t.flush(tst, 1)
            _same(jst, tst)
            _same_out(jout, tout)
    assert int(tst.overflow) > 0


# ---------------------------------------------------------------------------
# through SQL

Q7_EOWC = """
CREATE MATERIALIZED VIEW bench_mv AS
SELECT auction, window_start, max(price) AS max_price, count(*) AS bids
FROM TUMBLE(bid, date_time, INTERVAL '1' SECOND)
GROUP BY auction, window_start
EMIT ON WINDOW CLOSE;
"""
BID = """
CREATE SOURCE bid (
    auction BIGINT, bidder BIGINT, price BIGINT,
    channel VARCHAR, url VARCHAR, date_time TIMESTAMP,
    WATERMARK FOR date_time AS date_time - INTERVAL '4' SECOND
) WITH (connector = 'nexmark', nexmark.table = 'bid',
        nexmark.event.rate = '{rate}');
"""
SMALL = dict(chunk_capacity=256, agg_table_size=1 << 10,
             agg_emit_capacity=16, mv_table_size=1 << 12,
             mv_ring_size=1 << 14)


def _engines(ddl, cfg=SMALL):
    from risingwave_tpu.sql import Engine as JEngine
    from risingwave_tpu.sql.planner import PlannerConfig as JConfig
    from risingwave_tpu_torch.sql import Engine
    from risingwave_tpu_torch.sql.planner import PlannerConfig

    engines = (JEngine(JConfig(**cfg)),
               Engine(PlannerConfig(**cfg), device="cpu"))
    for e in engines:
        for stmt in ddl:
            e.execute(stmt)
    return engines


def _rows(eng, sql="SELECT * FROM bench_mv"):
    return sorted(tuple(int(v) for v in r) for r in eng.execute(sql))


def test_q7_eowc_through_both_engines():
    """q7_eowc at 500 events/s: equal rows, every (auction, window)
    exactly once, only closed windows (window_start + 1 s <= the
    watermark), the final agg's state equal, the MV an append-only
    ring; the EOWC flush drained windows larger than its capacity."""
    from risingwave_tpu_torch.stream.hash_agg import HashAggExecutor
    from risingwave_tpu_torch.stream.materialize import AppendOnlyMaterialize

    je, te = _engines([BID.format(rate="500"), Q7_EOWC],
                      dict(SMALL, agg_emit_capacity=4))
    for e in (je, te):
        e.tick(barriers=4, chunks_per_barrier=4)
    rows = _rows(te)
    assert rows == _rows(je) and len(rows) > 10
    keys = [(a, w) for a, w, _, _ in rows]
    assert len(keys) == len(set(keys))
    ex = te.jobs[0].fragment.executors
    agg = next(i for i, x in enumerate(ex) if isinstance(x, HashAggExecutor))
    assert ex[agg].emit_on_window_close
    assert isinstance(ex[-1], AppendOnlyMaterialize)
    wm = int(te.jobs[0].states[agg].wm)
    assert all(w + 1_000_000 <= wm for _, w in keys)
    assert max(sum(1 for _, w2 in keys if w2 == w) for _, w in keys) > 4
    assert state_mismatches(jax.device_get(je.jobs[0].states[agg]),
                            te.jobs[0].states[agg]) == []


def test_sql_eowc_text_against_numpy():
    """tests/test_sql.py:384's EOWC text through both engines, and the
    port's rows against numpy over the bids it generated: windows appear
    once, final, only when closed."""
    from risingwave_tpu_torch.connector.nexmark import NexmarkGenerator

    ddl = ["""
        CREATE SOURCE bid2 (
            auction BIGINT, bidder BIGINT, price BIGINT,
            channel VARCHAR, url VARCHAR, date_time TIMESTAMP,
            WATERMARK FOR date_time AS date_time
        ) WITH (connector = 'nexmark', nexmark.table = 'bid',
                nexmark.event.rate = '1000');""", """
        CREATE MATERIALIZED VIEW w AS
        SELECT window_start, max(price) AS hi, count(*) AS n
        FROM TUMBLE(bid2, date_time, INTERVAL '1' SECOND)
        GROUP BY window_start
        EMIT ON WINDOW CLOSE;"""]
    cfg = dict(chunk_capacity=512, agg_table_size=1 << 10,
               agg_emit_capacity=256, mv_table_size=1 << 10,
               mv_ring_size=1 << 12)
    engines = _engines(ddl, cfg)
    for e in engines:
        e.tick(barriers=3, chunks_per_barrier=1)
    got = [_rows(e, "SELECT window_start, hi, n FROM w") for e in engines]
    assert got[0] == got[1]
    reader = engines[1].jobs[0].source
    bids = reader.gen.gen_bids(0, 3 * 512)
    price = bids.columns[2].numpy()
    ts = bids.columns[5].numpy()
    wm = ts.max()
    w = ts - ts % 1_000_000
    want = [(int(v), int(price[w == v].max()), int((w == v).sum()))
            for v in np.unique(w) if v + 1_000_000 <= wm]
    assert got[1] == want and len(want) > 0


def test_eowc_cold_start_replays_emit_on_window_close(tmp_path):
    """The DDL log keeps EMIT ON WINDOW CLOSE: a cold-started engine plans
    the MV as EOWC again, SELECT reads its ring, and it goes on to the
    rows of an engine that never stopped."""
    from risingwave_tpu_torch.sql import Engine
    from risingwave_tpu_torch.sql.planner import PlannerConfig

    d = str(tmp_path / "eowc")
    ddl = [BID.format(rate="500"), Q7_EOWC,
           "ALTER SYSTEM SET snapshot_interval_checkpoints = 2"]
    a = Engine(PlannerConfig(**SMALL), device="cpu", data_dir=d)
    b = Engine(PlannerConfig(**SMALL), device="cpu")
    for e in (a, b):
        for stmt in ddl:
            e.execute(stmt)
        e.tick(barriers=4, chunks_per_barrier=4)
    rows = _rows(a)
    del a
    cold = Engine(PlannerConfig(**SMALL), device="cpu", data_dir=d)
    agg = next(x for x in cold.jobs[0].fragment.executors
               if isinstance(x, thash_agg.HashAggExecutor))
    assert agg.emit_on_window_close
    assert _rows(cold) == rows
    for e in (b, cold):
        e.tick(barriers=2, chunks_per_barrier=4)
    assert _rows(cold) == _rows(b) and len(_rows(b)) > len(rows)


#: the reference's EOWC refusals, word for word
REFUSED = {
    "join": ("SELECT b.auction, count(*) AS n FROM bid b JOIN auction a "
             "ON b.auction = a.id GROUP BY b.auction",
             "EMIT ON WINDOW CLOSE on joins/subqueries: next round"),
    "subquery": ("SELECT a.auction, count(*) AS n FROM bid b JOIN (SELECT "
                 "id AS auction FROM auction) a ON b.auction = a.auction "
                 "GROUP BY a.auction",
                 "EMIT ON WINDOW CLOSE on joins/subqueries: next round"),
    "window_function": (
        "SELECT auction, row_number() OVER (PARTITION BY auction ORDER BY "
        "date_time) AS r FROM bid", "window functions with sinks/EOWC: "
        "next round"),
    "no_aggregate": ("SELECT auction FROM bid",
                     "EMIT ON WINDOW CLOSE needs GROUP BY window_start over "
                     "a watermarked windowed source"),
    "order_by_limit": (
        "SELECT window_start, count(*) AS n FROM TUMBLE(bid, date_time, "
        "INTERVAL '1' SECOND) GROUP BY window_start ORDER BY n LIMIT 3",
        "ORDER BY ... LIMIT with EMIT ON WINDOW CLOSE: next round"),
    "no_window_key": ("SELECT auction, count(*) AS n FROM bid GROUP BY "
                      "auction",
                      "EMIT ON WINDOW CLOSE needs GROUP BY window_start over "
                      "a watermarked windowed source"),
}


@pytest.fixture(scope="module")
def catalogs():
    from risingwave_tpu.sql import Engine as JEngine
    from risingwave_tpu_torch.sql import Engine

    ddl = BID.format(rate="1000") + """
CREATE SOURCE auction (
    id BIGINT, seller BIGINT, reserve BIGINT, expires TIMESTAMP,
    date_time TIMESTAMP,
    WATERMARK FOR date_time AS date_time - INTERVAL '4' SECOND
) WITH (connector = 'nexmark', nexmark.table = 'auction');
"""
    engines = (JEngine(), Engine(device="cpu"))
    for e in engines:
        e.execute(ddl)
    return engines


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_eowc_refusals_are_the_reference_words(catalogs, case):
    import re

    from risingwave_tpu.sql.planner import PlanError as JPlanError
    from risingwave_tpu_torch.sql.planner import PlanError

    sql, words = REFUSED[case]
    stmt = f"CREATE MATERIALIZED VIEW v_{case} AS {sql} EMIT ON WINDOW CLOSE"
    for e, err in zip(catalogs, (JPlanError, PlanError)):
        with pytest.raises(err, match=re.escape(words)):
            e.execute(stmt)
