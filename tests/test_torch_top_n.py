"""Port parity: group top-N (``stream/top_n.py``) and Nexmark q19 / q18.

The port's plain versions of K16 (``pool_apply``), K17 (``_band_mask``)
and K18 (``flush``'s band diff) run on the CPU against the reference's
functions on the same numpy-seeded inputs: a pool of 256 rows of
(a BIGINT, b BIGINT, s VARCHAR(12) with random bytes past its length,
t TIMESTAMP), chunks of 64 rows with duplicate rows, in-chunk +/- pairs,
deletes of pool rows and of rows the pool lacks, and more inserts than
free slots.  Then ``bench.py``'s sources run the published q19 and q18
(the ROW_NUMBER-in-subquery rewrite) through both ``Engine``s at chunk
256, pool 4096, emit 1024 and MV table 2^12, and a reference state
carried into the port mid-run continues identically; a pool with float
columns grouped by a float key (-0.0, subnormals, NaN) equals the
reference byte for byte.  Tolerance: none (every value is an integer or
a copied float; hashes compare by bit pattern).
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import risingwave_tpu.stream.hash_join as jhash_join
import risingwave_tpu.stream.top_n as jtop_n
import risingwave_tpu_torch.stream.hash_join as thash_join
import risingwave_tpu_torch.stream.top_n as ttop_n
from bench import SOURCES
from risingwave_tpu.common.chunk import Chunk as JChunk, StrCol as JStrCol
from risingwave_tpu.common.types import (
    DataType as JDT,
    Field as JField,
    Schema as JSchema,
)
from risingwave_tpu.expr.node import InputRef as JRef
from risingwave_tpu.sql import Engine as JEngine
from risingwave_tpu.sql.planner import PlannerConfig as JConfig
from risingwave_tpu_torch.common.chunk import Chunk, StrCol
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.compat import state_from_numpy, state_mismatches
from risingwave_tpu_torch.expr.node import InputRef
from risingwave_tpu_torch.sql import Engine
from risingwave_tpu_torch.sql.planner import PlanError, PlannerConfig

Q19 = """
CREATE MATERIALIZED VIEW bench_mv AS
SELECT * FROM (SELECT *, ROW_NUMBER() OVER (PARTITION BY auction ORDER BY
               price DESC) AS rank_number FROM bid) WHERE rank_number <= 10;
"""
Q18 = """
CREATE MATERIALIZED VIEW bench_mv AS
SELECT auction, bidder, price, channel, url, date_time
FROM (SELECT *, ROW_NUMBER() OVER (PARTITION BY bidder, auction ORDER BY
      date_time DESC) AS rank_number FROM bid) WHERE rank_number <= 1;
"""
QUERIES = {"q19": Q19, "q18": Q18}
SIZES = dict(chunk_capacity=256, topn_pool_size=4096,
             topn_emit_capacity=1024, mv_table_size=1 << 12)

CAP, POOL, W = 64, 256, 12
COLS = [("a", "INT64", 0), ("b", "INT64", 0), ("s", "VARCHAR", W),
        ("t", "TIMESTAMP", 0)]
JSCHEMA = JSchema(tuple(JField(n, getattr(JDT, t), str_width=w or 16)
                        for n, t, w in COLS))
TSCHEMA = Schema(tuple(Field(n, getattr(DataType, t), str_width=w or 16)
                       for n, t, w in COLS))


def _rows(rng, n, keys=6):
    """Columns of n random rows: few keys, random strings whose bytes past
    their length are random too."""
    return [rng.integers(0, keys, n).astype(np.int64),
            rng.integers(-5, 5, n).astype(np.int64),
            (rng.integers(0, 256, (n, W)).astype(np.uint8),
             rng.integers(0, W + 1, n).astype(np.int32)),
            rng.integers(0, 50, n).astype(np.int64)]


def _take(cols, idx):
    return [(c[0][idx], c[1][idx]) if isinstance(c, tuple) else c[idx]
            for c in cols]


def _cat(a, b):
    return [(np.concatenate([x[0], y[0]]), np.concatenate([x[1], y[1]]))
            if isinstance(x, tuple) else np.concatenate([x, y])
            for x, y in zip(a, b)]


def _chunks(cols, ops, valid):
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
    return (JChunk(tuple(jc), jnp.asarray(ops), jnp.asarray(valid), JSCHEMA),
            Chunk(tuple(tc), torch.from_numpy(ops.copy()),
                  torch.from_numpy(valid.copy()), TSCHEMA))


def _mixed_chunk(rng, pool_cols):
    """CAP rows: inserts of fresh rows and of duplicates, deletes of pool
    rows (some twice), an in-chunk +/- pair and a delete of a row the
    pool never held; a few rows invisible."""
    fresh = _rows(rng, CAP)
    n_pool = pool_cols[0].shape[0]
    cols = fresh
    ops = np.zeros(CAP, np.int8)
    if n_pool:
        victims = rng.integers(0, n_pool, 20)
        victims[1] = victims[0]                      # a duplicate delete
        cols = _cat(_take(pool_cols, victims), _take(fresh, np.arange(20,
                                                                      CAP)))
        ops[:20] = rng.choice([1, 2], 20)            # Delete / UpdateDelete
    pair = _take(fresh, np.array([40, 40]))          # an in-chunk +/- pair
    cols = _cat(_take(cols, np.arange(CAP - 4)), _cat(pair,
                                                     _take(fresh, [41, 41])))
    ops[CAP - 4:] = [0, 1, 3, 3]                     # +, -, dup inserts
    ops[30] = 1                                      # delete of a fresh row
    valid = rng.random(CAP) < 0.95
    valid[CAP - 4:] = True
    return cols, ops, valid


def _assert_pool(jrows, jvalid, jhash, trows, tvalid, thash):
    for j, (a, b) in enumerate(zip(jrows, trows)):
        if isinstance(a, JStrCol):
            np.testing.assert_array_equal(np.asarray(a.data), b.data.numpy())
            np.testing.assert_array_equal(np.asarray(a.lens), b.lens.numpy())
        else:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f"col {j}")
    np.testing.assert_array_equal(np.asarray(jvalid), tvalid.numpy())
    np.testing.assert_array_equal(np.asarray(jhash).view(np.int64),
                                  thash.numpy())


# ---------------------------------------------------------------------------
# the helpers of the reference's hash_join the pool uses


def test_rank_by_and_group_totals_match_reference():
    rng = np.random.default_rng(3)
    g = rng.integers(-3, 3, 500).astype(np.int64)
    g[::7] = np.iinfo(np.int64).min                  # sign-bit patterns
    active = rng.random(500) < 0.6
    vals = rng.random(500) < 0.5
    jg = jnp.asarray(g.view(np.uint64))
    np.testing.assert_array_equal(
        thash_join._rank_by(torch.from_numpy(g), torch.from_numpy(active))
        .numpy(), np.asarray(jhash_join._rank_by(jg, jnp.asarray(active))))
    np.testing.assert_array_equal(
        thash_join._group_totals(torch.from_numpy(g), torch.from_numpy(vals))
        .numpy(),
        np.asarray(jhash_join._group_totals(jg, jnp.asarray(vals))))


@pytest.mark.parametrize("desc", [False, True])
@pytest.mark.parametrize("kind", ["int64", "int32", "bool", "float64",
                                  "float32", "str3", "str12"])
def test_order_key_matches_reference(kind, desc):
    rng = np.random.default_rng(len(kind) + desc)
    n = 300
    if kind.startswith("str"):
        w = int(kind[3:])
        data = rng.integers(0, 256, (n, w)).astype(np.uint8)
        lens = rng.integers(0, w + 1, n).astype(np.int32)
        jcol = JStrCol(jnp.asarray(data), jnp.asarray(lens))
        tcol = StrCol(torch.from_numpy(data), torch.from_numpy(lens))
    else:
        if kind == "bool":
            x = rng.random(n) < 0.5
        elif kind.startswith("float"):
            x = (rng.standard_normal(n)
                 * 10.0 ** rng.integers(-3, 30, n)).astype(kind)
            x[:4] = [0.0, -0.0, 1e-310 if kind == "float64" else 1e-40,
                     -np.inf]
        else:
            x = rng.integers(np.iinfo(kind).min, np.iinfo(kind).max, n,
                             dtype=kind)
        jcol, tcol = jnp.asarray(x), torch.from_numpy(x)
    want = np.asarray(jtop_n._order_key(jcol, desc)).view(np.int64)
    np.testing.assert_array_equal(ttop_n._order_key(tcol, desc).numpy(),
                                  want)


# ---------------------------------------------------------------------------
# K16: pool_apply


@pytest.mark.parametrize("pool", [POOL, 96])
def test_pool_apply_deletes_annihilation_duplicates_overflow(pool):
    """Chunks with every branch; pool 96 overflows on the second chunk."""
    rng = np.random.default_rng(pool)
    jex = jtop_n.GroupTopNExecutor(JSCHEMA, [JRef(0)], [(JRef(1), True)],
                                   limit=3, pool_size=pool)
    tex = ttop_n.GroupTopNExecutor(TSCHEMA, [InputRef(0)],
                                   [(InputRef(1), True)], limit=3,
                                   pool_size=pool)
    jst = jex.init_state()
    tst = state_from_numpy(jax.device_get(jst))
    assert state_mismatches(jax.device_get(jst), tst) == []
    apply = jax.jit(jtop_n.pool_apply, static_argnums=4)
    held = _rows(rng, 0)
    n_over = n_missing = 0
    for step in range(4):
        cols, ops, valid = _mixed_chunk(rng, held)
        jc, tc = _chunks(cols, ops, valid)
        jrows, jvalid, jhash, jo, jm = apply(jst.rows, jst.valid,
                                             jst.row_hash, jc, pool)
        trows, tvalid, thash, to, tm = ttop_n.pool_apply_plain(
            tst.rows, tst.valid, tst.row_hash, tc, pool)
        _assert_pool(jrows, jvalid, jhash, trows, tvalid, thash)
        assert (int(jo), int(jm)) == (int(to), int(tm))
        n_over += int(to)
        n_missing += int(tm)
        jst = jst._replace(rows=jrows, valid=jvalid, row_hash=jhash)
        # the executor's apply: the same, counters on the state
        tst2 = state_from_numpy(jax.device_get(jst))
        held = _cat(held, _take(cols, np.flatnonzero(valid & (ops == 0))))
    assert n_missing > 0
    if pool == 96:
        assert n_over > 0
    # GroupTopNExecutor.apply adds the counts to the state's counters
    jst2, _ = jex.apply(jst, jc)
    tst2, out = tex.apply(tst2, tc)
    assert out is None
    assert state_mismatches(jax.device_get(jst2), tst2) == []


# ---------------------------------------------------------------------------
# K17 and K18: the band and the flush


def _executors(group, order, limit, offset, rank_alias, append_only):
    kw = dict(limit=limit, offset=offset, pool_size=POOL,
              emit_capacity=32, rank_alias=rank_alias,
              append_only=append_only)
    jex = jtop_n.GroupTopNExecutor(
        JSCHEMA, [JRef(i) for i in group],
        [(JRef(i), d) for i, d in order], **kw)
    tex = ttop_n.GroupTopNExecutor(
        TSCHEMA, [InputRef(i) for i in group],
        [(InputRef(i), d) for i, d in order], **kw)
    return jex, tex


def _filled(jex, rng, steps=2, deletes=True):
    """A reference state after ``steps`` chunks (all inserts unless
    ``deletes``), and its port copy."""
    st = jex.init_state()
    held = _rows(rng, 0)
    for _ in range(steps):
        if deletes:
            cols, ops, valid = _mixed_chunk(rng, held)
        else:
            cols, ops, valid = _rows(rng, CAP), np.zeros(CAP, np.int8), \
                np.ones(CAP, bool)
        jc, _ = _chunks(cols, ops, valid)
        st, _ = jex.apply(st, jc)
        held = _cat(held, _take(cols, np.flatnonzero(valid & (ops == 0))))
    return st, state_from_numpy(jax.device_get(st))


BAND_CASES = [
    # (group, order, limit, offset)
    ([0], [(1, True)], 3, 0),
    ([0], [(1, False), (3, True)], 2, 1),
    ([0, 1], [(3, True)], 1, 0),
    ([], [(3, False), (1, True)], 10, 5),
    ([2], [(1, True)], 2, 0),                          # string group key
]


@pytest.mark.parametrize("group,order,limit,offset", BAND_CASES)
def test_band_mask_matches_reference(group, order, limit, offset):
    rng = np.random.default_rng(limit * 10 + offset)
    jex, tex = _executors(group, order, limit, offset, None, False)
    jst, tst = _filled(jex, rng, steps=3)
    jband, jranks = jex._band_mask(jst)
    tband, tranks = tex._band_mask(tst)
    np.testing.assert_array_equal(np.asarray(jband), tband.numpy())
    np.testing.assert_array_equal(np.asarray(jranks), tranks.numpy())
    assert 0 < int(tband.sum()) < int(tst.valid.sum())


def _assert_chunks(jout, tout):
    np.testing.assert_array_equal(np.asarray(jout.ops), tout.ops.numpy())
    np.testing.assert_array_equal(np.asarray(jout.valid), tout.valid.numpy())
    for a, b in zip(jout.columns, tout.columns):
        if isinstance(a, JStrCol):
            np.testing.assert_array_equal(np.asarray(a.data), b.data.numpy())
            np.testing.assert_array_equal(np.asarray(a.lens), b.lens.numpy())
        else:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("rank_alias", [None, "rn"])
@pytest.mark.parametrize("offset,append_only", [(0, False), (2, False),
                                                (0, True)])
def test_flush_matches_reference(rank_alias, offset, append_only):
    """Three flushes with chunks between them (retractions unless
    append-only): out chunks [2E] (dead entries carry row S-1) and
    every state tensor, the emitted band included."""
    rng = np.random.default_rng(offset + 3 * append_only)
    jex, tex = _executors([0], [(1, True), (3, False)], 3, offset,
                          rank_alias, append_only)
    jst, tst = _filled(jex, rng, deletes=not append_only)
    emitted = 0
    for step in range(3):
        jst, jout = jex.flush(jst, step)
        tst, tout = tex.flush(tst, step)
        _assert_chunks(jout, tout)
        assert state_mismatches(jax.device_get(jst), tst) == []
        emitted += int(tout.valid.sum())
        if append_only:
            cols, ops, valid = _rows(rng, CAP), np.zeros(CAP, np.int8), \
                np.ones(CAP, bool)
        else:
            held = [c.numpy() if not isinstance(c, StrCol)
                    else (c.data.numpy(), c.lens.numpy())
                    for c in tst.rows]
            held = _take(held, np.flatnonzero(tst.valid.numpy()))
            cols, ops, valid = _mixed_chunk(rng, held)
        jc, tc = _chunks(cols, ops, valid)
        jst, _ = jex.apply(jst, jc)
        tst, _ = tex.apply(tst, tc)
        assert state_mismatches(jax.device_get(jst), tst) == []
    assert emitted > 0
    assert [f.name for f in tex.out_schema] == \
        [f.name for f in jex.out_schema]


# ---------------------------------------------------------------------------
# q19 and q18 through both engines


def _engine(kind, query, rate="1000000"):
    eng = JEngine(JConfig(**SIZES)) if kind == "ref" else \
        Engine(PlannerConfig(**SIZES), device="cpu")
    eng.execute(SOURCES.format(rate=rate))
    eng.execute(QUERIES[query])
    return eng


def _mv(eng):
    return sorted(tuple(int(v) if not isinstance(v, str) else v for v in r)
                  for r in eng.execute("SELECT * FROM bench_mv"))


def _assert_same_states(jeng, teng):
    jst = jax.device_get(jeng.jobs[0].states)
    tst = teng.jobs[0].states
    assert [type(s).__name__ for s in tst] == \
        [type(s).__name__ for s in jst]
    assert "TopNState" in [type(s).__name__ for s in tst]
    for i, st in enumerate(tst):
        if st != ():
            assert state_mismatches(jst[i], st, f"states[{i}]") == []


@pytest.mark.parametrize("query", ["q19", "q18"])
def test_engine_rows_and_state_match_reference(query):
    jeng, teng = _engine("ref", query), _engine("port", query)
    assert repr(teng.jobs[0].fragment) == repr(jeng.jobs[0].fragment)
    assert "GroupTopNExecutor" in repr(teng.jobs[0].fragment)
    for e in (jeng, teng):
        e.tick(barriers=5, chunks_per_barrier=4)
    rows = _mv(teng)
    assert rows == _mv(jeng) and len(rows) > 50
    assert teng.query("SELECT * FROM bench_mv")[0] == \
        jeng.query("SELECT * FROM bench_mv")[0]
    _assert_same_states(jeng, teng)
    topn = next(s for s in teng.jobs[0].states
                if type(s).__name__ == "TopNState")
    assert int(topn.prev_valid.sum()) == len(rows)
    assert int(topn.overflow) == int(topn.inconsistency) == 0


def test_engine_from_carried_reference_state():
    """q19's reference state (pool, band, MV) carried into the port after
    3 barriers continues identically."""
    jeng, teng = _engine("ref", "q19"), _engine("port", "q19")
    jeng.tick(barriers=3, chunks_per_barrier=4)
    jjob, tjob = jeng.jobs[0], teng.jobs[0]
    tjob.states = state_from_numpy(jax.device_get(jjob.states))
    tjob.source.offset = jjob.source.offset
    _assert_same_states(jeng, teng)
    for e in (jeng, teng):
        e.tick(barriers=3, chunks_per_barrier=4)
    assert _mv(teng) == _mv(jeng)
    _assert_same_states(jeng, teng)


def test_plain_order_by_limit_topn_and_plan_errors():
    """The plain ``ORDER BY .. LIMIT`` TopN (the same executor, no group)
    plans and runs as the reference's; shapes the port lacks raise."""
    sql = ("CREATE MATERIALIZED VIEW top AS SELECT auction, price FROM bid "
           "ORDER BY price DESC, auction LIMIT 5 OFFSET 1;")
    engines = []
    for eng in (JEngine(JConfig(**SIZES)),
                Engine(PlannerConfig(**SIZES), device="cpu")):
        eng.execute(SOURCES.format(rate="1000000"))
        eng.execute(sql)
        eng.tick(barriers=2, chunks_per_barrier=2)
        engines.append(eng)
    jeng, teng = engines
    assert repr(teng.jobs[0].fragment) == repr(jeng.jobs[0].fragment)
    rows = [sorted(e.execute("SELECT * FROM top")) for e in engines]
    assert rows[0] == rows[1] and len(rows[0]) == 5
    _assert_same_states(jeng, teng)
    with pytest.raises(PlanError):
        teng.execute(
            "CREATE MATERIALIZED VIEW w AS SELECT * FROM (SELECT a.id, "
            "ROW_NUMBER() OVER (PARTITION BY a.seller ORDER BY a.reserve) "
            "AS r FROM person p JOIN auction a ON p.id = a.seller) "
            "WHERE r <= 1;")
    # a window function outside a row_number subquery: an over-window
    teng.execute(
        "CREATE MATERIALIZED VIEW w AS SELECT auction, ROW_NUMBER() OVER "
        "(PARTITION BY auction ORDER BY price) AS r FROM bid;")
    assert "OverWindowExecutor" in repr(teng.jobs[-1].fragment)


@pytest.mark.parametrize("col", [
    torch.zeros(4, dtype=torch.float64), torch.zeros(4, dtype=torch.bool),
    StrCol(torch.zeros((4, 8), dtype=torch.uint8),
           torch.zeros(4, dtype=torch.int32))],
    ids=["float", "bool", "string"])
def test_cuda_band_refuses_unported_order_keys(col):
    """K17 encodes integer and timestamp order keys only; the others are
    refused before any launch (the plain version takes them)."""
    with pytest.raises(NotImplementedError):
        ttop_n.band_keys_cuda([col], [True], [], 4, "cpu")
    band, ranks = ttop_n.band_mask_plain([col], [True], [],
                                         torch.ones(4, dtype=torch.bool),
                                         0, 2)
    assert int(band.sum()) == 2 and ranks.tolist() == [1, 2, 3, 4]


def _assert_state_bytes(jst, tst):
    """Every state leaf equal byte for byte (floats by bit pattern, so
    NaN keys compare too)."""
    from risingwave_tpu_torch.compat import leaf_paths

    ref, port = leaf_paths(jax.device_get(jst)), leaf_paths(tst)
    assert [p for p, _ in ref] == [p for p, _ in port]
    for (path, a), (_, b) in zip(ref, port):
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape and a.itemsize == b.itemsize, path
        np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                      b.reshape(-1).view(np.uint8),
                                      err_msg=path)


def test_float_columns_and_group_keys_match_reference():
    """A pool of (a BIGINT, x DOUBLE, y REAL) grouped by x, whose values
    include -0.0 and +0.0, subnormals and NaN: the row hashes (K16's
    deletes find rows by them), the group hash of the band (K17) and the
    flush equal the reference's, byte for byte."""
    rng = np.random.default_rng(23)
    names = (("a", "INT64"), ("x", "FLOAT64"), ("y", "FLOAT32"))
    jschema = JSchema(tuple(JField(n, getattr(JDT, t)) for n, t in names))
    tschema = Schema(tuple(Field(n, getattr(DataType, t)) for n, t in names))
    kw = dict(limit=2, pool_size=64, emit_capacity=32, rank_alias="rn")
    jex = jtop_n.GroupTopNExecutor(jschema, [JRef(1)], [(JRef(0), True)],
                                   **kw)
    tex = ttop_n.GroupTopNExecutor(tschema, [InputRef(1)],
                                   [(InputRef(0), True)], **kw)
    jst = jex.init_state()
    tst = state_from_numpy(jax.device_get(jst))
    xs = np.array([0.0, -0.0, 1e-310, -1e-311, np.nan, 2.5, -2.5, 1e300])
    held = np.zeros((0, 3))
    for epoch in range(3):
        n = 24
        a = rng.integers(0, 9, n).astype(np.int64)
        x = rng.choice(xs, n)
        with np.errstate(over="ignore"):
            y = rng.choice(xs, n).astype(np.float32)
        ops = np.zeros(n, np.int8)
        if len(held):
            pick = rng.choice(len(held), 4)
            a[:4], x[:4], y[:4] = held[pick, 0], held[pick, 1], held[pick, 2]
            ops[:4] = 1
        held = np.concatenate([held, np.stack([a, x, y], 1)[ops == 0]])
        jc = JChunk((jnp.asarray(a), jnp.asarray(x), jnp.asarray(y)),
                    jnp.asarray(ops), jnp.ones(n, bool), jschema)
        tc = Chunk((torch.from_numpy(a), torch.from_numpy(x),
                    torch.from_numpy(y)), torch.from_numpy(ops),
                   torch.ones(n, dtype=torch.bool), tschema)
        jst, _ = jex.apply(jst, jc)
        tst, _ = tex.apply(tst, tc)
        _assert_state_bytes(jst, tst)
        jband, jranks = jex._band_mask(jst)
        tband, tranks = tex._band_mask(tst)
        np.testing.assert_array_equal(np.asarray(jband), tband.numpy())
        np.testing.assert_array_equal(np.asarray(jranks), tranks.numpy())
        jst, jout = jex.flush(jst, epoch)
        tst, tout = tex.flush(tst, epoch)
        np.testing.assert_array_equal(np.asarray(jout.valid),
                                      tout.valid.numpy())
        for ca, cb in zip(jout.columns, tout.columns):
            ca = np.ascontiguousarray(np.asarray(ca))
            np.testing.assert_array_equal(ca.view(np.uint8),
                                          cb.numpy().view(np.uint8))
        _assert_state_bytes(jst, tst)
    # -0.0 and +0.0 are one group, the subnormals join them, NaN is one
    # group of its own: 4 groups of x values, 2 rows each at most
    assert 0 < int(tst.prev_valid.sum()) <= 2 * 5
    assert int(tst.inconsistency) == int(np.asarray(jst.inconsistency))
