"""Port parity: scalar functions, casts, ``avg`` and SQL UDFs through SQL.

- Nexmark q14 (the ``count_char`` SQL UDF over ``LENGTH``/``REPLACE``,
  ``0.908 * price``, the CASE over ``extract(hour ...)``), with this
  repo's bid schema (``url`` for the missing ``extra``, ``'e'`` for
  ``'c'``), ``bid_strings`` (LIKE, ``starts_with``, ``contains``,
  ``substr``, ``||``, ``trim``, ``ltrim``, ``extract(year|doy)``, CAST and
  the two divides) and ``avg_bid`` (``avg`` over BIGINT and NUMERIC),
  verbatim (``chip_smoke.SCALAR_QUERY_SQL``) through the reference engine
  and the port's (``device="cpu"``) on bench.py's sources: MV rows with
  their types, and every state tensor, after every barrier.
- The published q14 verbatim (``extra``, ``count_char(extra, 'c')``)
  over the conformance file's bid table, INSERTed rows reaching all three
  hour branches, prices on both sides of each bound and ``extra`` with 0
  to 9 ``'c'``s; the reference's ``test_sql_udf_inline_q14`` and its
  duplicate and arity errors; ``avg`` after a retracting DELETE.
- A durable q14 whose cold start replays the UDF before the MV.
- The faults this slice repaired: F1 (``d / 2`` over DOUBLE and NUMERIC
  raised at every tick), F2 (a call with no overload in a WHERE passed
  CREATE and stopped every tick; CAST and ``||`` escaped the registry)
  and F3 (``SET query_epoch`` was ignored).
- LIKE's refusals in the reference's words; the three views plan for
  CUDA, and a LIKE program past K23f's size is refused for CUDA only.

Tolerance: none, except ``bid_strings``' ``p3`` (``CAST(price AS DOUBLE
PRECISION) / 3``), held to 1 ULP: XLA rewrites a division by a constant
into a multiply by its reciprocal, and the port divides (IEEE).
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import shutil
import tempfile

import jax
import numpy as np
import pytest

from bench import SOURCES
from chip_smoke import SCALAR_MV, SCALAR_QUERY_SQL
from risingwave_tpu.sql import Engine as JEngine
from risingwave_tpu.sql.planner import PlannerConfig as JConfig
from risingwave_tpu_torch.compat import state_mismatches, state_to_numpy
from risingwave_tpu_torch.sql import Engine
from risingwave_tpu_torch.sql import ast
from risingwave_tpu_torch.sql.binder import BindError
from risingwave_tpu_torch.sql.engine import inline_udfs
from risingwave_tpu_torch.sql.parser import parse
from risingwave_tpu_torch.sql.planner import PlanError, Planner, \
    PlannerConfig

SIZES = dict(chunk_capacity=256, agg_table_size=1 << 10,
             agg_emit_capacity=256, mv_table_size=1 << 10,
             mv_ring_size=1 << 13)
#: the reference's conformance bid table (tests/test_conformance_features)
BID_DDL = ("CREATE TABLE bid (auction BIGINT, bidder BIGINT, "
           "price BIGINT, channel VARCHAR, url VARCHAR, "
           "date_time TIMESTAMP, extra VARCHAR)")
#: Nexmark q14 as nexmark-flink publishes it
Q14_PUBLISHED = """
CREATE FUNCTION count_char(s varchar, c varchar) RETURNS int
LANGUAGE SQL AS $$SELECT LENGTH(s) - LENGTH(REPLACE(s, c, ''))$$;
CREATE MATERIALIZED VIEW nexmark_q14 AS
SELECT
    auction,
    bidder,
    0.908 * price as price,
    CASE
        WHEN
            extract(hour from date_time) >= 8 AND
            extract(hour from date_time) <= 18
        THEN 'dayTime'
        WHEN
            extract(hour from date_time) <= 6 OR
            extract(hour from date_time) >= 20
        THEN 'nightTime'
        ELSE 'otherTime'
    END AS bidTimeType,
    date_time,
    extra,
    count_char(extra, 'c') AS c_counts
FROM bid
WHERE 0.908 * price > 1000000 AND 0.908 * price < 50000000;
"""
#: (price, time of day, extra): 0.908 * price on both sides of 1,000,000
#: and of 50,000,000, every hour branch and its edges
Q14_ROWS = [(1_000_000, "03:00:00", "c"), (1_101_321, "09:00:00", "cc"),
            (1_101_322, "03:00:00", ""), (55_066_079, "07:00:00", "abcabc"),
            (55_066_080, "12:00:00", "c"), (2_000_000, "08:00:00", "c" * 9),
            (3_000_000, "18:59:59", "xyz"), (4_000_000, "19:30:00", "cac"),
            (5_000_000, "20:00:00", "c c"), (6_000_000, "06:59:59", "ccc"),
            (7_000_000, "00:00:00", "bcd"), (8_000_000, "23:59:59", "")]


def _typed(rows):
    """Rows as sorted tuples of (type name, value)."""
    return sorted((tuple((type(v).__name__, v) for v in r) for r in rows),
                  key=repr)


def _rows(engine, name):
    return _typed(engine.execute(f"SELECT * FROM {name}"))


def _engines(ddl, sql, sizes=SIZES):
    out = []
    for eng in (JEngine(JConfig(**sizes)),
                Engine(PlannerConfig(**sizes), device="cpu")):
        eng.execute(ddl)
        eng.execute(sql)
        out.append(eng)
    return out


def _p3_close(jrows, trows):
    """bid_strings' rows equal, p3 (the float64 divide by a constant)
    within 1 ULP (module docstring)."""
    assert len(jrows) == len(trows)
    for jr, tr in zip(jrows, trows):
        assert jr[:7] + jr[8:] == tr[:7] + tr[8:]
        assert jr[7][0] == tr[7][0] == "float64"
        assert abs(jr[7][1] - tr[7][1]) <= np.spacing(abs(jr[7][1]))


@pytest.mark.parametrize("query", sorted(SCALAR_QUERY_SQL))
def test_scalar_query_rows_and_state(query):
    jeng, teng = _engines(SOURCES.format(rate="1000000"),
                          SCALAR_QUERY_SQL[query])
    mv = SCALAR_MV[query]
    for _ in range(3):
        for e in (jeng, teng):
            e.tick(barriers=1, chunks_per_barrier=2)
        jrows, trows = _rows(jeng, mv), _rows(teng, mv)
        assert trows
        jst = jax.device_get(jeng.jobs[0].states)
        bad = state_mismatches(jst, teng.jobs[0].states)
        if query == "bid_strings":
            _p3_close(jrows, trows)
            # the ring's column 7 is p3, held to 1 ULP by the rows above
            assert all(b.endswith(".values[7]") for b in bad), bad
        else:
            assert trows == jrows
            assert bad == []
    if query == "q14":
        # q14's bids span seconds from 2015-07-15 00:00 UTC: hour 0
        assert {r[3][1] for r in trows} == {"nightTime"}
        assert {r[6] for r in trows} == {("int32", 3)}


def test_published_q14_over_the_bid_table():
    jeng, teng = _engines(BID_DDL, Q14_PUBLISHED)
    values = ", ".join(
        f"({1000 + i}, {2000 + i}, {p}, 'Google', 'https://x.io/{i}', "
        f"TIMESTAMP '2015-07-15 {t}', '{x}')"
        for i, (p, t, x) in enumerate(Q14_ROWS))
    for e in (jeng, teng):
        e.execute(f"INSERT INTO bid VALUES {values}")
        e.tick(barriers=2)
    jrows, trows = _rows(jeng, "nexmark_q14"), _rows(teng, "nexmark_q14")
    assert trows == jrows
    got = {r[0][1]: (r[3][1], r[6][1]) for r in trows}
    assert sorted(got) == [1002, 1003, 1005, 1006, 1007, 1008, 1009, 1010,
                           1011]
    assert got[1005] == ("dayTime", 9) and got[1007] == ("otherTime", 2)
    assert got[1003] == ("otherTime", 2) and got[1002] == ("nightTime", 0)
    assert {v[0] for v in got.values()} == {"dayTime", "nightTime",
                                            "otherTime"}


def test_sql_udf_inline_q14():
    """The reference's ``test_sql_udf_inline_q14`` on the port."""
    eng = Engine(PlannerConfig(**SIZES), device="cpu")
    eng.execute("CREATE TABLE t (s VARCHAR, c VARCHAR)")
    eng.execute("INSERT INTO t VALUES ('accbcac', 'c')")
    eng.execute(
        "CREATE FUNCTION count_char(s varchar, c varchar) RETURNS int "
        "LANGUAGE SQL AS $$SELECT LENGTH(s) - LENGTH(REPLACE(s, c, ''))$$")
    eng.execute("CREATE MATERIALIZED VIEW v AS "
                "SELECT count_char(s, c) AS n FROM t")
    eng.tick(barriers=2)
    assert eng.execute("SELECT * FROM v") == [(4,)]


def test_sql_udf_duplicate_and_arity_errors():
    """The reference's errors, in its words; IF NOT EXISTS passes."""
    eng = Engine(PlannerConfig(**SIZES), device="cpu")
    eng.execute("CREATE FUNCTION one(x int) RETURNS int "
                "LANGUAGE SQL AS 'SELECT x + 1'")
    with pytest.raises(ValueError, match="already exists"):
        eng.execute("CREATE FUNCTION one(x int) RETURNS int "
                    "LANGUAGE SQL AS 'SELECT x'")
    eng.execute("CREATE FUNCTION IF NOT EXISTS one(x int) RETURNS int "
                "LANGUAGE SQL AS 'SELECT x'")
    with pytest.raises(ValueError, match="must be a single SELECT"):
        eng.execute("CREATE FUNCTION two(x int) RETURNS int "
                    "LANGUAGE SQL AS 'SELECT x FROM t'")
    eng.execute("CREATE TABLE t (a BIGINT)")
    with pytest.raises(ValueError, match="takes 1 arguments"):
        eng.execute("CREATE MATERIALIZED VIEW v AS "
                    "SELECT one(a, a) AS n FROM t")
    eng.execute("INSERT INTO t VALUES (41)")
    eng.execute("CREATE MATERIALIZED VIEW v AS SELECT one(a) AS n FROM t")
    eng.tick(barriers=2)
    assert eng.execute("SELECT * FROM v") == [(42,)]


@pytest.mark.parametrize("grouped", [True, False])
def test_avg_after_a_retracting_delete(grouped):
    """avg over BIGINT (float64) and NUMERIC (truncated), grouped and
    global, before and after a retracting DELETE."""
    ddl = ("CREATE TABLE t (k BIGINT, v BIGINT, n NUMERIC) "
           "WITH (retract = 'true')")
    sql = ("CREATE MATERIALIZED VIEW a AS SELECT k, avg(v) AS av, "
           "avg(n) AS an, count(*) AS c FROM t GROUP BY k" if grouped else
           "CREATE MATERIALIZED VIEW a AS SELECT avg(v) AS av, "
           "avg(n) AS an, count(*) AS c FROM t")
    jeng, teng = _engines(ddl, sql)
    for e in (jeng, teng):
        e.execute("INSERT INTO t VALUES (1, 10, 1.5), (1, 11, -2.25), "
                  "(1, 12, 0.000001), (2, -7, -1.000001), (2, 4, 3.5)")
        e.tick(barriers=1)
    assert _rows(teng, "a") == _rows(jeng, "a")
    for e in (jeng, teng):
        e.execute("DELETE FROM t VALUES (1, 12, 0.000001), (2, 4, 3.5)")
        e.tick(barriers=1)
    assert _rows(teng, "a") == _rows(jeng, "a")
    got = sorted(tuple(float(x) for x in r)
                 for r in teng.execute("SELECT * FROM a"))
    assert got == ([(1, 10.5, -0.375, 2), (2, -7.0, -1.000001, 1)]
                   if grouped else [(14 / 3, -0.583333, 3)])
    assert state_mismatches(jax.device_get(jeng.jobs[0].states),
                            teng.jobs[0].states) == []


def test_durable_q14_cold_start_replays_the_udf():
    sizes = dict(SIZES, mv_ring_size=1 << 12)
    d = tempfile.mkdtemp()
    try:
        eng = Engine(PlannerConfig(**sizes), data_dir=d, device="cpu")
        eng.execute(SOURCES.format(rate="1000000"))
        eng.execute(SCALAR_QUERY_SQL["q14"])
        eng.tick(barriers=2, chunks_per_barrier=2)
        del eng
        cold = Engine(PlannerConfig(**sizes), data_dir=d, device="cpu")
        assert "count_char" in cold.functions
        cold.tick(barriers=1, chunks_per_barrier=2)
        whole = Engine(PlannerConfig(**sizes), device="cpu")
        whole.execute(SOURCES.format(rate="1000000"))
        whole.execute(SCALAR_QUERY_SQL["q14"])
        whole.tick(barriers=3, chunks_per_barrier=2)
        assert _rows(cold, "nexmark_q14") == _rows(whole, "nexmark_q14")
        assert state_mismatches(state_to_numpy(whole.jobs[0].states),
                                cold.jobs[0].states) == []
    finally:
        shutil.rmtree(d, ignore_errors=True)


def test_f1_float_and_numeric_divide():
    """F1: ``d / 2`` and ``n / 2`` ran into NotImplementedError at every
    tick; both engines give 1.25 and 0.625."""
    ddl = "CREATE TABLE t (d DOUBLE, n NUMERIC)"
    sql = ("CREATE MATERIALIZED VIEW m AS SELECT d / 2 AS h, n / 2 AS q, "
           "n / 0 AS z FROM t")
    jeng, teng = _engines(ddl, sql)
    for e in (jeng, teng):
        e.execute("INSERT INTO t VALUES (2.5, 1.25)")
        e.tick(barriers=1)
    assert _rows(teng, "m") == _rows(jeng, "m")
    assert teng.execute("SELECT * FROM m") == [(1.25, 0.625, 0.0)]


def test_f2_calls_resolve_at_create():
    """F2: a WHERE whose call has no overload fails CREATE (it used to
    create a job whose every tick raised, stopping every job); a valid
    MV created after it ticks and commits.  CAST and ``||`` go through
    the registry and run through both engines."""
    eng = Engine(PlannerConfig(**SIZES), device="cpu")
    eng.execute("CREATE TABLE t (v BIGINT, s VARCHAR)")
    eng.execute("INSERT INTO t VALUES (2, 'ab'), (1, 'cd')")
    with pytest.raises(BindError, match="no overload"):
        eng.execute("CREATE MATERIALIZED VIEW bad AS SELECT v FROM t "
                    "WHERE v || 1 = 'x'")
    with pytest.raises(BindError, match="no function"):
        eng.execute("CREATE MATERIALIZED VIEW bad AS SELECT v FROM t "
                    "WHERE date_trunc('minute', v) > 1")
    assert eng.jobs == []
    sql = ("CREATE MATERIALIZED VIEW ok AS SELECT v, s || 'q' AS sq, "
           "CAST(v AS DOUBLE PRECISION) AS f FROM t "
           "WHERE CAST(v AS BIGINT) > 1")
    eng.execute(sql)
    eng.tick(barriers=2)
    assert eng.jobs[0].committed_epoch > 0
    assert eng.execute("SELECT * FROM ok") == [(2, "abq", 2.0)]
    jeng, teng = _engines("CREATE TABLE t (v BIGINT, s VARCHAR)", sql)
    for e in (jeng, teng):
        e.execute("INSERT INTO t VALUES (2, 'ab'), (1, 'cd'), (5, '')")
        e.tick(barriers=2)
    assert _rows(teng, "ok") == _rows(jeng, "ok")


def test_f3_time_travel_query_epoch(tmp_path):
    """F3: the shape of ``tests/test_sql.py::test_time_travel_query_epoch``
    on the port (128 rows live, 64 at the first epoch, PlanError for an
    epoch not retained or without a data_dir)."""
    cfg = PlannerConfig(chunk_capacity=64, agg_table_size=256,
                        agg_emit_capacity=64, mv_table_size=256,
                        mv_ring_size=1024)
    eng = Engine(cfg, data_dir=str(tmp_path), device="cpu")
    eng.execute("""
        CREATE SOURCE t (k BIGINT) WITH (connector='datagen');
        CREATE MATERIALIZED VIEW m AS SELECT count(*) AS n FROM t;
    """)
    eng.tick(barriers=1, chunks_per_barrier=1)
    e1 = eng.jobs[0].committed_epoch
    eng.tick(barriers=1, chunks_per_barrier=1)
    assert eng.jobs[0].committed_epoch > e1
    assert eng.execute("SELECT n FROM m") == [(128,)]
    eng.execute(f"SET query_epoch = {e1}")
    assert eng.execute("SELECT n FROM m") == [(64,)]
    eng.execute("SET query_epoch = 0")
    assert eng.execute("SELECT n FROM m") == [(128,)]
    eng.execute("SET query_epoch = 12345")
    with pytest.raises(PlanError, match="not retained"):
        eng.execute("SELECT n FROM m")
    mem = Engine(cfg, device="cpu")
    mem.execute("CREATE SOURCE t (k BIGINT) WITH (connector='datagen');"
                "CREATE MATERIALIZED VIEW m AS SELECT count(*) AS n FROM t;")
    mem.execute("SET query_epoch = 1")
    with pytest.raises(PlanError, match="data_dir"):
        mem.execute("SELECT n FROM m")


@pytest.fixture(scope="module")
def engine():
    eng = Engine(PlannerConfig(**SIZES), device="cpu")
    eng.execute(SOURCES.format(rate="1000000"))
    return eng


@pytest.mark.parametrize("pattern,words", [
    ("'a_b%'", "'_' wildcards not yet supported"),
    ("channel", "requires a string literal pattern")])
def test_like_refusals(engine, pattern, words):
    with pytest.raises(BindError, match=words):
        engine.execute("CREATE MATERIALIZED VIEW r AS SELECT url FROM bid "
                       f"WHERE url LIKE {pattern};")
    assert engine.jobs == []


def _select(sql: str):
    return [s for s in parse(sql) if hasattr(s, "query")][0].query


@pytest.mark.parametrize("query", sorted(SCALAR_QUERY_SQL))
def test_scalar_queries_plan_for_cuda(engine, query):
    stmts = parse(SCALAR_QUERY_SQL[query])
    for st in stmts:
        if isinstance(st, ast.CreateFunction) \
                and st.name not in engine.functions:
            engine.execute(f"CREATE FUNCTION {st.name}(s varchar, c "
                           "varchar) RETURNS int LANGUAGE SQL AS "
                           f"$${st.body_sql}$$")
    select = inline_udfs(stmts[-1], engine.functions).query
    for dev in ("cuda", "cpu"):
        Planner(engine.catalog, engine.config, dev).plan(select)


def test_cuda_plan_refuses_a_like_past_its_program(engine):
    """K23f's LIKE program holds 16 segments: 17 plan on the CPU only."""
    pat = "%".join("ab" for _ in range(17))
    select = _select("CREATE MATERIALIZED VIEW m AS SELECT url FROM bid "
                     f"WHERE url LIKE '{pat}';")
    Planner(engine.catalog, engine.config, "cpu").plan(select)
    with pytest.raises(PlanError, match="K23f"):
        Planner(engine.catalog, engine.config, "cuda").plan(select)
