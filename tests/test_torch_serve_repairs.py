"""Repairs of two faults found in the port against the reference.

- F4: ``_serve_batch``'s global aggregates over one MV answer as the
  reference's batch plan does: no row over an empty MV, numpy-typed
  values (a count is an int64, an integer sum widens to int64), and
  min/max over a string wider than 8 device bytes refused in the
  reference's words.  Typed rows of both engines are compared over an
  empty MV and a non-empty one.
- F5: a top-N, a row_number top-N or an over-window whose pool would hold
  a nullable column is refused at CREATE with a ``PlanError`` (it used to
  pass CREATE and raise at every tick; the reference cannot run it
  either).  The same views over an all-NOT-NULL table run and equal the
  reference's.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import pytest

from risingwave_tpu.sql import Engine as JEngine
from risingwave_tpu.sql.planner import PlanError as JPlanError
from risingwave_tpu.sql.planner import PlannerConfig as JConfig
from risingwave_tpu_torch.sql import Engine
from risingwave_tpu_torch.sql.planner import PlanError, PlannerConfig

SIZES = dict(chunk_capacity=64, mv_table_size=1 << 10, topn_pool_size=256,
             topn_emit_capacity=64)


def _typed(rows):
    """Rows as sorted tuples of (type name, value)."""
    return sorted((tuple((type(v).__name__, v) for v in r) for r in rows),
                  key=repr)


def _engines(ddl):
    out = []
    for eng in (JEngine(JConfig(**SIZES)),
                Engine(PlannerConfig(**SIZES), device="cpu")):
        for sql in ddl:
            eng.execute(sql)
        out.append(eng)
    return out


SERVE_READS = [
    "SELECT count(*) FROM m",
    "SELECT sum(b) FROM m",
    "SELECT count(*), count(b), sum(b), min(b), max(b), sum(a), min(a), "
    "max(a), sum(c), min(c), sum(d), min(d), count(d), min(ts), max(ts), "
    "sum(r), min(r) FROM m",
]


def test_serve_batch_typed_rows_match_reference():
    engines = _engines([
        "CREATE TABLE t (a INT, b BIGINT NULL, c SMALLINT, d DOUBLE "
        "PRECISION NULL, ts TIMESTAMP, r REAL, s VARCHAR)",
        "CREATE MATERIALIZED VIEW m AS SELECT a, b, c, d, ts, r, s FROM t"])
    for e in engines:
        e.tick(barriers=1)
    # an empty MV: no row, as the reference's simple aggregation
    for q in SERVE_READS:
        assert [_typed(e.execute(q)) for e in engines] == [[], []], q
    for e in engines:
        e.execute("INSERT INTO t VALUES "
                  "(1, NULL, 3, NULL, '2020-01-01 00:00:00', 1.5, 'x'), "
                  "(3, NULL, 5, NULL, '2020-01-02 00:00:00', 2.5, 'z'), "
                  "(7, 9, -2, 0.25, '2020-01-03 00:00:00', -1.0, 'y')")
        e.tick(barriers=2)
    # the wide read covers the two narrow ones
    jrows, trows = (_typed(e.execute(SERVE_READS[-1])) for e in engines)
    assert trows == jrows and len(trows) == 1
    assert _typed(engines[1].execute("SELECT count(*) FROM m")) == \
        [(("int64", 3),)]
    # min/max over a string wider than 8 device bytes: refused alike
    words = []
    for e, err in zip(engines, (JPlanError, PlanError)):
        with pytest.raises(err) as ex:
            e.execute("SELECT min(s), max(s) FROM m")
        words.append(str(ex.value))
    assert words[1] == words[0] == \
        "min over strings wider than 8 device bytes: next round"


F5_VIEWS = {
    "top_n": "SELECT a, b FROM t ORDER BY a DESC LIMIT 2",
    # partitioned and ordered by the NOT NULL column: the pool still
    # holds b
    "row_number": ("SELECT a, b FROM (SELECT a, b, row_number() OVER "
                   "(PARTITION BY a ORDER BY a DESC) AS rn FROM t) "
                   "WHERE rn <= 1"),
    "over_window": ("SELECT a, b, lag(a) OVER (PARTITION BY a ORDER BY a) "
                    "AS prev FROM t"),
}


@pytest.mark.parametrize("view", sorted(F5_VIEWS))
def test_nullable_pool_refused_at_create(view):
    eng = Engine(PlannerConfig(**SIZES), device="cpu")
    eng.execute("CREATE TABLE t (a BIGINT, b BIGINT NULL)")
    with pytest.raises(PlanError, match="nullable column"):
        eng.execute(f"CREATE MATERIALIZED VIEW v AS {F5_VIEWS[view]}")
    assert "v" not in eng.catalog and eng.jobs == []


def test_not_null_pools_run_and_match_reference():
    engines = _engines(["CREATE TABLE t (a BIGINT, b BIGINT)"] + [
        f"CREATE MATERIALIZED VIEW v_{name} AS {sql}"
        for name, sql in sorted(F5_VIEWS.items())])
    for e in engines:
        e.execute("INSERT INTO t VALUES " + ",".join(
            f"({i}, {i % 3})" for i in range(12)))
        e.tick(barriers=2)
    for name in sorted(F5_VIEWS):
        jrows, trows = (sorted(tuple(int(x) if x is not None else None
                                     for x in r)
                               for r in e.execute(f"SELECT * FROM v_{name}"))
                        for e in engines)
        assert trows == jrows and trows, name
