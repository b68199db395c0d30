"""Port parity: the window queries through SQL on the CPU.

``q6_bid`` (Nexmark q6's windowed average over a top-1 per auction, the
reference planner's "q6 shape") and ``ow_bid`` (per-auction window
functions over the bid stream) on ``bench.py``'s sources, and
``tests/test_sql.py::test_window_functions_over_clause``'s statements
(a datagen source), run through both ``Engine``s at chunk 256, pool
8192, emit 4096 and MV table 2^14 for 3 barriers of 2 chunks: the same
plan, MV rows and every state tensor equal; and a reference state
carried into the port mid-run continues identically.  Tolerance: none
(q6's average sums integer prices, exact in float64).
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import jax
import pytest

from bench import SOURCES
from risingwave_tpu.sql import Engine as JEngine
from risingwave_tpu.sql.planner import PlannerConfig as JConfig
from risingwave_tpu_torch.compat import state_from_numpy, state_mismatches
from risingwave_tpu_torch.sql import Engine
from risingwave_tpu_torch.sql.planner import PlannerConfig

Q6_BID = """
CREATE MATERIALIZED VIEW bench_mv AS
SELECT bidder, price, date_time,
       AVG(price) OVER (PARTITION BY bidder ORDER BY date_time
                        ROWS BETWEEN 10 PRECEDING AND CURRENT ROW) AS avg
FROM (SELECT *, ROW_NUMBER() OVER (PARTITION BY auction ORDER BY price DESC)
      AS rn FROM bid) WHERE rn <= 1;
"""
OW_BID = """
CREATE MATERIALIZED VIEW bench_mv AS
SELECT auction, bidder, price, date_time,
  row_number() OVER (PARTITION BY auction ORDER BY date_time) AS rn,
  rank() OVER (PARTITION BY auction ORDER BY date_time) AS rk,
  dense_rank() OVER (PARTITION BY auction ORDER BY date_time) AS drk,
  lag(price) OVER (PARTITION BY auction ORDER BY date_time) AS prev_price,
  lead(price) OVER (PARTITION BY auction ORDER BY date_time) AS next_price,
  max(price) OVER (PARTITION BY auction ORDER BY date_time) AS max_so_far,
  sum(price) OVER (PARTITION BY auction ORDER BY date_time) AS sum_so_far,
  count(*) OVER (PARTITION BY auction ORDER BY date_time) AS n_so_far
FROM bid;
"""
#: tests/test_sql.py::test_window_functions_over_clause's statements
SQL_WINDOW = """
CREATE SOURCE t (k BIGINT, v BIGINT) WITH (connector='datagen');
CREATE MATERIALIZED VIEW bench_mv AS
SELECT k, v,
       row_number() OVER (PARTITION BY k % 4 ORDER BY v) AS rn,
       sum(v) OVER (PARTITION BY k % 4 ORDER BY v) AS rsum
FROM t;
"""
SIZES = dict(chunk_capacity=256, topn_pool_size=8192,
             topn_emit_capacity=4096, mv_table_size=1 << 14)
QUERIES = {"q6_bid": (SOURCES.format(rate="1000000") + Q6_BID, 14),
           "ow_bid": (SOURCES.format(rate="1000000") + OW_BID, 1536),
           "sql_window": (SQL_WINDOW, 1536)}


def _engine(kind, query):
    eng = JEngine(JConfig(**SIZES)) if kind == "ref" else \
        Engine(PlannerConfig(**SIZES), device="cpu")
    eng.execute(QUERIES[query][0])
    return eng


def _mv(eng):
    return sorted(tuple(v if isinstance(v, str) else float(v) for v in r)
                  for r in eng.execute("SELECT * FROM bench_mv"))


def _assert_same_states(jeng, teng):
    jst = jax.device_get(jeng.jobs[0].states)
    tst = teng.jobs[0].states
    assert [type(s).__name__ for s in tst] == \
        [type(s).__name__ for s in jst]
    for i, st in enumerate(tst):
        if st != ():
            assert state_mismatches(jst[i], st, f"states[{i}]") == []


@pytest.mark.parametrize("query", sorted(QUERIES))
def test_engine_rows_and_state_match_reference(query):
    """3 barriers of 2 chunks: the same plan, MV rows and every state
    tensor (pools, emitted rows, MV) equal."""
    jeng, teng = _engine("ref", query), _engine("port", query)
    assert repr(teng.jobs[0].fragment) == repr(jeng.jobs[0].fragment)
    assert "OverWindowExecutor" in repr(teng.jobs[0].fragment)
    for e in (jeng, teng):
        e.tick(barriers=3, chunks_per_barrier=2)
    rows = _mv(teng)
    assert rows == _mv(jeng) and len(rows) == QUERIES[query][1]
    assert teng.query("SELECT * FROM bench_mv")[0] == \
        jeng.query("SELECT * FROM bench_mv")[0]
    _assert_same_states(jeng, teng)
    ow = next(s for ex, s in zip(teng.jobs[0].fragment.executors,
                                 teng.jobs[0].states)
              if type(ex).__name__ == "OverWindowExecutor")
    assert int(ow.overflow) == int(ow.inconsistency) == 0


def test_engine_from_carried_reference_state():
    """q6_bid's reference state (the top-1 pool, the over-window's pool
    and float64 emitted rows, the MV) carried into the port after 2
    barriers continues identically."""
    jeng, teng = _engine("ref", "q6_bid"), _engine("port", "q6_bid")
    jeng.tick(barriers=2, chunks_per_barrier=2)
    jjob, tjob = jeng.jobs[0], teng.jobs[0]
    tjob.states = state_from_numpy(jax.device_get(jjob.states))
    tjob.source.offset = jjob.source.offset
    _assert_same_states(jeng, teng)
    for e in (jeng, teng):
        e.tick(barriers=2, chunks_per_barrier=2)
    assert _mv(teng) == _mv(jeng)
    _assert_same_states(jeng, teng)
