"""Port parity: string and calendar expressions through SQL — Nexmark
q22 (``SPLIT_PART``), q10 (``TO_CHAR``) and q21 (CASE over
``lower(channel)``, the ``regexp_match`` capture in the SELECT and the
WHERE, ``IN`` rewritten into ORs), their text as RisingWave publishes
them (``chip_smoke.STRING_QUERY_SQL``).

Each query runs through the reference engine and the port's engine
(``device="cpu"``: the K23 kernels' plain versions) on bench.py's
sources, chunk 256, a ring of 2^12.  After every barrier the MV rows and
every state tensor (the ring's value leaves with their zero tails and
null plane, its cursor and lap counter) must be equal, and the MV's
field widths must be the reference's.  Aggregations grouped by
``to_char`` and by captures (a NULL group included), filtered by string
comparisons over ``upper`` and ``split_part`` and by ``coalesce``, check
the planner's walks under ``ToChar`` and ``RegexpGroup``.  Calls with no
overload (``replace``, ``substr`` and ``concat`` over the wrong types),
LIKE's ``_`` wildcard, ``split_part(.., 0)``, a bare ``regexp_match`` and
patterns outside the family raise ``BindError``; the queries plan for
CUDA.
Tolerance: none — the path is byte and integer arithmetic.
"""

import jax
import pytest

from bench import SOURCES
from chip_smoke import STRING_QUERY_SQL
from risingwave_tpu.sql import Engine as JEngine
from risingwave_tpu.sql.planner import PlannerConfig as JConfig
from risingwave_tpu_torch.compat import state_mismatches
from risingwave_tpu_torch.sql import Engine
from risingwave_tpu_torch.sql.binder import BindError
from risingwave_tpu_torch.sql.parser import parse
from risingwave_tpu_torch.sql.planner import PlanError, Planner, \
    PlannerConfig
from risingwave_tpu_torch.stream.materialize import AppendOnlyMaterialize

SIZES = dict(chunk_capacity=256, agg_table_size=1 << 10,
             agg_emit_capacity=256, mv_table_size=1 << 12,
             mv_ring_size=1 << 12)
#: aggregations over string expressions (group keys of K23's outputs)
GROUPED = {
    "to_char": """
CREATE MATERIALIZED VIEW g AS
SELECT to_char(date_time, 'HH24:MI:SS.MS') AS t, count(*) AS n,
       max(price) AS p
FROM bid GROUP BY to_char(date_time, 'HH24:MI:SS.MS');
""",
    "capture": """
CREATE MATERIALIZED VIEW g AS
SELECT (regexp_match(url, 'nexmark.io/([^/]*)'))[2] AS c,
       (regexp_match(url, '(&|^)nexmark.io/([^/]*)'))[2] AS d,
       count(*) AS n
FROM bid
WHERE upper(channel) >= 'BAIDU' AND split_part(url, '/', 5) = 'item'
  AND coalesce((regexp_match(url, 'page1([^/]*)'))[2], 'none') <> '7'
GROUP BY (regexp_match(url, 'nexmark.io/([^/]*)'))[2],
         (regexp_match(url, '(&|^)nexmark.io/([^/]*)'))[2];
""",
}


def _engines(sql: str, rate: str = "1000000"):
    out = []
    for eng in (JEngine(JConfig(**SIZES)),
                Engine(PlannerConfig(**SIZES), device="cpu")):
        eng.execute(SOURCES.format(rate=rate))
        eng.execute(sql)
        out.append(eng)
    return out


def _rows(engine):
    name = engine.jobs[0].name
    return sorted(engine.execute(f"SELECT * FROM {name}"), key=repr)


def _assert_same(jeng, teng):
    assert _rows(teng) == _rows(jeng)
    assert state_mismatches(jax.device_get(jeng.jobs[0].states),
                            teng.jobs[0].states) == []


@pytest.mark.parametrize("query", sorted(STRING_QUERY_SQL))
def test_string_query_rows_and_ring_state(query):
    jeng, teng = _engines(STRING_QUERY_SQL[query])
    jmv, tmv = (e.jobs[0].fragment.executors[-1] for e in (jeng, teng))
    assert isinstance(tmv, AppendOnlyMaterialize)
    assert [(f.name, f.data_type.name, f.str_width, f.nullable)
            for f in tmv.in_schema] == \
        [(f.name, f.data_type.name, f.str_width, f.nullable)
         for f in jmv.in_schema]
    for _ in range(3):
        for e in (jeng, teng):
            e.tick(barriers=1, chunks_per_barrier=2)
        _assert_same(jeng, teng)
    rows = _rows(teng)
    assert len(rows) == 3 * 2 * SIZES["chunk_capacity"]
    expect = {"q22": ("page", "item", ""), "q10": ("2015-07-15", "12:00"),
              "q21": ("0", "1", "2", "3")}[query]
    seen = {v for r in rows for v in r if isinstance(v, str)}
    assert all(any(s.startswith(e) for s in seen) for e in expect)


@pytest.mark.parametrize("case", sorted(GROUPED))
def test_group_by_string_expressions(case):
    jeng, teng = _engines(GROUPED[case], rate="10000")
    for _ in range(2):
        for e in (jeng, teng):
            e.tick(barriers=1, chunks_per_barrier=2)
        _assert_same(jeng, teng)
    assert len(_rows(teng)) > 1


REFUSED = {
    "split_part_zero": "SELECT split_part(url, '/', 0) AS p FROM bid",
    "bare_regexp_match": "SELECT regexp_match(url, 'a([^b]*)') AS m "
                         "FROM bid",
    "pattern_outside_family": "SELECT (regexp_match(url, 'a+([^b]*)'))[2] "
                              "AS m FROM bid",
    "capture_group_1": "SELECT (regexp_match(url, 'a([^b]*)'))[1] AS m "
                       "FROM bid",
    "subscript_not_regexp": "SELECT (lower(url))[1] AS m FROM bid",
    "to_char_non_literal_format": "SELECT to_char(date_time, channel) AS t "
                                  "FROM bid",
    "replace": "SELECT replace(url, 1, 2) AS u FROM bid",
    "substr": "SELECT substr(url) AS u FROM bid",
    "concat": "SELECT concat(url, price) AS u FROM bid",
    "like": "SELECT url FROM bid WHERE url LIKE 'a_b%'",
}


@pytest.fixture(scope="module")
def engine():
    eng = Engine(PlannerConfig(**SIZES), device="cpu")
    eng.execute(SOURCES.format(rate="1000000"))
    return eng


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_unported_and_invalid_string_functions_raise(engine, case):
    with pytest.raises(BindError):
        engine.execute(f"CREATE MATERIALIZED VIEW r AS {REFUSED[case]};")
    assert engine.jobs == []


def _select(sql: str):
    return parse(sql)[0].query


@pytest.mark.parametrize("query", sorted(STRING_QUERY_SQL))
def test_string_queries_plan_for_cuda(engine, query):
    select = _select(STRING_QUERY_SQL[query])
    for dev in ("cuda", "cpu"):
        Planner(engine.catalog, engine.config, dev).plan(select)


def test_cuda_plan_refuses_a_ring_past_its_leaves(engine):
    """K8-ring moves 16 value leaves: q22 writes 11, nine strings 18."""
    items = ", ".join(f"split_part(url, '/', {k}) AS d{k}"
                      for k in range(1, 10))
    select = _select(f"CREATE MATERIALIZED VIEW m AS SELECT {items} "
                     "FROM bid;")
    Planner(engine.catalog, engine.config, "cpu").plan(select)
    with pytest.raises(PlanError, match="K8-ring"):
        Planner(engine.catalog, engine.config, "cuda").plan(select)
