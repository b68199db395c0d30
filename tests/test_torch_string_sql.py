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

import torch_threads  # noqa: F401  (first: sets torch threads)
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


# ---------------------------------------------------------------------------
# min/max over strings: the packed 8-byte state (min_str, max_str)

PERSON = """
CREATE SOURCE person (
    id BIGINT, name VARCHAR, city VARCHAR, state VARCHAR,
    date_time TIMESTAMP,
    WATERMARK FOR date_time AS date_time - INTERVAL '4' SECOND
) WITH (connector = 'nexmark', nexmark.table = 'person',
        nexmark.event.rate = '1000000');
"""
PERSON_STATES = """
CREATE MATERIALIZED VIEW person_states AS
SELECT city, min(state) AS lo, max(state) AS hi, count(*) AS persons
FROM person GROUP BY city;
"""


def test_person_states_through_both_engines():
    """min/max over the 4-byte ``state`` grouped by the string ``city``
    (K5's string keys): equal rows and state, the output an 8-byte
    VARCHAR."""
    engines = []
    for eng in (JEngine(JConfig(**SIZES)),
                Engine(PlannerConfig(**SIZES), device="cpu")):
        eng.execute(PERSON)
        eng.execute(PERSON_STATES)
        eng.tick(barriers=3, chunks_per_barrier=2)
        engines.append(eng)
    _assert_same(*engines)
    rows = _rows(engines[1])
    assert len(rows) == 10 and all(lo <= hi for _, lo, hi, _ in rows)
    agg = engines[1].jobs[0].fragment.executors[1]
    assert [a.kind for a in agg.aggs] == ["min_str", "max_str", "count_star"]
    assert engines[1].catalog.get("person_states").schema[1].str_width == 8


def _str8_cases():
    """(bytes [n, 8], lens): the empty string, full 8 bytes, bytes of
    0x80 and above, prefixes of each other, and bytes past the length
    that must not count (the zero tail)."""
    import numpy as np

    texts = [b"", b"A", b"AB", b"ABCDEFGH", b"\xff\x01", b"\x80",
             b"zz", b"ABCDEFGG", b"a", b"\x01"]
    data = np.full((len(texts), 8), 0x5A, np.uint8)
    lens = np.array([len(t) for t in texts], np.int32)
    for i, t in enumerate(texts):
        data[i, :len(t)] = list(t)
    return data, lens


def test_pack_str8_and_unpack_match_the_reference():
    import jax.numpy as jnp
    import numpy as np
    import torch

    from risingwave_tpu.common.chunk import StrCol as JStrCol
    from risingwave_tpu.expr import agg as jagg
    from risingwave_tpu_torch.common.chunk import StrCol
    from risingwave_tpu_torch.expr import agg as tagg

    data, lens = _str8_cases()
    jp = np.asarray(jagg._pack_str8(JStrCol(jnp.asarray(data),
                                            jnp.asarray(lens))))
    tp = tagg.pack_str8(StrCol(torch.from_numpy(data),
                               torch.from_numpy(lens)))
    assert np.array_equal(jp, tp.numpy())
    # signed order of the packed values is byte order
    order = sorted(range(len(lens)),
                   key=lambda i: bytes(data[i, :lens[i]]))
    assert list(np.argsort(jp, kind="stable")) == order
    jo = jagg._out_minmax_str((jnp.asarray(jp),), None, None)
    to = tagg._out_minmax_str((tp,), None, None)
    assert np.array_equal(np.asarray(jo.data), to.data.numpy())
    assert np.array_equal(np.asarray(jo.lens), to.lens.numpy())


def test_min_max_str_aggregation_with_nulls():
    """The executors of both packages over a nullable VARCHAR(8): groups
    with the empty string, full 8 bytes and only NULLs (a NULL result);
    equal state and flush chunks."""
    import numpy as np

    from risingwave_tpu.common.chunk import Chunk as JChunk
    from risingwave_tpu.common.types import (
        DataType as JDT,
        Field as JField,
        Schema as JSchema,
    )
    from risingwave_tpu.expr.agg import AggCall as JAggCall
    from risingwave_tpu.expr.node import InputRef as JRef
    from risingwave_tpu.stream.hash_agg import HashAggExecutor as JAgg
    from risingwave_tpu_torch.common.chunk import Chunk
    from risingwave_tpu_torch.common.types import DataType, Field, Schema
    from risingwave_tpu_torch.expr.agg import AggCall
    from risingwave_tpu_torch.expr.node import InputRef
    from risingwave_tpu_torch.stream.hash_agg import HashAggExecutor

    js = JSchema((JField("k", JDT.INT64),
                  JField("s", JDT.VARCHAR, str_width=8, nullable=True)))
    ts = Schema((Field("k", DataType.INT64),
                 Field("s", DataType.VARCHAR, str_width=8, nullable=True)))
    kw = dict(table_size=16, emit_capacity=8)
    j = JAgg(js, [("k", JRef(0))], [JAggCall("min_str", JRef(1)),
                                    JAggCall("max_str", JRef(1))], **kw)
    t = HashAggExecutor(ts, [("k", InputRef(0))],
                        [AggCall("min_str", InputRef(1)),
                         AggCall("max_str", InputRef(1))], **kw)
    rows = [(0, ""), (0, "ABCDEFGH"), (0, None), (1, None), (1, None),
            (2, "zz"), (2, "a"), (3, "ABCDEFGG"), (3, "ABCDEFGH")]
    arrays = [np.array([r[0] for r in rows], np.int64),
              np.array([r[1] for r in rows], object)]
    ops = np.zeros(len(rows), np.int8)
    jc = JChunk.from_numpy(js, arrays, ops=ops, capacity=16)
    tc = Chunk.from_numpy(ts, arrays, ops=ops, capacity=16)
    jst, tst = j.init_state(), t.init_state("cpu")
    jst, _ = j.apply(jst, jc)
    tst, _ = t.apply(tst, tc)
    assert state_mismatches(jax.device_get(jst), tst) == []
    jst, jout = j.flush(jst, 1)
    tst, tout = t.flush(tst, 1)
    assert state_mismatches(jax.device_get(jst), tst) == []
    assert np.array_equal(np.asarray(jout.valid), tout.valid.numpy())
    for jcol, tcol in zip(jout.columns, tout.columns):
        for a, b in zip(jax.tree_util.tree_leaves(jcol),
                        jax.tree_util.tree_leaves(tuple(tcol))
                        if isinstance(tcol, tuple) else [tcol]):
            assert np.array_equal(np.asarray(a), b.numpy())
    assert t.out_schema[1].str_width == 8


#: min/max over strings the packed state cannot hold: the reference's words
STR_REFUSED = {
    "wider_than_8": ("SELECT id, min(city) AS c FROM person GROUP BY id",
                     "min over strings wider than 8 device bytes: next "
                     "round"),
    "retractable": ("SELECT g, max(s) AS m FROM rt GROUP BY g",
                    "max over strings on a retractable input: next round"),
}


@pytest.mark.parametrize("case", sorted(STR_REFUSED))
def test_min_max_str_refusals_are_the_reference_words(case):
    import re

    from risingwave_tpu.sql.planner import PlanError as JPlanError

    sql, words = STR_REFUSED[case]
    for eng, err in ((JEngine(JConfig(**SIZES)), JPlanError),
                     (Engine(PlannerConfig(**SIZES), device="cpu"),
                      PlanError)):
        eng.execute(PERSON)
        eng.execute("CREATE TABLE rt (id BIGINT, g BIGINT, s VARCHAR(8), "
                    "PRIMARY KEY (id)) WITH (retract = 'true');")
        with pytest.raises(err, match=re.escape(words)):
            eng.execute(f"CREATE MATERIALIZED VIEW m AS {sql};")
