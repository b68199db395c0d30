"""Port parity: CREATE SINK, MV-on-MV cascades, SHOW and DROP through SQL.

The same statements run through the reference's ``Engine`` and the
port's (``device="cpu"``, K22b's and every other kernel's plain
version):

- the scenarios of ``tests/test_sql.py::test_create_sink_file_and_blackhole``
  and ``::test_engine_show_and_drop``;
- a cascade created on a non-empty MV: bench's q5, then after 3 barriers
  ``q5_hot`` (``bids >= T``, its backfill replays q5's table) and a file
  sink FROM it, 3 more barriers; the MVs' rows and the sink file's data
  lines must be equal in order, the commit records equal in count and
  position (their epochs are wall-clock values);
- DROP of an MV that a cascade consumes, with the same error, and the
  drops of the cascade that leave the upstream running.

The durable side (cold starts, exactly once) is in
``tests/test_torch_sink_cold_start.py``.  Tolerance: none (integer
columns, and the sink's values as the reference's JSON prints them).
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import json

import pytest

from bench import QUERIES, SOURCES
from risingwave_tpu.sql import Engine as JEngine
from risingwave_tpu.sql.planner import PlannerConfig as JConfig
from risingwave_tpu_torch.sql import Engine
from risingwave_tpu_torch.sql.planner import PlannerConfig

SMALL = dict(chunk_capacity=64, agg_table_size=1 << 10,
             agg_emit_capacity=256, mv_table_size=1 << 10,
             mv_ring_size=1 << 12, topn_pool_size=512,
             topn_emit_capacity=128, join_table_size=1 << 12,
             join_bucket_cap=1024, join_out_capacity=1 << 12)
NEXMARK_DDL = """
CREATE SOURCE bid (
    auction BIGINT, bidder BIGINT, price BIGINT,
    channel VARCHAR, url VARCHAR, date_time TIMESTAMP
) WITH (connector = 'nexmark', nexmark.table = 'bid',
        nexmark.event.rate = '100000');
"""


def _engines(cfg=SMALL):
    return JEngine(JConfig(**cfg)), Engine(PlannerConfig(**cfg), device="cpu")


def _lines(path) -> list[dict]:
    with open(path) as f:
        return [json.loads(x) for x in f]


def _split(lines):
    """(data lines, positions of the commit records)."""
    data = [x for x in lines if x["op"] != "commit"]
    commits = [i for i, x in enumerate(lines) if x["op"] == "commit"]
    return data, commits


def _both(engines, sql):
    return [e.execute(sql) for e in engines]


def test_create_sink_file_and_blackhole(tmp_path):
    engines = _engines(dict(SMALL, chunk_capacity=64))
    files = []
    for tag, eng in zip(("ref", "port"), engines):
        path = str(tmp_path / f"{tag}.jsonl")
        files.append(path)
        eng.execute("CREATE SOURCE t (k BIGINT, v BIGINT) "
                    "WITH (connector='datagen');")
        eng.execute(f"""
            CREATE SINK f AS SELECT k, v FROM t WHERE k < 5
            WITH (connector = 'file', path = '{path}');
            CREATE SINK b AS
            SELECT k % 2 AS g, count(*) AS n FROM t GROUP BY k % 2
            WITH (connector = 'blackhole');
        """)
        assert eng.execute("SHOW SINKS") == [("f",), ("b",)]
        eng.tick(barriers=2, chunks_per_barrier=1)
    (jdata, jcommits), (data, commits) = (_split(_lines(p)) for p in files)
    assert data == jdata
    assert [(r["k"], r["v"]) for r in data] == [(i, i) for i in range(5)]
    assert commits == jcommits and len(commits) == 2
    jbh, bh = (e.catalog.get("b").mv_executor.sink for e in engines)
    assert bh.rows_written == jbh.rows_written > 0
    assert bh.commits == jbh.commits == 2
    assert _both(engines, "DROP SINK f") == [None, None]
    assert _both(engines, "SHOW SINKS") == [[("b",)]] * 2
    assert engines[1].catalog.get("b").job in engines[1].jobs
    assert len(engines[1].jobs) == len(engines[0].jobs) == 1


def test_engine_show_and_drop():
    engines = _engines(dict(SMALL, chunk_capacity=512))
    for eng in engines:
        eng.execute(NEXMARK_DDL)
    assert _both(engines, "SHOW SOURCES") == [[("bid",)]] * 2
    assert _both(engines, "SHOW TABLES") == [[("bid",)]] * 2
    _both(engines, "CREATE MATERIALIZED VIEW v AS SELECT auction FROM bid")
    assert _both(engines, "SHOW MATERIALIZED VIEWS") == [[("v",)]] * 2
    for stmt in ("DROP SINK v", "DROP SOURCE v", "DROP INDEX v"):
        errs = []
        for eng in engines:
            with pytest.raises(ValueError) as e:
                eng.execute(stmt)
            errs.append(str(e.value))
        assert errs[0] == errs[1]
    _both(engines, "DROP MATERIALIZED VIEW v")
    assert _both(engines, "SHOW MATERIALIZED VIEWS") == [[]] * 2
    assert [len(e.jobs) for e in engines] == [0, 0]
    _both(engines, "DROP MATERIALIZED VIEW IF EXISTS v")
    for eng in engines:
        with pytest.raises(KeyError):
            eng.execute("DROP MATERIALIZED VIEW v")


def test_q5_cascade_and_file_sink(tmp_path):
    """bench's q5, then a filtered cascade over its non-empty table and a
    file sink over the cascade, then the drops."""
    engines = _engines(dict(SMALL, chunk_capacity=128))
    for eng in engines:
        eng.execute(SOURCES.format(rate="10000"))
        eng.execute(QUERIES["q5"].replace("bench_mv", "q5"))
        eng.tick(barriers=3, chunks_per_barrier=2)
    ref_q5 = sorted(engines[0].execute("SELECT * FROM q5"))
    assert sorted(engines[1].execute("SELECT * FROM q5")) == ref_q5
    counts = [int(r[2]) for r in ref_q5]
    # the least T that keeps at most half of q5's rows
    t = min(v for v in set(counts)
            if 0 < sum(c >= v for c in counts) <= len(counts) // 2)
    files = []
    for tag, eng in zip(("ref", "port"), engines):
        path = str(tmp_path / f"{tag}.jsonl")
        files.append(path)
        eng.execute(f"""
            CREATE MATERIALIZED VIEW q5_hot AS
            SELECT auction, window_start, bids FROM q5 WHERE bids >= {t};
            CREATE SINK q5_hot_sink FROM q5_hot
            WITH (connector = 'file', path = '{path}');
        """)
    port = engines[1]
    assert len(port.jobs) == 1
    assert [e.dag_nodes for e in port.catalog.list()
            if e.kind != "source"] == [[0], [1], [2]]
    for eng in engines:
        eng.tick(barriers=3, chunks_per_barrier=2)
    rows = [[sorted(e.execute(f"SELECT * FROM {mv}")) for e in engines]
            for mv in ("q5", "q5_hot")]
    for ref, got in rows:
        assert got == ref
    hot = rows[1][1]
    assert 0 < len(hot) < len(rows[0][1])
    assert hot == sorted(r for r in rows[0][1] if r[2] >= t)
    (jdata, jcommits), (data, commits) = (_split(_lines(p)) for p in files)
    assert data == jdata and commits == jcommits
    assert len(commits) == 3
    # the reader's fold of the file equals the cascade
    seen = {}
    for rec in data:
        key = (rec["auction"], rec["window_start"])
        if rec["op"] in ("insert", "update_insert"):
            seen[key] = rec["bids"]
        else:
            seen.pop(key, None)
    assert sorted((a, w, b) for (a, w), b in seen.items()) == \
        [tuple(int(x) for x in r) for r in hot]
    # the upstream cannot go while the cascade consumes it
    errs = []
    for eng in engines:
        with pytest.raises(ValueError) as e:
            eng.execute("DROP MATERIALIZED VIEW q5")
        errs.append(str(e.value))
    assert errs[0] == errs[1] == \
        "node 0 still feeds node 1 (drop dependents first)"
    _both(engines, "DROP SINK q5_hot_sink")
    _both(engines, "DROP MATERIALIZED VIEW q5_hot")
    assert _both(engines, "SHOW MATERIALIZED VIEWS") == [[("q5",)]] * 2
    assert port.jobs[0].nodes[1:] == [None, None]
    for eng in engines:
        eng.tick(barriers=1, chunks_per_barrier=2)
    assert sorted(port.execute("SELECT * FROM q5")) == \
        sorted(engines[0].execute("SELECT * FROM q5"))


def test_join_of_two_mvs_merges_their_jobs():
    """A plan tapping MVs of two jobs merges them into one ``DagJob``
    (``_merge_dag_jobs``): both inputs backfill from their MVs, and later
    changes reach the join from both sides."""
    eng = Engine(PlannerConfig(**dict(
        SMALL, agg_table_size=256, mv_table_size=256, join_table_size=256,
        join_bucket_cap=16)), device="cpu")
    eng.execute("CREATE TABLE t (k BIGINT, v BIGINT)")
    eng.execute("INSERT INTO t VALUES (1, 10), (1, 11), (2, 20), (3, 30)")
    eng.execute("CREATE MATERIALIZED VIEW a AS SELECT k, count(*) AS n "
                "FROM t GROUP BY k")
    eng.execute("CREATE MATERIALIZED VIEW b AS SELECT k, sum(v) AS s "
                "FROM t GROUP BY k")
    eng.execute("FLUSH")
    assert len(eng.jobs) == 2
    eng.execute("CREATE MATERIALIZED VIEW j AS SELECT a.k, a.n, b.s "
                "FROM a JOIN b ON a.k = b.k")
    assert len(eng.jobs) == 1
    job = eng.jobs[0]
    assert sorted(job.sources) == ["_src_a", "_src_b"]
    # j adds the join (node 2) and its projection and MV (node 3)
    assert [eng.catalog.get(m).mv_state_index[0] for m in "abj"] == [0, 1, 3]
    assert sorted(eng.execute("SELECT * FROM j")) == [(1, 2, 21), (2, 1, 20),
                                                      (3, 1, 30)]
    eng.execute("INSERT INTO t VALUES (2, 5), (4, 40)")
    eng.execute("FLUSH")
    assert sorted(eng.execute("SELECT * FROM j")) == [
        (1, 2, 21), (2, 2, 25), (3, 1, 30), (4, 1, 40)]
