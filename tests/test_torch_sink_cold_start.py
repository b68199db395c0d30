"""Port parity: sinks and cascades across a process death.

- ``tests/test_cold_start.py::test_cold_start_recovery``'s scenario
  (table -> MV -> cascaded MV -> file sink, a process death with no
  clean stop, a cold start from the data directory, more rows) through
  the reference's and the port's ``Engine`` (``device="cpu"``): the
  same catalog and MV rows after the restart, the same sink file (data
  lines in order, commit records by count and position: their epochs
  are wall-clock values), every row delivered exactly once;
- the port alone: a DROP followed by a cold start (the DDL log replays
  the drop, so the job's node list, and the last checkpoint's tree,
  match), and a durable barrier that changes no state (a delta
  checkpoint without a dirty block, which failed to upload before).

Tolerance: none (integer columns).
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import json

from risingwave_tpu.sql import Engine as JEngine
from risingwave_tpu.sql.planner import PlannerConfig as JConfig
from risingwave_tpu_torch.sql import Engine
from risingwave_tpu_torch.sql.planner import PlannerConfig

COLD = dict(chunk_capacity=128, agg_table_size=512, agg_emit_capacity=256,
            mv_table_size=1 << 10, mv_ring_size=1 << 11,
            join_table_size=1 << 10, join_bucket_cap=32,
            join_out_capacity=1 << 11)


def _engines(data_dirs):
    return (JEngine(JConfig(**COLD), data_dir=data_dirs[0]),
            Engine(PlannerConfig(**COLD), data_dir=data_dirs[1],
                   device="cpu"))


def _lines(path) -> list[dict]:
    with open(path) as f:
        return [json.loads(x) for x in f]


def _split(lines):
    """(data lines, positions of the commit records)."""
    data = [x for x in lines if x["op"] != "commit"]
    commits = [i for i, x in enumerate(lines) if x["op"] == "commit"]
    return data, commits


def test_cold_start_recovery_exactly_once(tmp_path):
    """``tests/test_cold_start.py``'s scenario through both engines."""
    dirs = (str(tmp_path / "ref"), str(tmp_path / "port"))
    sinks = [str(tmp_path / f"{t}.jsonl") for t in ("ref", "port")]
    engines = _engines(dirs)
    rows1 = [(k, 10 * k + r) for k in range(40) for r in range(2)]
    rows2 = [(k, 1000 + k) for k in range(40)]

    def insert(eng, rows):
        eng.execute("INSERT INTO t VALUES "
                    + ",".join(f"({a},{b})" for a, b in rows))

    for eng, path in zip(engines, sinks):
        eng.execute("CREATE TABLE t (k BIGINT, v BIGINT)")
        insert(eng, rows1)
        eng.execute("CREATE MATERIALIZED VIEW mv AS "
                    "SELECT k, count(*) AS n, sum(v) AS s FROM t GROUP BY k")
        eng.execute("CREATE MATERIALIZED VIEW mv2 AS "
                    "SELECT k, s FROM mv WHERE s > 100")
        eng.execute(f"CREATE SINK snk FROM mv2 WITH "
                    f"(connector='file', path='{path}')")
        eng.execute("FLUSH")
    want = [[sorted(e.execute(f"SELECT * FROM {mv}")) for e in engines]
            for mv in ("mv", "mv2")]
    assert all(a == b for a, b in want)
    before = [_lines(p) for p in sinks]
    assert _split(before[1]) == _split(before[0]) and _split(before[1])[0]
    del engines, eng
    restarted = _engines(dirs)
    for eng in restarted:
        assert sorted(e.name for e in eng.catalog.list()) == \
            ["mv", "mv2", "snk", "t"]
    for (ref, _), mv in zip(want, ("mv", "mv2")):
        assert [sorted(e.execute(f"SELECT * FROM {mv}"))
                for e in restarted] == [ref, ref]
    for eng in restarted:
        insert(eng, rows2)
        eng.execute("FLUSH")
    after = [_lines(p) for p in sinks]
    assert _split(after[1]) == _split(after[0])
    new = after[1][len(before[1]):]
    assert [x for x in new if x["op"] != "commit"], "no delivery"
    final = {int(r[0]): int(r[1]) for r in restarted[1].execute(
        "SELECT * FROM mv2")}
    seen: dict[int, int] = {}
    for rec in after[1]:
        if rec["op"] in ("insert", "update_insert"):
            seen[int(rec["k"])] = int(rec["s"])
        elif rec["op"] == "delete":
            seen.pop(int(rec["k"]), None)
    assert seen == final


def test_drop_then_cold_start(tmp_path):
    """DROP is logged: the cold start replays it and rebuilds the same
    node order, so the last checkpoint (taken after the drop) fits."""
    data = str(tmp_path / "data")
    cfg = PlannerConfig(**COLD)
    eng = Engine(cfg, data_dir=data, device="cpu")
    eng.execute("CREATE TABLE t (k BIGINT, v BIGINT)")
    eng.execute("INSERT INTO t VALUES (1, 10), (2, 20), (3, 300)")
    eng.execute("CREATE MATERIALIZED VIEW mv AS "
                "SELECT k, sum(v) AS s FROM t GROUP BY k")
    eng.execute("CREATE SINK snk AS SELECT k, s FROM mv WHERE s > 0 "
                "WITH (connector='blackhole')")
    eng.execute("CREATE MATERIALIZED VIEW mv2 AS SELECT k, s FROM mv "
                "WHERE s > 15")
    eng.execute("FLUSH")
    eng.execute("DROP SINK snk")
    eng.execute("INSERT INTO t VALUES (4, 40)")
    eng.execute("FLUSH")
    want = [sorted(eng.execute(f"SELECT * FROM {m}")) for m in ("mv", "mv2")]
    assert eng.jobs[0].nodes[1] is None
    del eng
    eng = Engine(cfg, data_dir=data, device="cpu")
    assert sorted(e.name for e in eng.catalog.list()) == ["mv", "mv2", "t"]
    assert eng.jobs[0].nodes[1] is None
    assert [sorted(eng.execute(f"SELECT * FROM {m}"))
            for m in ("mv", "mv2")] == want
    eng.execute("INSERT INTO t VALUES (1, 1)")
    eng.execute("FLUSH")
    assert sorted(eng.execute("SELECT * FROM mv2")) == [(2, 20), (3, 300),
                                                        (4, 40)]


def test_durable_barrier_without_state_change(tmp_path):
    """A snapshot whose state equals the last one is a delta of no dirty
    block: it uploads (it raised in ``gather_plan`` before) and a cold
    start loads it."""
    data = str(tmp_path / "data")
    cfg = PlannerConfig(**COLD)
    eng = Engine(cfg, data_dir=data, device="cpu")
    eng.execute("CREATE TABLE t (k BIGINT, v BIGINT)")
    eng.execute("CREATE MATERIALIZED VIEW mv AS SELECT k, count(*) AS n "
                "FROM t GROUP BY k")
    eng.execute("INSERT INTO t VALUES (1, 2), (3, 4)")
    eng.execute("FLUSH")
    eng.tick(barriers=3, chunks_per_barrier=1)
    job = eng.jobs[0]
    store = eng.checkpoint_store
    assert store.checkpoint_kind(job.name, job.committed_epoch) == "delta"
    want = sorted(eng.execute("SELECT * FROM mv"))
    del eng
    eng = Engine(cfg, data_dir=data, device="cpu")
    assert sorted(eng.execute("SELECT * FROM mv")) == want == [(1, 1),
                                                               (3, 1)]
