"""Port parity: tables, DML and the temporal join through SQL.

- Nexmark q13 as RisingWave publishes it (``bid JOIN side_input FOR
  SYSTEM_TIME AS OF PROCTIME()``), with ``%`` for ``mod`` (the
  reference's registry has no ``mod``; the two agree on Nexmark's
  non-negative ids) and 500 keys in a 2^10-slot build table, inner, and
  as a LEFT JOIN over a ``retract = 'true'`` table that takes UPDATEs
  and full-row DELETEs between barriers.  Both engines run durably: the
  MV rows and every state tensor must be equal after every barrier, the
  stores must hold the same manifests and payload arrays, and a cold
  start of the port from its directory (the DDL log and the DML
  journal) must go on equal to the reference.
- The DML statements on their own: CREATE TABLE, INSERT (column lists,
  NULLs, casts), UPDATE, DELETE, FLUSH, an MV over a retractable table
  and an aggregation over it, with the reference's refusals.
- A build table of 16 slots, full, under probes of absent keys: the
  probe-bound overflow counts on both sides, and the idle table reader
  the port does not pull leaves the state equal to the reference's,
  which pulls its empty chunks.
- ``tests/slt/temporal_join.slt`` and ``nexmark_q7.slt`` through the
  port's copy of the slt runner at ``tests/test_slt.py``'s sizes.

Sizes are ``tests/test_slt.py``'s (chunk 256, tables 2^10).  Tolerance:
none — the paths are integer and byte for byte.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import json
import os

import jax
import numpy as np
import pytest

from risingwave_tpu.sql import Engine as JEngine
from risingwave_tpu.sql.planner import PlannerConfig as JConfig
from risingwave_tpu_torch.compat import state_mismatches
from risingwave_tpu_torch.slt import run_slt
from risingwave_tpu_torch.sql import Engine
from risingwave_tpu_torch.sql.planner import PlannerConfig
from risingwave_tpu_torch.stream.dag import TemporalJoinNode
from risingwave_tpu_torch.stream.temporal_join import TjState

SLT_DIR = os.path.join(os.path.dirname(__file__), "slt")
#: tests/test_slt.py's sizes
SIZES = dict(chunk_capacity=256, agg_table_size=1 << 10,
             agg_emit_capacity=256, mv_table_size=1 << 10,
             mv_ring_size=1 << 13, join_table_size=1 << 10,
             join_bucket_cap=1024, join_out_capacity=1 << 14)
KEYS = 500
BID = """
CREATE SOURCE bid (
    auction BIGINT, bidder BIGINT, price BIGINT,
    channel VARCHAR, url VARCHAR, date_time TIMESTAMP
) WITH (connector = 'nexmark', nexmark.table = 'bid',
        nexmark.event.rate = '100000');
"""
#: RisingWave's Nexmark q13, `%` for `mod`
Q13 = """
CREATE MATERIALIZED VIEW nexmark_q13 AS
SELECT B.auction, B.bidder, B.price, B.date_time, S.value
FROM bid B
{join} side_input FOR SYSTEM_TIME AS OF PROCTIME() S
ON B.auction % {keys} = S.key;
"""
MV = "nexmark_q13"


def _side_input(retract: bool, n: int = KEYS) -> list[str]:
    with_ = " WITH (retract = 'true')" if retract else ""
    rows = ", ".join(f"({k}, '{k}')" for k in range(n))
    return [f"CREATE TABLE side_input (key BIGINT PRIMARY KEY, "
            f"value VARCHAR){with_}",
            f"INSERT INTO side_input VALUES {rows}"]


def _rows(engine, mv=MV):
    return sorted(engine.execute(f"SELECT * FROM {mv}"), key=repr)


def _assert_same(jeng, teng, mv=MV):
    assert _rows(teng, mv) == _rows(jeng, mv)
    assert state_mismatches(jax.device_get(jeng.jobs[0].states),
                            teng.jobs[0].states) == []


def _churn(b: int, table: dict) -> list[str]:
    """Barrier ``b``'s DML over the host copy ``table`` (key -> value):
    UPDATEs of the hot auction's key and the keys after it, which the next
    bids probe, then full-row DELETEs of a later hot key and of a key of
    the scattered bids (their later probes pad).  At 100,000 events/s
    the hot auction moves by 100 every ~1250 bids."""
    hot = 100 * (b // 2 + 1)
    sql = []
    for k in [(hot + j) % KEYS for j in range(4)] + [7 * b + 3]:
        if k in table:
            table[k] = f"u{b}_{k}"
            sql.append(f"UPDATE side_input SET value = '{table[k]}' "
                       f"WHERE key = {k}")
    for k in ((hot + 100) % KEYS, 5 * b + 20):
        if k in table:
            sql.append(f"DELETE FROM side_input VALUES ({k}, "
                       f"'{table.pop(k)}')")
    return sql


def _store_files(d):
    with open(os.path.join(d, "MANIFEST.json")) as f:
        m = json.load(f)["jobs"][MV]
    epochs = sorted(int(e) for e in m["epochs"])
    man = {"kinds": [m["kind"][str(e)] for e in epochs],
           "committed": epochs.index(int(m["committed"]))}
    payloads = []
    for e in epochs:
        with np.load(os.path.join(d, MV, f"epoch_{e}.npz")) as z:
            payloads.append({k: (z[k].shape, z[k].tobytes())
                             for k in z.files})
    return man, payloads


@pytest.mark.parametrize("join", ["JOIN", "LEFT JOIN"])
def test_q13_rows_state_store_and_cold_start(tmp_path, join):
    left = join == "LEFT JOIN"
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    ddl = [BID] + _side_input(retract=left) + [
        Q13.format(join=join, keys=KEYS),
        "ALTER SYSTEM SET snapshot_interval_checkpoints = 2"]
    jeng = JEngine(JConfig(**SIZES), data_dir=jdir)
    teng = Engine(PlannerConfig(**SIZES), data_dir=tdir, device="cpu")
    for e in (jeng, teng):
        for sql in ddl:
            e.execute(sql)
    node = teng.jobs[0].nodes[0]
    assert isinstance(node, TemporalJoinNode)
    table = {k: str(k) for k in range(KEYS)}
    assert node.join.join_type == ("left_outer" if left else "inner")
    for b in range(4):
        churn = _churn(b, table) if left else []
        for e in (jeng, teng):
            for sql in churn:
                e.execute(sql)
            e.tick(barriers=1, chunks_per_barrier=2)
        _assert_same(jeng, teng)
    rows = _rows(teng)
    assert len(rows) == 4 * 2 * 256
    if left:
        assert any(r[4] is None for r in rows)
        assert any(str(r[4]).startswith("u") for r in rows)
    else:
        assert all(r[4] == str(r[0] % KEYS) for r in rows)
    st = teng.jobs[0].states[0]
    assert isinstance(st, TjState) and int(st.overflow) == 0
    assert _store_files(tdir) == _store_files(jdir)
    del teng
    cold = Engine(PlannerConfig(**SIZES), data_dir=tdir, device="cpu")
    assert [j.name for j in cold.jobs] == [MV] and _rows(cold) == rows
    for b in range(4, 6):
        churn = _churn(b, table) if left else []
        for e in (jeng, cold):
            for sql in churn:
                e.execute(sql)
            e.tick(barriers=1, chunks_per_barrier=2)
        _assert_same(jeng, cold)


def test_dml_statements_match_reference():
    """INSERT / UPDATE / DELETE / FLUSH on a retractable table under an MV
    of its rows and an aggregation, against the reference."""
    ddl = [
        "CREATE TABLE t (id BIGINT, grp INT, name VARCHAR NULL, "
        "score DOUBLE, PRIMARY KEY (id)) WITH (retract = 'true')",
        "INSERT INTO t VALUES (1, 1, 'a', 1.5), (2, 1, NULL, 2.0), "
        "(3, 2, 'ccc', -1.0)",
        "CREATE MATERIALIZED VIEW t_rows AS SELECT id, name, score FROM t",
        "CREATE MATERIALIZED VIEW t_grp AS SELECT grp, count(*) AS n, "
        "sum(id) AS s FROM t GROUP BY grp",
        "INSERT INTO t (score, id, grp) VALUES (CAST(4 AS DOUBLE), 4, 2)",
        "UPDATE t SET name = 'bb', score = 9.25 WHERE id = 2",
        "DELETE FROM t VALUES (1, 1, 'a', 1.5)",
        "FLUSH",
        "INSERT INTO t VALUES (5, 3, 'a-much-longer-name', 0.5)",
        "UPDATE t SET grp = 1 WHERE id = 3",
        "FLUSH",
    ]
    jeng, teng = JEngine(JConfig(**SIZES)), Engine(PlannerConfig(**SIZES),
                                                   device="cpu")
    for sql in ddl:
        for e in (jeng, teng):
            e.execute(sql)
    for mv in ("t_rows", "t_grp"):
        assert _rows(teng, mv) == _rows(jeng, mv)
    for job, jjob in zip(teng.jobs, jeng.jobs):
        assert state_mismatches(jax.device_get(jjob.states),
                                job.states) == []
    assert _rows(teng, "t_rows") == [
        (2, "bb", 9.25), (3, "ccc", -1.0), (4, None, 4.0),
        (5, "a-much-longer-name", 0.5)]
    assert _rows(teng, "t_grp") == [(1, 2, 5), (2, 1, 4), (3, 1, 5)]
    for e in (jeng, teng):
        e.execute("CREATE SOURCE t2 (id BIGINT) WITH (connector = "
                  "'datagen')")
    for sql, msg in (
            ("DELETE FROM t2 VALUES (1)", "not a DML table"),
            ("UPDATE t SET name = 'x' WHERE grp = 1", "full primary key"),
            ("UPDATE t SET id = 9 WHERE id = 2", "primary-key column"),
            ("UPDATE t SET name = 'x' WHERE id = 77", "no live row"),
            ("INSERT INTO t VALUES (6, 1)", "arity mismatch"),
            ("INSERT INTO t (id, name) VALUES (6, 'x')", "NOT NULL"),
            ("INSERT INTO t VALUES (6, 1, 'x' , 'y')", "invalid value"),
            ("INSERT INTO t VALUES (7, 1, '" + "z" * 70 + "', 1.0)",
             "exceeds the width")):
        errs = []
        for e in (jeng, teng):
            with pytest.raises(ValueError) as ex:
                e.execute(sql)
            errs.append(str(ex.value))
        assert msg in errs[0] and msg in errs[1], errs
    ao = "CREATE TABLE ao (id BIGINT PRIMARY KEY)"
    for e in (jeng, teng):
        e.execute(ao)
        with pytest.raises(ValueError, match="append-only"):
            e.execute("DELETE FROM ao VALUES (1)")


def test_full_build_table_overflow_and_idle_reader():
    """16 keys in a 16-slot build table, probed by absent keys (the hot
    auction 1000 probes key 16): each probe
    chunk counts overflow on both engines; the build reader is idle, and
    the reference's empty build chunk (pulled after each probe chunk)
    copies the table's overflow (0) over the probe's, which the port's
    skip of that reader does too."""
    cfg = dict(SIZES, join_table_size=16)
    ddl = [BID] + _side_input(retract=False, n=16) + [
        Q13.format(join="JOIN", keys="40 + 16"),
        "ALTER SYSTEM SET maintenance_interval_checkpoints = 1000000"]
    jeng, teng = JEngine(JConfig(**cfg)), Engine(PlannerConfig(**cfg),
                                                 device="cpu")
    for e in (jeng, teng):
        for sql in ddl:
            e.execute(sql)
    job, jjob = teng.jobs[0], jeng.jobs[0]
    assert job._idle_builds == {"s": [0]}
    assert int(job.states[0].right.table.occupied.sum()) == 16
    job.run_chunk("b")
    jjob.run_chunk("b")
    assert int(job.states[0].overflow) > 0
    assert state_mismatches(jax.device_get(jjob.states), job.states) == []
    job.run_chunk("s")
    jjob.run_chunk("s")
    assert int(job.states[0].overflow) == 0
    assert job.sources["s"].pending() == 0
    for e in (jeng, teng):
        e.tick(barriers=2, chunks_per_barrier=2)
    _assert_same(jeng, teng)


@pytest.mark.parametrize("name", ["temporal_join.slt", "nexmark_q7.slt"])
def test_slt_file_on_the_port(name):
    eng = Engine(PlannerConfig(**SIZES), device="cpu")
    assert run_slt(eng, os.path.join(SLT_DIR, name)) > 0


def test_serving_split_and_batch_refusals():
    """Serving reads take the reference's split (``_needs_batch_exec``):
    both engines route the same reads to the batch side; the port's
    batch side evaluates global aggregates over one MV and refuses the
    rest, ORDER BY / LIMIT / OFFSET over an aggregate included."""
    ddl = ["CREATE TABLE t (k BIGINT PRIMARY KEY, v BIGINT NULL)",
           "INSERT INTO t VALUES (1, 10), (2, NULL), (3, 30)",
           "CREATE MATERIALIZED VIEW m AS SELECT k, v FROM t"]
    jeng = JEngine(JConfig(**SIZES))
    teng = Engine(PlannerConfig(**SIZES), device="cpu")
    for e in (jeng, teng):
        for sql in ddl:
            e.execute(sql)
    teng.execute("FLUSH")
    from risingwave_tpu.sql import parser as jparser
    from risingwave_tpu_torch.sql import parser

    reads = ["SELECT k, v FROM m", "SELECT count(*) FROM m",
             "SELECT k FROM m GROUP BY k", "SELECT * FROM t",
             "SELECT k FROM m WHERE k IN (SELECT k FROM t)",
             "SELECT k FROM m WHERE k > 1", "SELECT * FROM nope"]
    for sql in reads:
        assert teng._needs_batch_exec(parser.parse(sql)[0]) == \
            jeng._needs_batch_exec(jparser.parse(sql)[0]), sql
    assert teng.execute("SELECT count(*), count(v), min(v), max(v), "
                        "sum(v) FROM m") == [(3, 2, 10, 30, 40)]
    assert teng.execute("SELECT k, v FROM m ORDER BY k DESC LIMIT 2") == [
        (3, 30), (2, None)]
    for sql in ["SELECT count(*) FROM m ORDER BY 1",
                "SELECT count(*) FROM m LIMIT 1",
                "SELECT max(v) FROM m OFFSET 1",
                "SELECT k, count(*) FROM m GROUP BY k",
                "SELECT count(*) FROM m WHERE k > 1",
                "SELECT * FROM t"]:
        with pytest.raises(NotImplementedError):
            teng.execute(sql)
