"""Port parity: Nexmark q102 through SQL — an aggregation over a join,
filtered by a moving scalar (the dynamic filter), with ``COUNT(DISTINCT)``
in the scalar's subquery and a VARCHAR group key.

The query, as RisingWave's Nexmark suite publishes it, plans on both
engines into the same DAG: watermark filters on ``a`` and ``b``, the
inner pool/pool join, ``HashAgg`` over ``(a.id, a.item_name)`` with its
spill ring, a second reader of the bid source (``bid``) into the global
``COUNT(*) / COUNT(DISTINCT auction)``, the ``DynamicFilterExecutor``
(``ge``) and the MV.  It runs through the reference engine and the
port's engine (``device="cpu"``), each durable (``data_dir``), on
bench.py's bid source and the auction source with ``item_name`` at
10,000 events/s, chunk 256, a snapshot every 2 checkpoints.  After every
barrier the MV rows and every state tensor (the dedup tables and counts,
the filter's pool, threshold and flag included) must be equal; the two
stores must hold the same manifests and payload arrays; ``recover()``
must restore both, and a cold start of the port from its directory must
continue equal to the reference.  The plan for CUDA takes no refusal.
Tolerance: none — the path is integer end to end.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import json
import os

import jax
import numpy as np

from risingwave_tpu.sql import Engine as JEngine
from risingwave_tpu.sql.planner import PlannerConfig as JConfig
from risingwave_tpu_torch.compat import state_mismatches
from risingwave_tpu_torch.sql import Engine
from risingwave_tpu_torch.sql.parser import parse
from risingwave_tpu_torch.sql.planner import Planner, PlannerConfig
from risingwave_tpu_torch.stream.dynamic_filter import DynFilterState
from tests.test_torch_join_sql import JOIN_SOURCES, SIZES

#: RisingWave's Nexmark q102, as published
Q102 = """
CREATE MATERIALIZED VIEW nexmark_q102 AS
SELECT
    a.id AS auction_id,
    a.item_name AS auction_item_name,
    COUNT(b.auction) AS bid_count
FROM auction a
JOIN bid b ON a.id = b.auction
GROUP BY a.id, a.item_name
HAVING COUNT(b.auction) >= (
    SELECT COUNT(*) / COUNT(DISTINCT auction) FROM bid
);
"""
Q102_SIZES = dict(SIZES, topn_pool_size=1 << 10, distinct_table_size=1 << 10)
RATE = "10000"
MV = "nexmark_q102"


def _start(engine):
    engine.execute(JOIN_SOURCES.format(rate=RATE))
    engine.execute(Q102)
    engine.execute("ALTER SYSTEM SET snapshot_interval_checkpoints = 2")
    return engine


def _rows(engine):
    return sorted(engine.execute(f"SELECT * FROM {MV}"), key=repr)


def _assert_same(jeng, teng):
    assert _rows(teng) == _rows(jeng)
    assert state_mismatches(jax.device_get(jeng.jobs[0].states),
                            teng.jobs[0].states) == []


def _store_files(d):
    """The job's manifest (epoch kinds in order, the committed epoch's
    position) and each retained epoch's payload arrays as raw bytes."""
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


def test_q102_rows_state_store_recover_and_cold_start(tmp_path):
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    jeng = _start(JEngine(JConfig(**Q102_SIZES), data_dir=jdir))
    teng = _start(Engine(PlannerConfig(**Q102_SIZES), data_dir=tdir,
                         device="cpu"))
    thresholds = []
    for _ in range(4):
        for e in (jeng, teng):
            e.tick(barriers=1, chunks_per_barrier=2)
        _assert_same(jeng, teng)
        dyn = teng.jobs[0].states[6]
        assert isinstance(dyn, DynFilterState) and bool(dyn.has_threshold)
        thresholds.append(int(dyn.threshold))
    assert len(_rows(teng)) > 0 and len(set(thresholds)) > 1
    agg = teng.jobs[0].states[5][0]
    assert int(agg.distinct_tables[0].occupied.sum()) > 1
    assert _store_files(tdir) == _store_files(jdir)
    for e in (jeng, teng):
        e.recover()
    _assert_same(jeng, teng)
    for e in (jeng, teng):
        e.tick(barriers=2, chunks_per_barrier=2)
    _assert_same(jeng, teng)
    rows = _rows(teng)
    del teng
    cold = Engine(PlannerConfig(**Q102_SIZES), data_dir=tdir, device="cpu")
    assert [j.name for j in cold.jobs] == [MV] and _rows(cold) == rows
    for e in (jeng, cold):
        e.tick(barriers=2, chunks_per_barrier=2)
    _assert_same(jeng, cold)


def _shape(job):
    return [([type(x).__name__ for x in n.fragment.executors], n.input)
            if hasattr(n, "fragment")
            else (type(n.join).__name__, n.left, n.right) for n in job.nodes]


def test_q102_plan_shape_and_cuda_plan():
    """The reference's DAG, node for node (q102, and the aggregation over
    the join without the HAVING filter), and a plan for CUDA without a
    refusal (K5 takes the VARCHAR group key, K6d the DISTINCT dedup, K21
    the filter)."""
    no_filter = Q102.replace("q102", "q102_all").split("HAVING")[0] + ";"
    eng = _start(Engine(PlannerConfig(**Q102_SIZES), device="cpu"))
    jeng = _start(JEngine(JConfig(**Q102_SIZES)))
    for e in (eng, jeng):
        e.execute(no_filter)
    assert len(eng.jobs) == len(jeng.jobs) == 2
    for job, jjob in zip(eng.jobs, jeng.jobs):
        assert _shape(job) == _shape(jjob)
        assert list(job.sources) == list(jjob.sources)
    job = eng.jobs[0]
    assert list(job.sources) == ["a", "b", "bid"]
    shape = [[type(x).__name__ for x in n.fragment.executors]
             if hasattr(n, "fragment") else type(n.join).__name__
             for n in job.nodes]
    assert shape == [["WatermarkFilterExecutor"], ["WatermarkFilterExecutor"],
                     "HashJoinExecutor",
                     ["HashAggExecutor", "ProjectExecutor"],
                     ["WatermarkFilterExecutor"],
                     ["HashAggExecutor", "ProjectExecutor"],
                     "DynamicFilterExecutor", ["MaterializeExecutor"]]
    assert [n.left for n in job.nodes if hasattr(n, "join")] == \
        [("node", 0), ("node", 3)]
    assert type(job.nodes[6]).__name__ == "FilterNode"
    dyn = job.nodes[6].join
    assert (dyn.cmp, dyn.filter_col, dyn.pool_size) == ("ge", 3, 1 << 10)
    assert job.nodes[6].right == ("node", 5)
    glob = job.nodes[5].fragment.executors[0]
    assert glob._distinct_aggs == [1] and glob.spill_ring == 4 * 256
    assert job.nodes[3].fragment.executors[0].spill_ring == 4 * 256
    planner = Planner(eng.catalog, PlannerConfig(**Q102_SIZES),
                      device="cuda")
    planner.plan(parse(Q102)[0].query)
