"""Port parity: durable checkpoints and cold start through
``Engine(config, data_dir=...)``.

q7 (1M events/s), q8 (10,000 events/s, pools of 2^14 rows, emission
windows of 64: pairs drain over several windows, both sides clean and
``rebuild_pool`` fires) and q19 (1M events/s, a top-N pool of 4096 rows,
an emitted band of 1024 and a whole-row MV keyed by strings too) run
``bench.py``'s SQL (q19: the published text) with a snapshot every 2
checkpoints on the reference engine and the port's engine
(``device="cpu"``), each with its own ``data_dir``.  Each engine is
dropped after its last tick (``tick`` drains the uploads) and a new
``Engine(config, data_dir=same)`` cold-starts from the directory: it
replays the DDL log, loads the last committed epoch and rewinds the
source cursors.  After more barriers the MV rows (q8: the ring rows in
order) and every state tensor must equal the reference's cold-started
engine, and equal a port engine that ran all the barriers without
stopping.  For q19 the two stores must also hold the same manifests
(epochs, full/delta kinds) and the same payload arrays, byte for byte.
An empty directory bootstraps nothing; a directory with DDL
and no committed epoch cold-starts the jobs from their initial state.
Tolerance: none.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import json
import os

import jax
import numpy as np
import pytest

from bench import QUERIES as BENCH_QUERIES, SOURCES
from risingwave_tpu.sql import Engine as JEngine
from risingwave_tpu.sql.planner import PlannerConfig as JConfig
from risingwave_tpu_torch.common.tree import flatten
from risingwave_tpu_torch.compat import state_mismatches
from risingwave_tpu_torch.sql import Engine
from risingwave_tpu_torch.sql.planner import PlannerConfig

#: bench.py's queries and Nexmark q19 (group top-N by the ROW_NUMBER
#: rewrite: a pool, an emitted band and a whole-row MV with strings)
QUERIES = dict(BENCH_QUERIES, q19="""
CREATE MATERIALIZED VIEW bench_mv AS
SELECT * FROM (SELECT *, ROW_NUMBER() OVER (PARTITION BY auction ORDER BY
               price DESC) AS rank_number FROM bid) WHERE rank_number <= 10;
""")
CASES = {
    "q7": ("1000000", dict(chunk_capacity=256, agg_table_size=1 << 10,
                           agg_emit_capacity=128, mv_table_size=1 << 10)),
    "q8": ("10000", dict(chunk_capacity=256, join_pool_size=1 << 14,
                         join_out_capacity=64, mv_ring_size=1 << 16)),
    "q19": ("1000000", dict(chunk_capacity=256, topn_pool_size=4096,
                            topn_emit_capacity=1024, mv_table_size=1 << 12)),
}
BEFORE, AFTER = 6, 4


def _ddl(engine, query, rate):
    engine.execute(SOURCES.format(rate=rate))
    engine.execute(QUERIES[query])
    engine.execute("ALTER SYSTEM SET snapshot_interval_checkpoints = 2")
    return engine


def _rows(engine):
    return engine.execute("SELECT * FROM bench_mv")


def _same_tensors(a, b) -> bool:
    la, lb = flatten(a.jobs[0].states)[0], flatten(b.jobs[0].states)[0]
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and bool((x == y).all()) for x, y in zip(la, lb))


@pytest.mark.parametrize("query", ["q7", "q8", "q19"])
def test_cold_start_equals_reference_and_uninterrupted(query, tmp_path):
    rate, sizes = CASES[query]
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    jeng = _ddl(JEngine(JConfig(**sizes), data_dir=jdir), query, rate)
    teng = _ddl(Engine(PlannerConfig(**sizes), data_dir=tdir,
                       device="cpu"), query, rate)
    whole = _ddl(Engine(PlannerConfig(**sizes), device="cpu"), query, rate)
    for e in (jeng, teng, whole):
        e.tick(barriers=BEFORE, chunks_per_barrier=4)
    job = teng.jobs[0]
    assert job.committed_epoch == job.sealed_epoch > 0
    store = teng.checkpoint_store
    kinds = [store.checkpoint_kind("bench_mv", e)
             for e in store.epochs("bench_mv")]
    assert kinds[0] == "full" and "delta" in kinds
    if query == "q8":
        assert job.rehash_fired.get("rebuild_pool", 0) >= 1
    before_rows = _rows(teng)
    n_ddl = len(teng.meta_store.ddl_log())
    del jeng, teng, job

    jeng = JEngine(JConfig(**sizes), data_dir=jdir)
    teng = Engine(PlannerConfig(**sizes), data_dir=tdir, device="cpu")
    assert [j.name for j in teng.jobs] == ["bench_mv"]
    assert _rows(teng) == before_rows
    assert len(teng.meta_store.ddl_log()) == n_ddl  # replay logs nothing
    for e in (jeng, teng, whole):
        e.tick(barriers=AFTER, chunks_per_barrier=4)
        rows = _rows(e)
    assert rows == _rows(teng) == _rows(jeng)
    if query == "q8":
        assert len(rows) > 1000
    assert state_mismatches(jax.device_get(jeng.jobs[0].states),
                            teng.jobs[0].states) == []
    assert _same_tensors(teng, whole)
    readers = (lambda e: [r.offset for r in e.jobs[0].sources.values()]) \
        if query == "q8" else (lambda e: [e.jobs[0].source.offset])
    assert readers(teng) == readers(whole)


def test_empty_dir_and_uncommitted_catalog_bootstrap(tmp_path):
    rate, sizes = CASES["q7"]
    d = str(tmp_path / "d")
    eng = Engine(PlannerConfig(**sizes), data_dir=d, device="cpu")
    assert eng.jobs == [] and not eng.meta_store.has_catalog()
    _ddl(eng, "q7", rate)
    log = eng.meta_store.ddl_log()
    assert len(log) == 5 and log[-1].startswith("ALTER SYSTEM SET")
    assert eng.checkpoint_store.committed_epoch("bench_mv") is None
    del eng
    # DDL logged, nothing committed: the job starts from scratch
    eng = Engine(PlannerConfig(**sizes), data_dir=d, device="cpu")
    fresh = _ddl(Engine(PlannerConfig(**sizes), device="cpu"), "q7", rate)
    assert len(eng.jobs) == 1 and eng.jobs[0].source.offset == 0
    for e in (eng, fresh):
        e.tick(barriers=2, chunks_per_barrier=2)
    assert _rows(eng) == _rows(fresh)
    assert _same_tensors(eng, fresh)
    assert eng.checkpoint_store.committed_epoch("bench_mv") == \
        eng.jobs[0].committed_epoch > 0


def _store_files(d):
    """The job's manifest (retained epochs as their kinds, in order, and
    the committed epoch's position: epoch numbers come from the wall
    clock, and the crc records differ with the npz dtype headers) and
    each retained epoch's payload arrays as raw bytes, in epoch order."""
    with open(os.path.join(d, "MANIFEST.json")) as f:
        m = json.load(f)["jobs"]["bench_mv"]
    epochs = sorted(int(e) for e in m["epochs"])
    man = {"kinds": [m["kind"][str(e)] for e in epochs],
           "committed": epochs.index(int(m["committed"]))}
    payloads = []
    for e in epochs:
        path = os.path.join(d, "bench_mv", f"epoch_{e}.npz")
        with np.load(path) as z:
            payloads.append({k: (z[k].shape, z[k].tobytes())
                             for k in z.files})
    return man, payloads


def test_q19_store_equals_reference_store(tmp_path):
    """q19's durable store, epoch by epoch: the same manifests and the
    same payload arrays as the reference's, and a cold start from it
    equal to an engine that never stopped."""
    rate, sizes = CASES["q19"]
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    jeng = _ddl(JEngine(JConfig(**sizes), data_dir=jdir), "q19", rate)
    teng = _ddl(Engine(PlannerConfig(**sizes), data_dir=tdir,
                       device="cpu"), "q19", rate)
    for step in range(3):
        for e in (jeng, teng):
            e.tick(barriers=2, chunks_per_barrier=4)
        jman, jpay = _store_files(jdir)
        tman, tpay = _store_files(tdir)
        assert tman == jman
        assert len(tpay) == len(jpay) > 0
        for i, (t, j) in enumerate(zip(tpay, jpay)):
            assert sorted(t) == sorted(j)
            for k in j:
                assert t[k] == j[k], (step, i, k)
    assert set(tman["kinds"]) == {"full", "delta"}
    whole = _ddl(Engine(PlannerConfig(**sizes), device="cpu"), "q19", rate)
    whole.tick(barriers=6, chunks_per_barrier=4)
    del teng
    cold = Engine(PlannerConfig(**sizes), data_dir=tdir, device="cpu")
    for e in (cold, whole):
        e.tick(barriers=2, chunks_per_barrier=4)
    assert _rows(cold) == _rows(whole)
    assert _same_tensors(cold, whole)
