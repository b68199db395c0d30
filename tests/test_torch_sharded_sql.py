"""Port parity: vnode-sharded aggregation through SQL (``SET
streaming_parallelism``), the port's 8-lane mesh on the CPU against the
reference's 8 virtual devices (``tests/conftest.py``).

With ``SET streaming_parallelism = 4`` both engines plan ``bench.py``'s q5
and q7, the auction count/max view and the global top-N view of
``tests/test_sharded.py`` as a ``ShardedStreamingJob`` over 4 shards with
the same executor chain (watermark filter, window, the partial
aggregation | exchange | the global aggregation, project, materialize).
After the same barriers the MV rows are equal and so is every leaf of the
stacked state, lane by lane (K2's, K24's and K22c's plain versions on the
port's side).  q7's 2-second TUMBLE at 1000 events/s closes windows, so
the cross-lane watermark (the min over the lanes) cleans the groups.  A
file sink over a sharded aggregation delivers exactly once across a cold
start, and its fold equals the reference's.  With one lane a parallelism
above 1 plans linearly, as the reference does on one device (no pane
rewrite either).  Tolerance: none (integer keys and aggregates).
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import json

import jax
import pytest

from bench import QUERIES, SOURCES
from risingwave_tpu.sql import Engine as JEngine
from risingwave_tpu.sql.planner import PlannerConfig as JConfig
from risingwave_tpu_torch.compat import state_mismatches
from risingwave_tpu_torch.sql import Engine
from risingwave_tpu_torch.sql.planner import PlannerConfig
from risingwave_tpu_torch.stream.runtime import StreamingJob
from risingwave_tpu_torch.stream.sharded import ShardedStreamingJob

CFG = dict(chunk_capacity=128, agg_table_size=512, agg_emit_capacity=128,
           mv_table_size=512, mv_ring_size=2048, topn_pool_size=512,
           topn_emit_capacity=128)
BID = ("CREATE SOURCE bid (auction BIGINT, price BIGINT, "
       "date_time TIMESTAMP{wm}) WITH (connector='nexmark', "
       "nexmark.table='bid', nexmark.event.rate='{rate}')")
WM = ", WATERMARK FOR date_time AS date_time - INTERVAL '4' SECOND"
VIEWS = {
    "q5": (SOURCES.format(rate="10000"), QUERIES["q5"], 4, 2),
    "q7": (SOURCES.format(rate="10000"), QUERIES["q7"], 4, 2),
    # test_sharded.py's windowed view: 2 s windows at 1000 events/s close
    # within the run, the watermark cleans them
    "q7_tumble_2s": (BID.format(wm=WM, rate="1000"), """
        CREATE MATERIALIZED VIEW bench_mv AS SELECT window_start,
        max(price) AS hi, count(*) AS n
        FROM TUMBLE(bid, date_time, INTERVAL '2' SECOND)
        GROUP BY window_start""", 8, 1),
    "auction_count_max": (BID.format(wm="", rate="100000"), """
        CREATE MATERIALIZED VIEW bench_mv AS SELECT auction,
        count(*) AS n, max(price) AS hi FROM bid GROUP BY auction""", 3, 2),
    "global_topn": (BID.format(wm="", rate="100000"), """
        CREATE MATERIALIZED VIEW bench_mv AS SELECT auction, count(*) AS n
        FROM bid GROUP BY auction ORDER BY n DESC, auction LIMIT 5""", 3, 2),
}
CHAIN = ["WatermarkFilterExecutor", "HopWindowExecutor",
         "PartialAggExecutor", "HashAggExecutor", "ProjectExecutor",
         "MaterializeExecutor"]


def _host(rows):
    return [tuple(int(v) if v is not None else None for v in r)
            for r in rows]


def _build(view, lanes=8):
    ddl, mv, _, _ = VIEWS[view]
    engines = (JEngine(JConfig(**CFG)),
               Engine(PlannerConfig(**CFG), device="cpu", lanes=lanes))
    for e in engines:
        e.execute(ddl)
        e.execute("SET streaming_parallelism = 4")
        e.execute(mv)
    return engines


@pytest.mark.parametrize("view", list(VIEWS), ids=list(VIEWS))
def test_sharded_view_matches_reference(view):
    ref, port = _build(view)
    jr, jp = ref.jobs[0], port.jobs[0]
    assert type(jr).__name__ == "ShardedStreamingJob"
    assert isinstance(jp, ShardedStreamingJob)
    assert jp.sharded.n_shards == jr.sharded.n_shards == 4
    names = [type(e).__name__ for e in jp.sharded.executors]
    assert names == [type(e).__name__ for e in jr.sharded.executors]
    if view in ("q5", "q7"):
        assert names == CHAIN
    _, _, barriers, cpb = VIEWS[view]
    for _ in range(barriers):
        ref.tick(barriers=1, chunks_per_barrier=cpb)
        port.tick(barriers=1, chunks_per_barrier=cpb)
        bad = state_mismatches(jax.device_get(jr.states), jp.states)
        assert not bad, bad[:5]
    got = _host(port.execute("SELECT * FROM bench_mv"))
    want = _host(ref.execute("SELECT * FROM bench_mv"))
    if view == "global_topn":
        # the merged lane bands in the global order and limit
        assert got == want and len(got) == 5
    else:
        assert sorted(got) == sorted(want) and got
    assert jp.reader.offset == jr.reader.offset
    assert jp.committed_epoch > 0


def test_sharded_windows_are_cleaned():
    """The 2 s windows close: the lanes' aggregation tables keep only the
    open windows (the watermark is the min over the lanes)."""
    _, port = _build("q7_tumble_2s")
    job = port.jobs[0]
    agg = next(i for i, e in enumerate(job.sharded.executors)
               if type(e).__name__ == "HashAggExecutor")
    for _ in range(12):
        port.tick(barriers=1, chunks_per_barrier=1)
    occupied = job.states[agg].table.occupied.sum(dim=1)
    tombs = job.states[agg].table.tombstone.sum()
    assert int(tombs) > 0 and int(occupied.max()) <= 4, occupied


def _fold(path):
    state = {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            if r["op"] in ("insert", "update_insert"):
                state[r["auction"]] = r["n"]
            elif r["op"] in ("delete", "update_delete"):
                state.pop(r["auction"], None)
    return state


def _want(rows: int) -> dict:
    from collections import Counter

    from risingwave_tpu.connector.nexmark import NexmarkGenerator

    _, cols, _ = NexmarkGenerator().gen_bids(0, rows).to_host()
    return dict(Counter(int(x) for x in cols[0]))


def test_sharded_sink_exactly_once_across_cold_start(tmp_path):
    """test_sharded.py's sink scenario: a file sink over a sharded
    aggregation; the engine dies after a barrier, a cold start from its
    directory resumes delivery, and the file holds each change once."""
    path = str(tmp_path / "port.jsonl")
    ref_path = str(tmp_path / "ref.jsonl")
    cfg = PlannerConfig(**CFG)

    def build(p, data_dir, engine=Engine, conf=cfg, **kw):
        eng = engine(conf, data_dir=data_dir, **kw)
        if not eng.jobs:
            eng.execute(BID.format(wm="", rate="100000"))
            eng.execute("SET streaming_parallelism = 4")
            eng.execute("CREATE SINK s AS SELECT auction, count(*) AS n "
                        f"FROM bid GROUP BY auction WITH (connector='file', "
                        f"path='{p}')")
        return eng

    eng = build(path, str(tmp_path / "d"), device="cpu", lanes=8)
    assert isinstance(eng.jobs[0], ShardedStreamingJob)
    eng.tick(barriers=1, chunks_per_barrier=1)
    assert _fold(path) == _want(512)
    del eng
    eng2 = build(path, str(tmp_path / "d"), device="cpu", lanes=8)
    assert isinstance(eng2.jobs[0], ShardedStreamingJob)
    eng2.tick(barriers=1, chunks_per_barrier=1)
    assert _fold(path) == _want(1024)
    ref = build(ref_path, str(tmp_path / "r"), JEngine, JConfig(**CFG))
    ref.tick(barriers=2, chunks_per_barrier=1)
    assert _fold(path) == _fold(ref_path)
    commits = [json.loads(x)["op"] for x in open(path)].count("commit")
    assert commits == 2


def test_parallelism_with_one_lane_plans_linearly():
    """With one lane, ``streaming_parallelism = 4`` runs q5 linearly and
    without the pane rewrite (the reference on one device); its MV equals
    the 8-lane run's over the same bids."""
    one = Engine(PlannerConfig(**CFG), device="cpu")
    eight = Engine(PlannerConfig(**CFG), device="cpu", lanes=8)
    for e in (one, eight):
        e.execute(SOURCES.format(rate="10000"))
        e.execute("SET streaming_parallelism = 4")
        e.execute(QUERIES["q5"])
    job = one.jobs[0]
    assert isinstance(job, StreamingJob)
    assert [type(e).__name__ for e in job.fragment.executors] == [
        "WatermarkFilterExecutor", "HopWindowExecutor", "HashAggExecutor",
        "ProjectExecutor", "MaterializeExecutor"]
    one.tick(barriers=2, chunks_per_barrier=4)
    eight.tick(barriers=2, chunks_per_barrier=1)
    assert sorted(_host(one.execute("SELECT * FROM bench_mv"))) == \
        sorted(_host(eight.execute("SELECT * FROM bench_mv")))
    assert one.jobs[0].source.offset == eight.jobs[0].reader.offset


def test_rescale_and_sharded_upstream_refused():
    """ALTER PARALLELISM and a job's rescale are a later slice; an MV over
    a sharded MV is refused as the reference refuses it."""
    _, port = _build("auction_count_max")
    with pytest.raises(NotImplementedError, match="later slice"):
        port.jobs[0].rescale(2)
    with pytest.raises(NotImplementedError, match="AlterParallelism"):
        port.execute("ALTER MATERIALIZED VIEW bench_mv SET PARALLELISM 2")
    with pytest.raises(Exception, match="sharded"):
        port.execute("CREATE MATERIALIZED VIEW v2 AS SELECT auction, n "
                     "FROM bench_mv")


def test_sharded_time_travel_reads_the_checkpoint_lanes(tmp_path):
    """``SET query_epoch`` over a sharded MV merges the retained
    checkpoint's lanes: the rows of that epoch, not the live ones."""
    eng = Engine(PlannerConfig(**CFG), data_dir=str(tmp_path), device="cpu",
                 lanes=8)
    eng.execute(BID.format(wm="", rate="100000"))
    eng.execute("SET streaming_parallelism = 4")
    eng.execute("CREATE MATERIALIZED VIEW v AS SELECT auction, count(*) AS n "
                "FROM bid GROUP BY auction")
    job = eng.jobs[0]
    eng.tick(barriers=1, chunks_per_barrier=1)
    epoch = job.committed_epoch
    then = sorted(_host(eng.execute("SELECT * FROM v")))
    eng.tick(barriers=1, chunks_per_barrier=1)
    now = sorted(_host(eng.execute("SELECT * FROM v")))
    assert then != now
    eng.execute(f"SET query_epoch = {epoch}")
    assert sorted(_host(eng.execute("SELECT * FROM v"))) == then
