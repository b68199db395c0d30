"""The planner refuses, when the MV is planned for CUDA, the DDL whose
kernels the card lacks, and still plans it for the CPU.

Each case plans one ``CREATE MATERIALIZED VIEW`` twice over the same
catalog: for the CPU (it plans; the plain versions run it) and for
``"cuda"`` (``PlanError`` naming the kernel).  Planning allocates
nothing on the device, so this runs without a GPU.  The shapes the card
runs (``bench.py``'s queries, q19/q18 and the window queries) plan for
CUDA unchanged.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import pytest

from bench import QUERIES, SOURCES
from risingwave_tpu_torch.sql import Engine
from risingwave_tpu_torch.sql.parser import parse
from risingwave_tpu_torch.sql.planner import PlanError, Planner, \
    PlannerConfig

GEN = """
CREATE SOURCE t (k BIGINT, f DOUBLE, g REAL, s SMALLINT, b BOOLEAN,
                 ts TIMESTAMP,
                 WATERMARK FOR ts AS ts - INTERVAL '1' SECOND)
WITH (connector = 'datagen');
CREATE SOURCE w (k BIGINT, c0 VARCHAR, c1 VARCHAR, c2 VARCHAR, c3 VARCHAR,
                 c4 VARCHAR, c5 VARCHAR, c6 VARCHAR, c7 VARCHAR,
                 c8 VARCHAR)
WITH (connector = 'datagen');
"""
#: tables for the temporal join: q13's side input, a two-column pk, a
#: table without a pk and a build row of 17 value leaves (K22a takes 16)
TABLES = """
CREATE TABLE side_input (key BIGINT PRIMARY KEY, value VARCHAR);
CREATE TABLE pk2 (a BIGINT, b VARCHAR(40), v INT, PRIMARY KEY (a, b));
CREATE TABLE nopk (key BIGINT, value VARCHAR);
CREATE TABLE wide (k BIGINT PRIMARY KEY, c0 VARCHAR, c1 VARCHAR, c2 VARCHAR,
                   c3 VARCHAR, c4 VARCHAR, c5 VARCHAR, c6 VARCHAR,
                   c7 VARCHAR);
CREATE TABLE rates (cur VARCHAR(8), rate BIGINT, PRIMARY KEY (cur));
CREATE TABLE rt (k BIGINT PRIMARY KEY, g REAL, s SMALLINT, f DOUBLE,
                 v BIGINT) WITH (retract = 'true');
"""
Q13 = ("SELECT B.auction, B.bidder, B.price, B.date_time, S.value FROM bid B "
       "{join} side_input FOR SYSTEM_TIME AS OF PROCTIME() S "
       "ON B.auction % 10000 = S.key")
TUMBLE_T = "TUMBLE(t, ts, INTERVAL '10' SECOND)"
TUMBLE_BID = "TUMBLE(bid, date_time, INTERVAL '10' SECOND)"


def _topn(key: str, table: str = "t", part: str = "k") -> str:
    return (f"SELECT * FROM (SELECT *, ROW_NUMBER() OVER (PARTITION BY "
            f"{part} ORDER BY {key} DESC) AS rn FROM {table}) WHERE rn <= 2")


REFUSED = {
    # K17: the top-N's and the over-window's order keys are integers
    "topn_order_by_double": (_topn("f"), "K17"),
    "topn_order_by_boolean": (_topn("b"), "K17"),
    "topn_order_by_varchar": (_topn("channel", "bid", "auction"), "K17"),
    "order_by_limit_real": ("SELECT k, g FROM t ORDER BY g LIMIT 5", "K17"),
    "over_window_order_by_double": (
        "SELECT k, row_number() OVER (PARTITION BY k ORDER BY f) AS r "
        "FROM t", "K17"),
    "over_window_order_by_varchar": (
        "SELECT auction, rank() OVER (PARTITION BY auction ORDER BY url) "
        "AS r FROM bid", "K17"),
    # K5: float group keys, and string keys past its 16 leaves (each
    # VARCHAR key is two: bytes and lengths)
    "group_by_varchar": (
        "SELECT c0, c1, c2, c3, c4, c5, c6, c7, c8, count(*) AS n FROM w "
        "GROUP BY c0, c1, c2, c3, c4, c5, c6, c7, c8", "K5"),
    "group_by_double": (
        f"SELECT f, window_start, count(*) AS n FROM {TUMBLE_T} "
        "GROUP BY f, window_start", "K5"),
    # K6: min/max over float64 states
    "max_double": (
        f"SELECT window_start, max(f) AS m FROM {TUMBLE_T} "
        "GROUP BY window_start", "K6"),
    "min_double": (
        f"SELECT window_start, min(f) AS m FROM {TUMBLE_T} "
        "GROUP BY window_start", "K6"),
    # K5/K6 values of another dtype than int64, int32 and float64
    "sum_real": (
        f"SELECT window_start, sum(g) AS m FROM {TUMBLE_T} "
        "GROUP BY window_start", "K5"),
    "min_smallint": (
        f"SELECT window_start, min(s) AS m FROM {TUMBLE_T} "
        "GROUP BY window_start", "K5"),
    # K6m: min/max over a retractable input take int64, int32, float64
    "minput_real": ("SELECT k, min(g) AS m FROM rt GROUP BY k", "K6m"),
    "minput_smallint": ("SELECT k, max(s) AS m FROM rt GROUP BY k", "K6m"),
    # K22a: a build row past its 16 value leaves; keys of other widths
    "temporal_wide_build": (
        "SELECT b.auction, w.c0 FROM bid b JOIN wide FOR SYSTEM_TIME AS OF "
        "PROCTIME() w ON b.auction = w.k", "K22a"),
    "temporal_key_width": (
        "SELECT b.auction, r.rate FROM bid b JOIN rates FOR SYSTEM_TIME AS "
        "OF PROCTIME() r ON b.channel = r.cur", "K22a"),
}

#: the temporal join's plan errors, on every device (the reference's words)
TEMPORAL_ERRORS = {
    "no_primary_key": (
        "SELECT b.auction, n.value FROM bid b JOIN nopk FOR SYSTEM_TIME AS "
        "OF PROCTIME() n ON b.auction = n.key", "needs a PRIMARY KEY"),
    "keys_not_covering_pk": (
        "SELECT b.auction, p.v FROM bid b JOIN pk2 FOR SYSTEM_TIME AS OF "
        "PROCTIME() p ON b.auction = p.a", "covering the build side's "
        "PRIMARY KEY exactly"),
    "build_key_expression": (
        "SELECT b.auction, s.value FROM bid b JOIN side_input FOR "
        "SYSTEM_TIME AS OF PROCTIME() s ON b.auction = s.key + 1",
        "keys must be build-side columns"),
}

#: the join kernels' leaf limits: (sql, extra config, kernel)
JOIN_REFUSED = {
    # 19 leaves a side; a full outer join's output pads both: 58 > 32
    "full_join_wide": (
        "SELECT * FROM w a FULL JOIN w b ON a.k = b.k", {}, "K14"),
    # a dense side hashes its 19 leaves per row (K13d takes 16)
    "dense_side_wide": (
        "SELECT * FROM w a JOIN w b ON a.k = b.k",
        dict(join_force_dense=True), "K13d"),
}

PLANNED = {
    "q1": QUERIES["q1"], "q5": QUERIES["q5"], "q7": QUERIES["q7"],
    "q8": QUERIES["q8"],
    "q19": _topn("price", "bid", "auction").replace("rn <= 2", "rn <= 10"),
    "q6_bid": (
        "SELECT bidder, price, date_time, AVG(price) OVER (PARTITION BY "
        "bidder ORDER BY date_time ROWS BETWEEN 10 PRECEDING AND CURRENT "
        "ROW) AS avg FROM (SELECT *, ROW_NUMBER() OVER (PARTITION BY "
        "auction ORDER BY price DESC) AS rn FROM bid) WHERE rn <= 1"),
    "ow_bid": (
        "SELECT auction, price, lead(price) OVER (PARTITION BY auction "
        "ORDER BY date_time) AS nxt, sum(price) OVER (PARTITION BY auction "
        "ORDER BY date_time) AS s FROM bid"),
    # the join matrix over a pool and a dense side (q101, q103, q104's
    # shapes on bench.py's auction source, which lacks item_name)
    "q101_shape": (
        "SELECT a.id, a.reserve, b.max_price FROM auction a LEFT OUTER "
        "JOIN (SELECT auction, MAX(price) max_price FROM bid GROUP BY "
        "auction) b ON a.id = b.auction"),
    "q103_shape": (
        "SELECT a.id, a.reserve FROM auction a WHERE a.id IN (SELECT "
        "b.auction FROM bid b GROUP BY b.auction HAVING COUNT(*) >= 20)"),
    "q104_shape": (
        "SELECT a.id, a.reserve FROM auction a WHERE a.id NOT IN (SELECT "
        "b.auction FROM bid b GROUP BY b.auction HAVING COUNT(*) < 20)"),
    # K5 takes string group keys
    "group_by_channel": (
        f"SELECT channel, window_start, count(*) AS n FROM {TUMBLE_BID} "
        "GROUP BY channel, window_start"),
    # an aggregation over a join with COUNT(DISTINCT) and a dynamic
    # filter (q102's shape on bench.py's auction source)
    "q102_shape": (
        "SELECT a.id, a.seller, COUNT(b.auction) AS n FROM auction a JOIN "
        "bid b ON a.id = b.auction GROUP BY a.id, a.seller HAVING "
        "COUNT(b.auction) >= (SELECT COUNT(*) / COUNT(DISTINCT auction) "
        "FROM bid)"),
    "sum_and_count_double": (
        f"SELECT window_start, sum(f) AS s, count(*) AS n FROM {TUMBLE_T} "
        "GROUP BY window_start"),
    # the temporal join (K22a): q13, its LEFT JOIN, a two-column pk in pk
    # order from ON conjuncts in another order, a residual ON filter
    "q13": Q13.format(join="JOIN"),
    "q13_left": Q13.format(join="LEFT JOIN"),
    "temporal_two_col_pk": (
        "SELECT b.auction, p.v FROM bid b JOIN pk2 FOR SYSTEM_TIME AS OF "
        "PROCTIME() p ON b.url = p.b AND b.auction = p.a"),
    # min/max over a retractable input (K6m): float64 and int64 values,
    # and the pane plan's global phase of a HOP max (q5_max)
    "minput_double": "SELECT k, max(f) AS m, min(v) AS n FROM rt GROUP BY k",
    "q5_max": (
        "SELECT auction, window_start, max(price) AS max_price, count(*) "
        "AS bids FROM HOP(bid, date_time, INTERVAL '2' SECOND, INTERVAL "
        "'10' SECOND) GROUP BY auction, window_start"),
    "temporal_residual": (
        "SELECT b.auction, s.value FROM bid b LEFT JOIN side_input FOR "
        "SYSTEM_TIME AS OF PROCTIME() s ON b.auction % 10000 = s.key AND "
        "b.price > 100"),
}


@pytest.fixture(scope="module")
def engine():
    eng = Engine(PlannerConfig(chunk_capacity=64), device="cpu")
    eng.execute(SOURCES.format(rate="1000000"))
    eng.execute(GEN)
    eng.execute(TABLES)
    return eng


def _select(sql: str):
    if "MATERIALIZED VIEW" not in sql:
        sql = f"CREATE MATERIALIZED VIEW m AS {sql};"
    return parse(sql)[0].query


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_cuda_plan_refuses_what_its_kernels_lack(engine, case):
    sql, kernel = REFUSED[case]
    select = _select(sql)
    Planner(engine.catalog, engine.config, "cpu").plan(select)
    with pytest.raises(PlanError, match=kernel):
        Planner(engine.catalog, engine.config, "cuda").plan(select)


@pytest.mark.parametrize("case", sorted(JOIN_REFUSED))
def test_cuda_plan_refuses_join_leaf_limits(engine, case):
    sql, extra, kernel = JOIN_REFUSED[case]
    select = _select(sql)
    config = PlannerConfig(chunk_capacity=64, **extra)
    Planner(engine.catalog, config, "cpu").plan(select)
    with pytest.raises(PlanError, match=kernel):
        Planner(engine.catalog, config, "cuda").plan(select)


@pytest.mark.parametrize("case", sorted(PLANNED))
def test_cuda_plans_what_the_card_runs(engine, case):
    select = _select(PLANNED[case])
    Planner(engine.catalog, engine.config, "cuda").plan(select)
    Planner(engine.catalog, engine.config, "cpu").plan(select)


def test_cuda_plans_emit_on_window_close(engine):
    """q7_eowc plans for CUDA (K7e over the TIMESTAMP window key) as the
    reference plans it: the aggregation emits on window close into the
    append-only ring."""
    stmt = parse(
        "CREATE MATERIALIZED VIEW m AS SELECT auction, window_start, "
        "max(price) AS max_price, count(*) AS bids FROM TUMBLE(bid, "
        "date_time, INTERVAL '1' SECOND) GROUP BY auction, window_start "
        "EMIT ON WINDOW CLOSE;")[0]
    assert stmt.emit_on_window_close
    for device in ("cuda", "cpu"):
        plan = Planner(engine.catalog, engine.config, device).plan(
            stmt.query, eowc=True)
        names = [type(x).__name__ for x in plan.fragment.executors]
        assert names[-3:] == ["HashAggExecutor", "ProjectExecutor",
                              "AppendOnlyMaterialize"]
        assert plan.fragment.executors[-3].emit_on_window_close


@pytest.mark.parametrize("case", sorted(TEMPORAL_ERRORS))
def test_temporal_join_plan_errors(engine, case):
    sql, words = TEMPORAL_ERRORS[case]
    for device in ("cpu", "cuda"):
        with pytest.raises(PlanError, match=words):
            Planner(engine.catalog, engine.config, device).plan(_select(sql))


def test_temporal_join_plan_shape(engine):
    """q13 plans the reference's DAG: the bid source and the table as
    sources (probe first), bid's watermark filter, the temporal join on
    ``auction % 10000`` over the pk, then the projection into a ring (the
    probe side is append-only); the two-column pk takes its keys in pk
    order; a residual ON conjunct filters after the join."""
    from risingwave_tpu_torch.stream.dag import TemporalJoinNode

    def plan_of(case):
        return Planner(engine.catalog, engine.config, "cuda").plan(
            _select(PLANNED[case]))

    plan = plan_of("q13")
    assert list(plan.sources) == ["b", "s"]
    node = plan.nodes[1]
    assert isinstance(node, TemporalJoinNode)
    assert (node.left, node.right) == (("node", 0), ("source", "s"))
    assert node.join.join_type == "inner"
    assert [type(x).__name__ for x in plan.nodes[2].fragment.executors] == \
        ["ProjectExecutor", "AppendOnlyMaterialize"]
    join = plan_of("temporal_two_col_pk").nodes[1].join
    assert [repr(k) for k in join.left_keys] == ["$0", "$4"]
    assert join.right_mat.pk_indices == (0, 1)
    plan = plan_of("temporal_residual")
    assert plan.nodes[1].join.join_type == "left_outer"
    assert [type(x).__name__ for x in plan.nodes[2].fragment.executors] == \
        ["FilterExecutor"]


def test_engine_refuses_at_create_on_its_device(engine):
    """The engine's planner takes the engine's device: the refusal comes
    at CREATE MATERIALIZED VIEW, before any job exists."""
    assert engine.planner.device.type == "cpu"
    n = len(engine.jobs)
    engine.planner.device = engine.planner.device.__class__("cuda")
    try:
        with pytest.raises(PlanError, match="K17"):
            engine.execute(f"CREATE MATERIALIZED VIEW r AS {_topn('f')};")
    finally:
        engine.planner.device = engine.planner.device.__class__("cpu")
    assert len(engine.jobs) == n and "r" not in engine.catalog


#: the reference's sink and cascade PlanErrors, word for word
#: (planner.py:949-951, :866-869), for the CPU and for CUDA
SINK_ERRORS = {
    "window_function_sink": (
        "SELECT auction, row_number() OVER (PARTITION BY auction ORDER BY "
        "date_time) AS rn FROM bid", True,
        "window functions with sinks/EOWC: next round"),
    "from_a_sink": ("SELECT k FROM s_blackhole", False,
                    "s_blackhole is not a streaming source or materialized "
                    "view"),
}


@pytest.fixture(scope="module")
def sink_engine():
    eng = Engine(PlannerConfig(chunk_capacity=64), device="cpu")
    eng.execute(SOURCES.format(rate="1000000"))
    eng.execute(GEN)
    eng.execute("CREATE SINK s_blackhole AS SELECT k FROM t WHERE k > 0 "
                "WITH (connector = 'blackhole');")
    eng.execute("CREATE MATERIALIZED VIEW q5 AS SELECT auction, "
                "window_start, count(*) AS bids FROM HOP(bid, date_time, "
                "INTERVAL '2' SECOND, INTERVAL '10' SECOND) GROUP BY "
                "auction, window_start;")
    return eng


@pytest.mark.parametrize("case", sorted(SINK_ERRORS))
def test_sink_and_cascade_plan_errors(sink_engine, case):
    from risingwave_tpu_torch.connector.sinks import BlackholeSink

    sql, to_sink, words = SINK_ERRORS[case]
    for device in ("cpu", "cuda"):
        planner = Planner(sink_engine.catalog, sink_engine.config, device)
        with pytest.raises(PlanError, match=words):
            planner.plan(_select(sql),
                         sink=BlackholeSink() if to_sink else None)


def test_cuda_sink_refusal(sink_engine):
    """K22b takes 16 value leaves: a sink of w's 19 (a string is two)
    plans for the CPU and is refused for CUDA; the sink tail projects the
    hidden stream-key columns away."""
    from risingwave_tpu_torch.connector.sinks import BlackholeSink

    select = _select("SELECT * FROM w")
    Planner(sink_engine.catalog, sink_engine.config, "cpu").plan(
        select, sink=BlackholeSink())
    with pytest.raises(PlanError, match="a sink row of 19 value leaves "
                       r"\(K22b takes 16\) \(on CUDA; the CPU runs it\)"):
        Planner(sink_engine.catalog, sink_engine.config, "cuda").plan(
            select, sink=BlackholeSink())
    plan = Planner(sink_engine.catalog, sink_engine.config, "cuda").plan(
        _select("SELECT auction, bids FROM q5 WHERE bids > 3"),
        sink=BlackholeSink())
    names = [type(x).__name__ for x in plan.nodes[0].fragment.executors]
    assert names == ["FilterExecutor", "ProjectExecutor", "ProjectExecutor",
                     "SinkExecutor"]
    assert plan.nodes[0].fragment.executors[-1].in_schema.names() == \
        ["auction", "bids"]


def test_cuda_plans_a_cascade(sink_engine):
    """An MV over an MV plans for CUDA as the reference's cascade: one
    fragment node on an ``MvTap``, retractable because q5 is (keyed by
    q5's stream key), into an MV."""
    from risingwave_tpu_torch.sql.planner import DagPlan, MvTap

    plan = Planner(sink_engine.catalog, sink_engine.config, "cuda").plan(
        _select("SELECT auction, window_start, bids FROM q5 WHERE bids >= 3"))
    assert isinstance(plan, DagPlan)
    assert plan.sources == {"q5": MvTap("q5")}
    assert plan.nodes[0].input == ("source", "q5")
    mv = plan.nodes[0].fragment.executors[plan.mv_index]
    assert type(mv).__name__ == "MaterializeExecutor"
    assert mv.pk_indices == (0, 1)
