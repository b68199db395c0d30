"""Port parity: the sink (``stream/sink.py``, K22b's plain version), the
sink connectors and the append-only dedup (K19b).

The same numpy-seeded chunks go through the reference's and the port's
``SinkExecutor``: columns of int64, NUMERIC (a scaled int64), a nullable
int64 and a nullable VARCHAR(8) with random bytes past each length, ops
of all four kinds and random invalid rows, into a 64-row ring that the
chunks wrap.  After every chunk every state leaf must be equal
(``sink_append_plain`` against the reference's ``apply``).  ``deliver``
must hand both connectors the same column names, ops and rows (strings,
NULLs and NUMERIC decoded) and leave the same ``read_cursor``, raise the
same "ring lapped" error, and the file sinks must write the same bytes,
jsonl and csv.  The dedup runs the reference's ``tests/test_top_n.py``
case, then a watermark eviction (the K4 sweep's plain version) and a
rehash past a quarter of tombstones, state for state.  Tolerance: none
(every leaf is an integer or a byte; NUMERIC decodes by the same float64
division on both sides).
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.common.chunk import (
    Chunk as JChunk,
    NCol as JNCol,
    StrCol as JStrCol,
)
from risingwave_tpu.common.types import (
    DataType as JDT,
    Field as JField,
    Schema as JSchema,
)
from risingwave_tpu.connector.sinks import (
    BlackholeSink as JBlackhole,
    FileSink as JFileSink,
)
from risingwave_tpu.expr.node import InputRef as JRef
from risingwave_tpu.stream.message import Watermark as JWatermark
from risingwave_tpu.stream.sink import SinkExecutor as JSinkExecutor
from risingwave_tpu.stream.top_n import (
    AppendOnlyDedupExecutor as JDedup,
)
from risingwave_tpu_torch.common.chunk import Chunk, NCol, StrCol
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.compat import state_mismatches
from risingwave_tpu_torch.connector.sinks import (
    SINK_REGISTRY,
    BlackholeSink,
    FileSink,
    create_sink,
)
from risingwave_tpu_torch.expr.node import InputRef
from risingwave_tpu_torch.stream.message import Watermark
from risingwave_tpu_torch.stream.sink import (
    SinkExecutor,
    sink_append_plain,
)
from risingwave_tpu_torch.stream.top_n import (
    AppendOnlyDedupExecutor,
    DedupState,
)

CAP = 24
RING = 64
W = 8
#: (name, type, nullable)
COLS = (("k", "INT64", False), ("p", "DECIMAL", False),
        ("n", "INT64", True), ("s", "VARCHAR", True))


def _schemas(cols=COLS):
    def field(cls_f, cls_t, name, t, nullable):
        kw = {"str_width": W} if t == "VARCHAR" else {}
        return cls_f(name, getattr(cls_t, t), nullable=nullable, **kw)

    return (JSchema(tuple(field(JField, JDT, *c) for c in cols)),
            Schema(tuple(field(Field, DataType, *c) for c in cols)))


def _chunk_pair(rng, cols=COLS, cap=CAP, valid_p=0.7):
    """(reference chunk, port chunk) of the same random rows."""
    jschema, schema = _schemas(cols)
    jcols, tcols = [], []
    for _, t, nullable in cols:
        if t == "VARCHAR":
            data = rng.integers(0, 256, (cap, W), dtype=np.uint8)
            lens = rng.integers(0, W + 1, cap).astype(np.int32)
            jc = JStrCol(jnp.asarray(data), jnp.asarray(lens))
            tc = StrCol(torch.from_numpy(data.copy()),
                        torch.from_numpy(lens.copy()))
        else:
            v = rng.integers(-10**12, 10**12, cap).astype(np.int64)
            jc, tc = jnp.asarray(v), torch.from_numpy(v.copy())
        if nullable:
            null = rng.random(cap) < 0.3
            jc = JNCol(jc, jnp.asarray(null))
            tc = NCol(tc, torch.from_numpy(null.copy()))
        jcols.append(jc)
        tcols.append(tc)
    ops = rng.integers(0, 4, cap).astype(np.int8)
    valid = rng.random(cap) < valid_p
    return (JChunk(tuple(jcols), jnp.asarray(ops), jnp.asarray(valid),
                   jschema),
            Chunk(tcols, torch.from_numpy(ops.copy()),
                  torch.from_numpy(valid.copy()), schema))


class Recorder:
    """A connector that records what it was handed."""

    def __init__(self):
        self.batches = []
        self.commits = []

    def write_batch(self, column_names, ops, rows):
        self.batches.append((list(column_names), [int(o) for o in ops],
                             [tuple(r) for r in rows]))

    def commit(self, epoch):
        self.commits.append(epoch)

    def close(self):
        pass


def _pair(ring=RING, sinks=(None, None)):
    jschema, schema = _schemas()
    jsink = JSinkExecutor(jschema, sinks[0] or Recorder(), ring_size=ring)
    tsink = SinkExecutor(schema, sinks[1] or Recorder(), ring_size=ring)
    return jsink, tsink


def test_sink_append_matches_reference_across_a_wrap():
    rng = np.random.default_rng(22)
    jsink, tsink = _pair()
    jst, tst = jsink.init_state(), tsink.init_state("cpu")
    for step in range(8):
        jc, tc = _chunk_pair(rng)
        jst, jout = jsink.apply(jst, jc)
        tst, tout = tsink.apply(tst, tc)
        assert jout is None and tout is None
        bad = state_mismatches(jst, tst)
        assert not bad, (step, bad)
    assert int(tst.cursor) > RING  # the ring wrapped
    assert int(tst.overflow) == 0


def test_sink_append_plain_takes_a_chunk_wider_than_the_ring():
    """A backfill chunk has the upstream table's capacity: with at most
    ``ring`` visible rows it appends them all, as the reference does."""
    rng = np.random.default_rng(5)
    jsink, tsink = _pair(ring=16)
    jst, tst = jsink.init_state(), tsink.init_state("cpu")
    jc, tc = _chunk_pair(rng, cap=64, valid_p=0.2)
    n = int(tc.valid.sum())
    assert 0 < n <= 16
    jst, _ = jsink.apply(jst, jc)
    sink_append_plain(tst.values, tst.ops, tst.cursor, tc, 16)
    assert not state_mismatches(jst, tst)
    assert int(tst.cursor) == n


def test_deliver_matches_reference():
    rng = np.random.default_rng(7)
    jsink, tsink = _pair(ring=128)
    jst, tst = jsink.init_state(), tsink.init_state("cpu")
    epoch = 1 << 16
    for rounds in (2, 0, 3):
        for _ in range(rounds):
            jc, tc = _chunk_pair(rng)
            jst, _ = jsink.apply(jst, jc)
            tst, _ = tsink.apply(tst, tc)
        jst = jsink.deliver(jst, epoch)
        tst = tsink.deliver(tst, epoch)
        epoch += 1 << 16
        assert int(jst.read_cursor) == int(tst.read_cursor)
        assert not state_mismatches(jst, tst)
    jrec, trec = jsink.sink, tsink.sink
    assert trec.batches == jrec.batches
    assert trec.commits == jrec.commits
    assert len(trec.batches) == 2  # the empty round delivers no batch
    names, ops, rows = trec.batches[0]
    assert names == ["k", "p", "n", "s"]
    assert any(r[2] is None for r in rows) and any(r[3] is None for r in rows)
    assert isinstance(rows[0][1], np.float64)
    # no commit marker when the caller commits
    tst = tsink.deliver(tst, epoch, commit=False)
    assert len(trec.commits) == 3


def test_deliver_raises_when_the_ring_lapped():
    rng = np.random.default_rng(9)
    jsink, tsink = _pair(ring=16)
    jst, tst = jsink.init_state(), tsink.init_state("cpu")
    for _ in range(3):
        jc, tc = _chunk_pair(rng, valid_p=1.0)
        jst, _ = jsink.apply(jst, jc)
        tst, _ = tsink.apply(tst, tc)
    with pytest.raises(RuntimeError) as jerr:
        jsink.deliver(jst, 1)
    with pytest.raises(RuntimeError) as terr:
        tsink.deliver(tst, 1)
    assert str(terr.value) == str(jerr.value)
    assert "sink ring lapped (56 rows lost)" in str(terr.value)


@pytest.mark.parametrize("fmt", ["jsonl", "csv"])
def test_file_sink_writes_the_references_bytes(tmp_path, fmt):
    rng = np.random.default_rng(11)
    paths = (tmp_path / f"ref.{fmt}", tmp_path / f"port.{fmt}")
    jsink, tsink = _pair(ring=128, sinks=(
        JFileSink(str(paths[0]), format=fmt),
        FileSink(str(paths[1]), format=fmt)))
    jst, tst = jsink.init_state(), tsink.init_state("cpu")
    for epoch in (5, 6, 7):
        jc, tc = _chunk_pair(rng)
        jst, _ = jsink.apply(jst, jc)
        tst, _ = tsink.apply(tst, tc)
        jst = jsink.deliver(jst, epoch)
        tst = tsink.deliver(tst, epoch)
    jsink.sink.close()
    tsink.sink.close()
    want, got = paths[0].read_bytes(), paths[1].read_bytes()
    assert got == want
    assert got.count(b"commit") == 3
    # append mode: a reopened sink continues the file
    again = FileSink(str(paths[1]), format=fmt)
    again.commit(8)
    again.close()
    assert paths[1].read_bytes().startswith(want)


def test_blackhole_counts_and_the_registry():
    rng = np.random.default_rng(3)
    jsink, tsink = _pair(ring=128, sinks=(JBlackhole(), BlackholeSink()))
    jst, tst = jsink.init_state(), tsink.init_state("cpu")
    for epoch in (1, 2):
        jc, tc = _chunk_pair(rng)
        jst, _ = jsink.apply(jst, jc)
        tst, _ = tsink.apply(tst, tc)
        jst = jsink.deliver(jst, epoch)
        tst = tsink.deliver(tst, epoch)
    assert tsink.sink.rows_written == jsink.sink.rows_written == \
        int(tst.cursor)
    assert tsink.sink.commits == jsink.sink.commits == 2
    assert sorted(SINK_REGISTRY) == ["blackhole", "file"]
    assert isinstance(create_sink({"connector": "blackhole"}), BlackholeSink)
    with pytest.raises(ValueError, match="unsupported sink connector"):
        create_sink({"connector": "kafka"})


# ---------------------------------------------------------------------------
# K19b: AppendOnlyDedupExecutor

DEDUP_COLS = (("g", "INT64", False), ("v", "INT64", False))


def _rows_pair(rows, cap=8):
    jschema, schema = _schemas(DEDUP_COLS)
    arrs = [np.array([r[i] for r in rows], np.int64) for i in range(2)]
    return (JChunk.from_numpy(jschema, arrs, capacity=cap),
            Chunk.from_numpy(schema, arrs, capacity=cap))


def _visible(chunk) -> list:
    return sorted(tuple(int(x) for x in r) for r in chunk.to_rows())


def _dedup_pair(table_size: int, **kw):
    jschema, schema = _schemas(DEDUP_COLS)
    return (JDedup(jschema, [JRef(0)], table_size=table_size, **kw),
            AppendOnlyDedupExecutor(schema, [InputRef(0)],
                                    table_size=table_size, **kw))


def test_dedup_matches_reference():
    """The reference's ``tests/test_top_n.py`` case: the first row of each
    key survives, within a chunk and across chunks."""
    jd, td = _dedup_pair(64)
    jst, tst = jd.init_state(), td.init_state("cpu")
    outs = []
    for rows in ([(1, 10), (1, 11), (2, 20)], [(1, 12), (3, 30)]):
        jc, tc = _rows_pair(rows)
        jst, jout = jd.apply(jst, jc)
        tst, tout = td.apply(tst, tc)
        assert _visible(tout) == _visible(jout)
        assert not state_mismatches(jst, tst)
        outs.append(_visible(tout))
    assert outs == [[(0, 1, 10), (0, 2, 20)], [(0, 3, 30)]]


def test_dedup_watermark_eviction_and_rehash():
    """Keys below the watermark leave through ``clear_where``; with more
    than a quarter of the table tombstoned, ``maybe_rehash`` rebuilds it
    (the port reads the count once), and an evicted key is first-seen
    again; a full table counts its overflow."""
    jd, td = _dedup_pair(64, watermark_key_idx=0, watermark_lag=5)
    jst, tst = jd.init_state(), td.init_state("cpu")
    rng = np.random.default_rng(19)
    keys = rng.permutation(60)[:40]
    for part in np.array_split(keys, 5):
        rows = [(int(k), int(k) * 3) for k in part]
        jc, tc = _rows_pair(rows)
        jst, _ = jd.apply(jst, jc)
        tst, _ = td.apply(tst, tc)
    assert not state_mismatches(jst, tst)
    jst = jd.on_watermark(jst, JWatermark(0, jnp.int64(40)))
    tst = td.on_watermark(tst, Watermark(0, torch.tensor(40)))
    assert not state_mismatches(jst, tst)
    assert int(tst.table.tombstone_count()) > 16
    jst = jd.maybe_rehash(jst)
    tst = td.maybe_rehash(tst)
    assert int(tst.table.tombstone_count()) == 0
    assert not state_mismatches(jst, tst)
    # an evicted key is new again; a kept one is still a duplicate
    evicted = int(min(k for k in keys if k < 35))
    kept = int(max(keys))
    jc, tc = _rows_pair([(evicted, 1), (kept, 2)])
    jst, jout = jd.apply(jst, jc)
    tst, tout = td.apply(tst, tc)
    assert _visible(tout) == _visible(jout) == [(0, evicted, 1)]
    # a watermark on another column evicts nothing
    _, td2 = _dedup_pair(64, watermark_key_idx=0, watermark_src_col=1)
    st2 = td2.init_state("cpu")
    assert td2.on_watermark(st2, Watermark(0, torch.tensor(99))) is st2
    # a full table: 70 distinct keys into 64 slots
    jd, td = _dedup_pair(64)
    jst, tst = jd.init_state(), td.init_state("cpu")
    for part in np.array_split(np.arange(70), 10):
        jc, tc = _rows_pair([(int(k), 0) for k in part])
        jst, _ = jd.apply(jst, jc)
        tst, _ = td.apply(tst, tc)
    assert isinstance(tst, DedupState)
    assert int(tst.overflow) == int(jst.overflow) == 6
    assert not state_mismatches(jst, tst)
