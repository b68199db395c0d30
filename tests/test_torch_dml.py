"""Port parity: DML tables (``connector/dml.py``): ``TableDmlManager`` and
``TableSourceReader``.

The same seeded batches go into the reference's and the port's manager:
inserts with NULLs and strings of every length up to the declared width,
marked deletes (``insert(..., delete=True)`` and ``mark_deletes``), and
batches bigger than a chunk.  Two readers (one created before the
batches, one after, which replays the history) must return equal chunks
(ops, every column leaf, valid), the shape-static empty chunk when idle,
and equal cursors; ``state``/``restore`` rewinds a reader and it replays
the same chunks.  Auto VARCHAR widths must follow the observed maximum
the same way (multiple of 8, never shrinking), and a batch longer than a
running reader's width is refused by both without widening the auto
width.  Tolerance: none.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import jax
import numpy as np
import pytest

from risingwave_tpu.common.types import (
    DataType as JDT,
    Field as JField,
    Schema as JSchema,
)
from risingwave_tpu.connector import dml as jdml
from risingwave_tpu_torch.common.tree import flatten
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.connector import dml

CAP = 8
COLS = [("id", "INT64", False, None), ("name", "VARCHAR", True, 16),
        ("note", "VARCHAR", False, None), ("score", "FLOAT64", True, None),
        ("n", "INT32", False, None)]


def _schemas():
    def fields(cls_f, cls_t):
        return tuple(cls_f(n, getattr(cls_t, t), nullable=nl,
                           **({"str_width": w} if w else {}))
                     for n, t, nl, w in COLS)
    return JSchema(fields(JField, JDT)), Schema(fields(Field, DataType))


def _rows(rng, n, max_note=12):
    out = []
    for _ in range(n):
        out.append((
            int(rng.integers(-10**12, 10**12)),
            None if rng.random() < 0.25 else "x" * int(rng.integers(0, 17)),
            "n" * int(rng.integers(0, max_note + 1)),
            None if rng.random() < 0.25 else float(rng.normal()),
            int(rng.integers(-2**31, 2**31 - 1))))
    return out


def _same_chunk(jc, tc):
    np.testing.assert_array_equal(np.asarray(jc.valid), tc.valid.numpy())
    np.testing.assert_array_equal(np.asarray(jc.ops), tc.ops.numpy())
    jl = jax.tree_util.tree_leaves(tuple(jc.columns))
    tl = flatten(tuple(tc.columns))[0]
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype and a.shape == tuple(b.shape)
        np.testing.assert_array_equal(a, b.numpy())


def _drain(jr, tr, n_chunks):
    for _ in range(n_chunks):
        assert jr.pending() == tr.pending()
        _same_chunk(jr.next_chunk(), tr.next_chunk())
        assert jr.offset == tr.offset and jr.state() == tr.state()


def test_readers_match_reference():
    js, ts = _schemas()
    jm = jdml.TableDmlManager(js, auto_width_cols=[2])
    tm = dml.TableDmlManager(ts, auto_width_cols=[2])
    early = (jm.new_reader(CAP), tm.new_reader(CAP))
    _drain(*early, 1)  # idle: the empty chunk
    rng = np.random.default_rng(9)
    live = []
    for step in range(4):
        rows = _rows(rng, int(rng.integers(3, 2 * CAP + 3)))
        for m in (jm, tm):
            assert m.insert(rows) == len(rows)
        live += rows
        dels = [live.pop(int(rng.integers(0, len(live))))
                for _ in range(step + 1)]
        if step % 2:
            for m in (jm, tm):
                m.insert(dels, delete=True)
        else:
            assert dml.mark_deletes(dels, len(COLS)) == \
                jdml.mark_deletes(dels, len(COLS))
            for m, mod in ((jm, jdml), (tm, dml)):
                m.insert(mod.mark_deletes(dels, len(COLS)))
        _drain(*early, 3)
    assert jm.rows_inserted == tm.rows_inserted
    assert jm.history_slice(0) == tm.history_slice(0)
    # a reader created later replays the whole history
    late = (jm.new_reader(CAP), tm.new_reader(CAP))
    n = -(-len(jm.history_slice(0)) // CAP) + 1
    _drain(*late, n)
    # rewind: the cursor's state restores and the chunks replay
    for r in late:
        r.restore({"offset": 5})
    _drain(*late, n)
    assert [r.pending() for r in late] == [0, 0]
    ops = np.concatenate([tm.new_reader(1 << 10).next_chunk().ops.numpy()])
    assert (ops == 1).sum() == 1 + 2 + 3 + 4


def test_auto_widths_and_refusal():
    js, ts = _schemas()
    jm = jdml.TableDmlManager(js, auto_width_cols=[2])
    tm = dml.TableDmlManager(ts, auto_width_cols=[2])
    rng = np.random.default_rng(3)
    rows = _rows(rng, 5, max_note=70)
    rows[0] = rows[0][:2] + ("n" * 70,) + rows[0][3:]
    for m in (jm, tm):
        m.insert(rows)
    for m in (jm, tm):
        m.refresh_schema()
    widths = [f.str_width for f in tm.schema]
    assert widths == [f.str_width for f in jm.schema] and widths[2] == 72
    readers = (jm.new_reader(CAP), tm.new_reader(CAP))
    _same_chunk(readers[0].next_chunk(), readers[1].next_chunk())
    too_long = [rows[1][:1] + ("y" * 17,) + rows[1][2:]]
    for m in (jm, tm):
        with pytest.raises(ValueError, match="exceeds the width"):
            m.insert(too_long)
    # the refused batch neither lands nor widens the auto width
    wide = [rows[1][:2] + ("n" * 90,) + rows[1][3:]]
    for m in (jm, tm):
        with pytest.raises(ValueError, match="exceeds the width"):
            m.insert(wide)
        assert m.refresh_schema()[2].str_width == 72
    assert jm.history_slice(0) == tm.history_slice(0)


def test_live_rows_fold():
    """``live_rows`` (the engine's UPDATE lookup) folds inserts and marked
    deletes by pk as the reference's ``Engine._update`` does, also across
    batches appended after an earlier call."""
    _, ts = _schemas()
    tm = dml.TableDmlManager(ts)
    a, b = (1, "a", "x", None, 1), (1, "b", "y", 2.0, 2)
    tm.insert([a])
    assert tm.live_rows([0], (1,)) == [a]
    tm.insert([a], delete=True)
    tm.insert([b])
    assert tm.live_rows([0], (1,)) == [b]
    assert tm.live_rows([0], (2,)) == []
    with pytest.raises(NotImplementedError, match="exchange-lite"):
        tm.insert_sparse(0, 1, [])
