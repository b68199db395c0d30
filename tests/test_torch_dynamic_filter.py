"""Port parity: the dynamic filter (``DynamicFilterExecutor``, kernel
K21's plain versions, over K16's plain pool).

The same seeded chunks go through the reference's and the port's
executor, on both sides: left chunks of (k, name, v) rows, inserts and
then deletes of live rows, filtered on ``v`` against the scalar of the
right side's 1-row changelog.  The script sets the threshold (the band
of passing rows is emitted), raises it with an update pair (the band
between retracts), lowers it (the band comes back), sends a chunk of
deletes alone (the scalar empties: every passing row retracts), sets it
again, and finally overflows the 64-row pool.  All five comparisons run
on int64; ``ge`` also on int32 and float64.  After every step the output
chunk (ops, validity, rows) and every state leaf (pool, hashes,
threshold, flag, counters) must be equal.  Tolerance: none — the float
values are exact integers.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import jax
import numpy as np
import pytest

from risingwave_tpu.common.chunk import Chunk as JChunk
from risingwave_tpu.common.types import (
    DataType as JDT,
    Field as JField,
    Schema as JSchema,
)
from risingwave_tpu.stream.dynamic_filter import (
    DynamicFilterExecutor as JDynFilter,
)
from risingwave_tpu_torch.common.chunk import Chunk
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.compat import state_mismatches
from risingwave_tpu_torch.stream.dynamic_filter import DynamicFilterExecutor

CAP, POOL = 16, 64
OPS = {"+": 0, "-": 1, "U-": 2, "U+": 3}


def _schemas(dtype: str):
    cols = [("k", "INT64"), ("name", "VARCHAR"), ("v", dtype)]
    kw = lambda t: {"str_width": 8} if t == "VARCHAR" else {}  # noqa: E731
    left = (JSchema(tuple(JField(n, getattr(JDT, t), **kw(t))
                          for n, t in cols)),
            Schema(tuple(Field(n, getattr(DataType, t), **kw(t))
                         for n, t in cols)))
    right = (JSchema((JField("x", getattr(JDT, dtype)),)),
             Schema((Field("x", getattr(DataType, dtype)),)))
    return left, right


def _chunks(schemas, arrays, ops):
    ops = np.array([OPS[o] for o in ops], np.int8)
    return (JChunk.from_numpy(schemas[0], arrays, ops=ops, capacity=CAP),
            Chunk.from_numpy(schemas[1], arrays, ops=ops, capacity=CAP))


def _script(rng, dtype: str):
    """(side, arrays, ops) steps; see the module docstring."""
    np_t = {"INT64": np.int64, "INT32": np.int32, "FLOAT64": np.float64}[dtype]
    live: list = []
    steps = []

    def left(n_ins, n_del):
        rows, ops = [], []
        for _ in range(min(n_del, len(live))):
            rows.append(live.pop(int(rng.integers(0, len(live)))))
            ops.append("-")
        for _ in range(n_ins):
            r = (int(rng.integers(0, 1000)), f"n{int(rng.integers(0, 50))}",
                 int(rng.integers(0, 20)))
            rows.append(r)
            ops.append("+")
            live.append(r)
        arrays = [np.array([r[0] for r in rows], np.int64),
                  np.array([r[1] for r in rows], object),
                  np.array([r[2] for r in rows], np_t)]
        steps.append(("left", arrays, ops))

    def right(values, ops):
        steps.append(("right", [np.array(values, np_t)], ops))

    left(12, 0)                     # no threshold yet: nothing passes
    right([8], ["+"])               # the band v cmp 8 is emitted
    left(10, 5)                     # deletes and inserts pass through
    right([8, 13], ["U-", "U+"])    # the threshold rises
    right([13, 4], ["U-", "U+"])    # ... and drops
    left(6, 4)
    right([4], ["-"])               # deletes alone: the scalar empties
    left(8, 3)
    right([1, 9, 11], ["+", "-", "+"])  # the last insert-side row wins
    for _ in range(4):
        left(CAP, 0)                # the 64-row pool overflows
    right([11, 10], ["U-", "U+"])
    return steps


def _same_out(jout, tout):
    np.testing.assert_array_equal(np.asarray(jout.valid), tout.valid.numpy())
    np.testing.assert_array_equal(np.asarray(jout.ops), tout.ops.numpy())
    for jc, tc in zip(jout.columns, tout.columns):
        jl = jax.tree_util.tree_leaves(jc)
        tl = list(tc) if isinstance(tc, tuple) else [tc]
        for a, b in zip(jl, tl):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


CASES = [(c, "INT64") for c in ("gt", "ge", "lt", "le", "eq")] + [
    ("ge", "INT32"), ("ge", "FLOAT64")]


@pytest.mark.parametrize("cmp,dtype", CASES)
def test_dynamic_filter_matches_reference(cmp, dtype):
    (jl, tl), (jr, tr) = _schemas(dtype)
    j = JDynFilter(jl, filter_col=2, cmp=cmp, pool_size=POOL)
    t = DynamicFilterExecutor(tl, filter_col=2, cmp=cmp, pool_size=POOL)
    jst, tst = j.init_state(), t.init_state("cpu")
    rng = np.random.default_rng(17)
    moved, emitted = set(), 0
    for side, arrays, ops in _script(rng, dtype):
        jc, tc = _chunks((jl, tl) if side == "left" else (jr, tr), arrays,
                         ops)
        jst, jout = j.apply(jst, jc, side)
        tst, tout = t.apply(tst, tc, side)
        _same_out(jout, tout)
        assert state_mismatches(jax.device_get(jst), tst) == []
        moved.add(float(tst.threshold))
        emitted += int(tout.valid.sum())
    assert len(moved) >= 4 and emitted > 0
    assert int(tst.overflow) > 0 and int(tst.inconsistency) == 0
    assert bool(tst.has_threshold)


def test_dynamic_filter_refuses_mismatched_scalar():
    (jl, tl), _ = _schemas("INT64")
    _, (_, tr32) = _schemas("INT32")
    t = DynamicFilterExecutor(tl, filter_col=2, cmp="ge", pool_size=POOL)
    tc = Chunk.from_numpy(tr32, [np.array([3], np.int32)], capacity=CAP)
    with pytest.raises(ValueError, match="does not match"):
        t.apply(t.init_state("cpu"), tc, "right")
    with pytest.raises(ValueError, match="string"):
        DynamicFilterExecutor(tl, filter_col=1)
