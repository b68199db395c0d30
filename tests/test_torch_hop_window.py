"""Port parity: ``HopWindowExecutor`` (kernel K10's plain version).

The same numpy chunks go through the reference executor and the port's
on the CPU: TUMBLE (k = 1) and HOP with k = 5 over chunks that carry
update ops (the pane deltas of the q5 plan), nullable and string
columns, invisible rows and negative timestamps (window starts use the
floor modulo).  Tolerance: none — every column must be identical, row
order included (the reference repeats each row k times, so an update's
U-/U+ halves end up k rows apart).
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import numpy as np
import pytest

from risingwave_tpu.common.chunk import Chunk as JChunk
from risingwave_tpu.common.types import (
    DataType as JDT,
    Field as JField,
    Schema as JSchema,
)
from risingwave_tpu.stream.executor import HopWindowExecutor as JHop
from risingwave_tpu_torch.common.chunk import Chunk
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.stream.executor import (
    HopWindowExecutor,
    hop_window_plain,
)

CAP = 48
COLS = [("auction", "INT64", False), ("ts", "TIMESTAMP", False),
        ("bids", "INT64", True), ("url", "VARCHAR", True)]


def _chunks(rng, ts_lo, ts_hi):
    jschema = JSchema(tuple(JField(n, getattr(JDT, t), nullable=nl)
                            for n, t, nl in COLS))
    tschema = Schema(tuple(Field(n, getattr(DataType, t), nullable=nl)
                           for n, t, nl in COLS))
    n = CAP - 5
    auction = rng.integers(1000, 1100, n).astype(np.int64)
    ts = rng.integers(ts_lo, ts_hi, n).astype(np.int64)
    bids = np.asarray([None if v < 0.2 else int(v * 50)
                       for v in rng.random(n)], object)
    url = np.asarray([None if v < 0.2 else f"https://x/{int(v * 1e4)}"
                      for v in rng.random(n)], object)
    ops = np.zeros(n, np.int8)
    ops[0::2], ops[1::2] = 2, 3              # U-/U+ pairs
    ops[-3:] = [0, 1, 0]
    arrays = [auction, ts, bids, url]
    return (jschema, tschema,
            JChunk.from_numpy(jschema, arrays, ops, capacity=CAP),
            Chunk.from_numpy(tschema, arrays, ops, capacity=CAP))


def _assert_same_chunk(jc, tc):
    assert jc.capacity == tc.capacity
    assert jc.schema.names() == tc.schema.names()
    np.testing.assert_array_equal(np.asarray(jc.ops), tc.ops.numpy())
    np.testing.assert_array_equal(np.asarray(jc.valid), tc.valid.numpy())
    assert jc.to_rows() == tc.to_rows()


@pytest.mark.parametrize("slide,size", [
    (2_000_000, 10_000_000),     # q5's HOP, k = 5
    (7, 35),                     # k = 5, small slide: many boundaries
    (10_000_000, 10_000_000),    # TUMBLE, k = 1
])
@pytest.mark.parametrize("ts_lo,ts_hi", [
    (1_436_918_400_000_000, 1_436_918_460_000_000),
    (-50_000_000, 50_000_000),   # negative timestamps: floor modulo
])
def test_hop_window_identical(slide, size, ts_lo, ts_hi):
    rng = np.random.default_rng(slide + ts_lo % 97)
    jschema, tschema, jc, tc = _chunks(rng, ts_lo, ts_hi)
    jex, tex = JHop(jschema, 1, slide, size), HopWindowExecutor(
        tschema, 1, slide, size)
    _, jout = jex.apply((), jc)
    _, tout = tex.apply((), tc)
    _assert_same_chunk(jout, tout)
    assert tout.capacity == CAP * (size // slide)
    ws = tout.columns[-2].numpy()
    ts = np.repeat(tc.columns[1].numpy(), size // slide)
    assert ((ts - ws >= 0) & (ts - ws < size)).all()


def test_hop_window_plain_keeps_tensors_for_a_tumble():
    rng = np.random.default_rng(3)
    _, _, _, tc = _chunks(rng, -100, 100)
    cols, ops, valid, ws, we = hop_window_plain(
        tc.columns, tc.ops, tc.valid, tc.columns[1], 1, 10, 10)
    assert cols is tc.columns and ops is tc.ops and valid is tc.valid
    assert (we - ws == 10).all()
