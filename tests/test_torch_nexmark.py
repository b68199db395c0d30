"""Port parity: the Nexmark generator and split reader.

The same ``(k0, cap)`` goes to the reference generator and the port's
on the CPU.  Tolerance: none — every column, prices included, must be
byte-identical (prices are float64 ``round(10**(u*6) * 100)``; the
last bits of ``pow`` may differ, the rounded prices may not).
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import numpy as np
import pytest

from risingwave_tpu.connector.nexmark import (
    NexmarkConfig as JConfig,
    NexmarkGenerator as JGen,
    NexmarkSplitReader as JReader,
)
from risingwave_tpu.common.chunk import StrCol as JStrCol
from risingwave_tpu_torch.connector.nexmark import (
    NexmarkConfig,
    NexmarkGenerator,
    NexmarkSplitReader,
)


def _assert_chunks_equal(jc, tc):
    assert jc.schema.names() == tc.schema.names()
    np.testing.assert_array_equal(np.asarray(jc.ops), tc.ops.numpy())
    np.testing.assert_array_equal(np.asarray(jc.valid), tc.valid.numpy())
    for name, a, b in zip(jc.schema.names(), jc.columns, tc.columns):
        if isinstance(a, JStrCol):
            np.testing.assert_array_equal(np.asarray(a.data), b.data.numpy(),
                                          err_msg=name)
            np.testing.assert_array_equal(np.asarray(a.lens), b.lens.numpy(),
                                          err_msg=name)
        else:
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=name)


@pytest.mark.parametrize("table", ["bids", "auctions", "persons"])
@pytest.mark.parametrize("k0,cap,inter,seed", [
    (0, 512, 10, 0),
    (123_457, 300, 1, 0),
    (10**9 + 7, 256, 500_000, 3),
])
def test_chunks_byte_identical(table, k0, cap, inter, seed):
    jg = JGen(JConfig(inter_event_us=inter, seed=seed))
    tg = NexmarkGenerator(NexmarkConfig(inter_event_us=inter, seed=seed),
                          device="cpu")
    _assert_chunks_equal(getattr(jg, f"gen_{table}")(k0, cap),
                         getattr(tg, f"gen_{table}")(k0, cap))


def test_price_exact_over_a_million_events():
    n = 1 << 20
    want = np.asarray(JGen().gen_bids(0, n).columns[2])
    got = NexmarkGenerator(device="cpu").gen_bids(0, n).columns[2].numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("split_id,num_splits", [(0, 1), (1, 3)])
def test_split_reader_sequence_and_offsets(split_id, num_splits):
    jr = JReader("bid", JGen(), chunk_capacity=128, split_id=split_id,
                 num_splits=num_splits)
    tr = NexmarkSplitReader("bid", NexmarkGenerator(device="cpu"),
                            chunk_capacity=128,
                            split_id=split_id, num_splits=num_splits)
    for _ in range(3):
        _assert_chunks_equal(jr.next_chunk(), tr.next_chunk())
        assert jr.state() == tr.state()
    assert tr.events_per_row == jr.events_per_row


@pytest.mark.parametrize("table,cols", [
    ("auctions", (0, 7, 4, 6, 5)),   # q8's declared auction columns
    ("persons", (0, 1, 6)),          # q8's declared person columns
    ("auctions", (8, 1, 2, 3)),
    ("persons", (5, 4, 3, 2)),
])
def test_projected_columns_equal_the_reference(table, cols):
    """The generators make only a source's declared columns, in its
    order: equal to the reference's full chunk projected."""
    jg = JGen(JConfig(inter_event_us=1, seed=2))
    tg = NexmarkGenerator(NexmarkConfig(inter_event_us=1, seed=2),
                          device="cpu")
    _assert_chunks_equal(
        getattr(jg, f"gen_{table}")(40_961, 256).project(list(cols)),
        getattr(tg, f"gen_{table}")(40_961, 256, cols))


def test_split_reader_projects_auctions_and_persons():
    for table, cols in (("auction", [0, 7, 4, 6, 5]), ("person", [0, 1, 6])):
        jr = JReader(table, JGen(), chunk_capacity=128)
        tr = NexmarkSplitReader(table, NexmarkGenerator(device="cpu"),
                                chunk_capacity=128)
        for _ in range(2):
            _assert_chunks_equal(jr.next_chunk().project(cols),
                                 tr.next_chunk(cols))
        assert jr.state() == tr.state()
