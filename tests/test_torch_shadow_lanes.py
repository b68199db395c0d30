"""Port parity: K11 lanes' plain versions against the reference.

A lane-stacked state (every leaf ``[rows, ...]``, the sharded ``DagJob``'s
tree) digests per lane: ``lane_block_count``, ``leaf_lanes`` and
``leaf_digest_lanes`` must equal ``risingwave_tpu.storage.digest``'s and
``risingwave_tpu.stream.shadow``'s for every dtype a state holds (bool,
int8, uint8, int16, int32, int64, float32, float64 with nan, ±inf and
subnormals), rows whose length is not a multiple of the block or of the
packing factor, and small leaves (``rows * nb_row <= 8`` or fewer than
2 full blocks over the rows: copied whole, counted 0).  The same seeded
mutation sequence then goes through both ``ShadowSnapshot(shard_rows=N)``:
after every update the digest vector, the shadow contents,
``dirty_blocks`` and ``.lanes`` must be equal; and ``CheckpointStore``
must stage the same epochs from both shadows' digests: a full, then lane
deltas whose kind and every payload member (``r_{leaf}_{start}``, runs cut
row by row) are equal, key for key and byte for byte.  Tolerance: none.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.storage import digest as R
from risingwave_tpu.storage.checkpoint_store import (
    CheckpointStore as JStore,
)
from risingwave_tpu.stream.shadow import (
    ShadowSnapshot as JShadow,
    leaf_lanes as j_leaf_lanes,
)
from risingwave_tpu_torch.storage import digest as P
from risingwave_tpu_torch.storage.checkpoint_store import CheckpointStore
from risingwave_tpu_torch.stream.shadow import ShadowSnapshot, leaf_lanes

BLOCK = 64
ROWS = 4
DTYPES = [np.bool_, np.int8, np.uint8, np.int16, np.int32, np.int64,
          np.float32, np.float64]
#: row shapes: ragged against the block and the packing, exact, tiny, 2-D
ROW_SHAPES = [(77,), (3, 45), (130,), (129,), (128,), (5,), (0,), (1000,)]
#: the digest's ragged cases (each shape compiles a reference program)
DIGEST_SHAPES = [(77,), (3, 45), (129,), (0,)]


def _data(dt, shape, rng):
    if dt == np.bool_:
        return rng.integers(0, 2, shape).astype(dt)
    if dt == np.float32:
        return rng.standard_normal(shape).astype(dt)
    if dt == np.float64:
        a = rng.standard_normal(shape)
        flat = a.reshape(-1)
        for i, v in enumerate([np.nan, np.inf, -np.inf, 5e-324, -0.0]):
            if i < flat.size:
                flat[i] = v
        return a
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, shape, dtype=dt, endpoint=True)


@pytest.mark.parametrize("row_shape", ROW_SHAPES, ids=str)
def test_lane_counts_and_grid_equal_reference(row_shape):
    shape = (ROWS,) + row_shape
    assert P.lane_block_count(shape, ROWS, BLOCK) == \
        R.lane_block_count(shape, ROWS, BLOCK)
    assert leaf_lanes(shape, ROWS) == j_leaf_lanes(shape, ROWS)
    assert leaf_lanes(shape, ROWS + 1) == j_leaf_lanes(shape, ROWS + 1) \
        is None
    assert leaf_lanes((), ROWS) is None and leaf_lanes(shape, None) is None


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
def test_leaf_digest_lanes_equals_reference(dt):
    rng = np.random.default_rng(11)
    for row_shape in DIGEST_SHAPES:
        a = _data(dt, (ROWS,) + row_shape, rng)
        ref = np.asarray(R.leaf_digest_lanes(jnp.asarray(a), ROWS, BLOCK))
        port = P.leaf_digest_lanes(torch.from_numpy(a.copy()), ROWS,
                                   BLOCK).numpy()
        assert np.array_equal(port.view(np.uint64), ref), row_shape


def _tree(rng):
    """Lane leaves of every dtype and row shape, two flat leaves."""
    leaves = [_data(dt, (ROWS,) + rs, rng)
              for dt, rs in zip(DTYPES, ROW_SHAPES)]
    leaves.append(_data(np.int64, (ROWS, 700), rng))   # ladder, tail
    leaves.append(_data(np.int32, (ROWS, 2, 96), rng))  # 2-D rows
    leaves.append(_data(np.int64, (300,), rng))         # flat
    leaves.append(np.array(7, np.int64))                # scalar
    return leaves


def _mutate(leaves, rng, step):
    """Step 0: nothing; 1: one row's tail; else a few scattered writes
    and one whole row."""
    if step == 1:
        leaves[8][2, -3:] += 1
        return
    if step == 0:
        return
    for x in leaves:
        flat = x.reshape(-1)
        if flat.size == 0:
            continue
        idx = rng.integers(0, flat.size, max(1, flat.size // 97))
        if x.dtype == np.bool_:
            flat[idx] = ~flat[idx]
        else:
            flat[idx] = _data(x.dtype.type, idx.shape, rng)
    if leaves[9].ndim:
        leaves[9][step % ROWS] = _data(np.int32, leaves[9].shape[1:], rng)


def _assert_equal(js, ts):
    assert ts.lanes == js.lanes and ts.shard_rows == js.shard_rows
    assert ts.nblocks == js.nblocks and ts.total_blocks == js.total_blocks
    for r, p in zip(js.leaves, ts.leaves):
        r = np.asarray(r)
        assert np.array_equal(r.view(np.uint8), p.numpy().view(np.uint8))
    assert np.array_equal(np.asarray(js.digests),
                          ts.digests.numpy().view(np.uint64))
    assert int(js.dirty_blocks) == int(ts.dirty_blocks)


def _payload(prep):
    return {k: (v.dtype.str, np.ascontiguousarray(v).view(np.uint8)
                .tobytes()) for k, v in prep["payload"].items()}


def test_shadow_lanes_and_store_deltas_equal_reference(tmp_path):
    rng = np.random.default_rng(5)
    leaves = _tree(rng)
    js = JShadow(tuple(jnp.asarray(x) for x in leaves), block_elems=BLOCK,
                 shard_rows=ROWS)
    ts = ShadowSnapshot(tuple(torch.from_numpy(x.copy()) for x in leaves),
                        block_elems=BLOCK, shard_rows=ROWS)
    _assert_equal(js, ts)
    assert sum(ln is not None for ln in ts.lanes) == len(leaves) - 2
    jstore = JStore(str(tmp_path / "ref"), block_elems=BLOCK)
    tstore = CheckpointStore(str(tmp_path / "port"), block_elems=BLOCK)
    kinds = []
    for step in range(6):
        _mutate(leaves, rng, step)
        jd = js.update(tuple(jnp.asarray(x) for x in leaves), step + 1)
        td = ts.update(tuple(torch.from_numpy(x.copy()) for x in leaves),
                       step + 1)
        _assert_equal(js, ts)
        jp = jstore.prepare("v", step + 1, js.leaves, js.shapes, None, {},
                            digests=jd, lanes=js.lanes)
        tp = tstore.prepare("v", step + 1, ts.leaves, ts.shapes, None, {},
                            digests=td, lanes=ts.lanes)
        assert tp["kind"] == jp["kind"]
        assert _payload(tp) == _payload(jp)
        kinds.append(tp["kind"])
        jp["treedef"] = tp["treedef"] = ts.treedef
        jstore.commit(jp)
        tstore.commit(tp)
    assert kinds[0] == "full" and kinds.count("delta") >= 3, kinds
    # the restored tree is the live one
    for x, y in zip(leaves, tstore.load("v")[1]):
        assert np.array_equal(np.asarray(x).reshape(-1).view(np.uint8),
                              y.numpy().reshape(-1).view(np.uint8))


def test_small_lane_leaves_copy_whole():
    """``rows * nb_row <= 8`` or ``rows * nbf < 2``: whole, counted 0."""
    assert P.copies_whole(4 * 128, P.lane_block_count((4, 128), 4, BLOCK),
                          BLOCK, 4)
    assert not P.copies_whole(4 * 200, P.lane_block_count((4, 200), 4,
                                                          BLOCK), BLOCK, 4)
    assert P.copies_whole(4 * 65, P.lane_block_count((4, 65), 4, BLOCK),
                          BLOCK, 4)
