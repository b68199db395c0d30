"""Port parity: ``ShadowSnapshot`` (K11's plain version) against the
reference's, in both modes.

The same sequence of mutated state trees goes through
``risingwave_tpu.stream.shadow.ShadowSnapshot`` and the port's.  The
leaves cover a small leaf (copied whole, never counted), ladder leaves
with and without a ragged tail, 2-D uint8 string data, bool and
float64.  The mutations hit each rung of the reference's budget ladder
(at most 1/64 of a leaf's full blocks dirty, at most 1/8, more), the
ragged tail alone, and nothing.  After every update the shadow leaves,
the digest vector (int64 bit patterns of the reference's uint64) and
``dirty_blocks`` must be equal, and ``restore`` must equal the live
tree and be independent of the shadow.  Tolerance: none.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.stream.shadow import ShadowSnapshot as JShadow
from risingwave_tpu_torch.stream.shadow import ShadowSnapshot

BLOCK = 64


def _tree(seed):
    rng = np.random.default_rng(seed)
    return [
        rng.integers(-50, 50, 300).astype(np.int64),           # 5 blocks
        rng.integers(-9, 9, 64 * 512 + 17).astype(np.int64),   # tail
        rng.integers(0, 255, (200, 24)).astype(np.uint8),      # 75 blocks
        rng.integers(0, 2, 1000).astype(np.bool_),
        rng.standard_normal(64 * 20),                          # exact
        np.array(7, np.int64),
    ]


def _mutations():
    """(description, function on the numpy leaves) in order."""
    def blocks(leaf, idx):
        def f(t):
            for b in idx:
                t[leaf][b * BLOCK] += 1
        return f

    def tail(t):
        t[1][-1] += 1

    def many(t):
        t[1][::3] += 1
        t[2][::2] ^= 1
        t[4][5::70] = np.nan

    def small(t):
        t[0][3] += 1
        t[5][...] = 8

    return [("one block (rung 0)", blocks(1, [3])),
            ("five blocks (rung 1)", blocks(1, [1, 9, 17, 100, 400])),
            ("a third of the blocks (full rung)", many),
            ("the ragged tail only", tail),
            ("small leaves only", small),
            ("nothing", lambda t: None)]


def _j(leaves):
    return tuple(jnp.asarray(x) for x in leaves)


def _t(leaves):
    return tuple(torch.from_numpy(x.copy()) for x in leaves)


def _assert_equal(js, ts):
    assert len(js.leaves) == len(ts.leaves)
    for r, p in zip(js.leaves, ts.leaves):
        assert np.array_equal(np.asarray(r), p.numpy(), equal_nan=True)
    assert np.array_equal(np.asarray(js.digests),
                          ts.digests.numpy().view(np.uint64))
    assert int(js.dirty_blocks) == int(ts.dirty_blocks)
    assert js.total_blocks == ts.total_blocks


def test_digest_mode_matches_reference_through_every_rung():
    leaves = _tree(1)
    js = JShadow(_j(leaves), block_elems=BLOCK, digest=True)
    ts = ShadowSnapshot(_t(leaves), block_elems=BLOCK, digest=True)
    _assert_equal(js, ts)
    assert int(ts.dirty_blocks) == 0
    seen = []
    for name, mutate in _mutations():
        mutate(leaves)
        js.update(_j(leaves), epoch=len(seen))
        ts.update(_t(leaves), epoch=len(seen))
        _assert_equal(js, ts)
        seen.append((name, int(ts.dirty_blocks)))
    counts = dict(seen)
    assert counts["one block (rung 0)"] == 1
    assert counts["five blocks (rung 1)"] == 5
    assert counts["a third of the blocks (full rung)"] > 100
    assert counts["the ragged tail only"] == 1
    assert counts["small leaves only"] == 0
    assert counts["nothing"] == 0
    assert ts.dirty_ratio() == 0.0


def test_restore_equals_live_and_is_independent():
    leaves = _tree(2)
    ts = ShadowSnapshot(_t(leaves), block_elems=BLOCK)
    _mutations()[2][1](leaves)
    ts.update(_t(leaves))
    out = ts.restore()
    ref = jax.device_get(JShadow(_j(leaves), block_elems=BLOCK).restore())
    for x, r, y in zip(out, ref, leaves):
        assert x.shape == r.shape
        assert np.array_equal(x.numpy(), y, equal_nan=True)
        assert np.array_equal(x.numpy(), r, equal_nan=True)
    out[1].fill_(0)
    assert ts.leaves[1].abs().sum() > 0
    assert ts.matches(_t(leaves))
    assert not ts.matches(_t(leaves[:-1]))


def test_storeless_mode_is_a_plain_copy():
    leaves = _tree(3)
    js = JShadow(_j(leaves), block_elems=BLOCK, digest=False)
    ts = ShadowSnapshot(_t(leaves), block_elems=BLOCK, digest=False)
    _assert_equal(js, ts)
    buffers = [x.data_ptr() for x in ts.leaves]
    _mutations()[1][1](leaves)
    js.update(_j(leaves))
    ts.update(_t(leaves))
    _assert_equal(js, ts)
    assert int(ts.dirty_blocks) == ts.total_blocks
    assert ts.digests.numel() == 0
    # the shadow buffers persist: no allocation per snapshot
    assert [x.data_ptr() for x in ts.leaves] == buffers


def test_shard_rows_is_not_ported():
    """``shard_rows`` is ported (K11 lanes): a tree whose leaves lead with
    the lane axis digests per lane, as the reference's does."""
    leaves = [x.reshape((2, -1)) if x.size % 2 == 0 and x.ndim else x
              for x in _tree(4)]
    js = JShadow(_j(leaves), block_elems=BLOCK, shard_rows=2)
    ts = ShadowSnapshot(_t(leaves), block_elems=BLOCK, shard_rows=2)
    assert ts.lanes == js.lanes and ts.shard_rows == 2
    _assert_equal(js, ts)
    leaves[0][1, :5] += 1
    leaves[2][0, 100:1300] ^= 1
    js.update(_j(leaves))
    ts.update(_t(leaves))
    _assert_equal(js, ts)
    assert int(ts.dirty_blocks) > 0
