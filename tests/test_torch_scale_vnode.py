"""Port parity: the vnode keyspace and the gate of the scale plane.

- ``vnodes_of_ints``' plain version (K25's vnode form) against the
  reference's on random int64 keys with negatives, extremes and hashes
  whose top bit is set, for n = 16, 24 (not a power of two) and 64;
- ``initial_map``, ``rebalance``, ``moved_vnodes`` and ``owned_vnodes``
  against the reference's on random worker sets;
- ``VnodeGateExecutor.apply`` (K25's gate form, plain) against the
  reference's, output chunk and state: random chunks with U-/U+ pairs
  that straddle owned and unowned vnodes, pairs at row 0 and row cap-1
  and unpaired updates that wrap around the capacity, invalid rows, both
  state forms, the dropped counter carried over several chunks.

Tolerance: none (integer end to end).
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.cluster.scale import gate as jgate
from risingwave_tpu.cluster.scale import vnode as jv
from risingwave_tpu.common.chunk import Chunk as JChunk
from risingwave_tpu.common.types import DataType as JType
from risingwave_tpu.common.types import Field as JField
from risingwave_tpu.common.types import Schema as JSchema
from risingwave_tpu.expr.node import InputRef as JRef
from risingwave_tpu_torch.cluster.scale import gate as tgate
from risingwave_tpu_torch.cluster.scale import vnode as tv
from risingwave_tpu_torch.common.chunk import Chunk
from risingwave_tpu_torch.common.hash import hash64_columns_plain
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.expr.node import InputRef


def _keys(rng, n):
    ext = np.array([0, 1, -1, 2**63 - 1, -2**63, -2**63 + 1, 2**62,
                    -(2**62)], dtype=np.int64)
    return np.concatenate([ext, rng.integers(-2**63, 2**63 - 1, n,
                                             dtype=np.int64),
                           rng.integers(-50, 50, n, dtype=np.int64)])


@pytest.mark.parametrize("n_vnodes", [16, 24, 64])
def test_vnodes_of_ints_matches_reference(n_vnodes):
    keys = _keys(np.random.default_rng(n_vnodes), 4000)
    want = np.asarray(jv.vnodes_of_ints(keys, n_vnodes))
    got = tv.vnodes_of_ints(torch.from_numpy(keys), n_vnodes)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    # the unsigned modulo matters: a good share of hashes has the top bit
    h = hash64_columns_plain([torch.from_numpy(keys)])
    assert 0.3 < float((h < 0).double().mean()) < 0.7
    # int32 keys widen as the reference's astype(int64)
    k32 = keys[:500].astype(np.int32)
    assert np.array_equal(
        tv.vnodes_of_ints(torch.from_numpy(k32), n_vnodes).numpy(),
        np.asarray(jv.vnodes_of_ints(k32, n_vnodes)))


def test_member_mask_matches_reference():
    for vns in ([], [0], [3, 1, 23], list(range(24))):
        assert np.array_equal(tv.vnode_member_mask(vns, 24).numpy(),
                              np.asarray(jv.vnode_member_mask(vns, 24)))


@pytest.mark.parametrize("n_vnodes", [16, 24, 64])
def test_map_functions_match_reference(n_vnodes):
    rng = np.random.default_rng(100 + n_vnodes)
    old = None
    for _ in range(12):
        k = int(rng.integers(1, 7))
        workers = sorted(int(w) for w in rng.choice(
            np.arange(1, 12), size=k, replace=False))
        assert tv.initial_map(workers, n_vnodes) == \
            jv.initial_map(workers, n_vnodes)
        new = tv.rebalance(old, workers, n_vnodes)
        assert new == jv.rebalance(old, workers, n_vnodes)
        if old is not None:
            assert tv.moved_vnodes(old, new) == jv.moved_vnodes(old, new)
        for w in workers:
            assert tv.owned_vnodes(new, w) == jv.owned_vnodes(new, w)
        old = new
    for bad in ((None, []), ([1] * (n_vnodes - 1), [1])):
        for mod in (tv, jv):
            with pytest.raises(ValueError):
                mod.rebalance(bad[0], bad[1], n_vnodes)


def _chunk(rng, cap, n_vnodes, own):
    """Keys, ops and valid of a chunk with U-/U+ pairs whose two rows
    fall in owned and unowned vnodes, pairs at both edges and unpaired
    updates at row 0 (U+) and row cap-1 (U-)."""
    keys = rng.integers(-2**40, 2**40, cap, dtype=np.int64)
    vn = np.asarray(jv.vnodes_of_ints(keys, n_vnodes))
    ops = rng.integers(0, 2, cap).astype(np.int8)
    owned = np.isin(vn, own)
    starts = list(range(1, cap - 3, 5))
    for i in starts:
        ops[i], ops[i + 1] = 2, 3
    ops[0], ops[cap - 1] = 3, 2            # wrap-around partners
    ops[cap - 3], ops[cap - 2] = 2, 3
    valid = rng.random(cap) < 0.9
    assert owned.any() and (~owned).any()
    return keys, ops, valid


def _jchunk(keys, ops, valid):
    schema = JSchema((JField("k", JType.INT64, nullable=False),))
    return JChunk((jnp.asarray(keys),), jnp.asarray(ops),
                  jnp.asarray(valid), schema)


def _tchunk(keys, ops, valid):
    schema = Schema((Field("k", DataType.INT64, nullable=False),))
    return Chunk((torch.from_numpy(keys.copy()),), torch.from_numpy(
        ops.copy()), torch.from_numpy(valid.copy()), schema)


@pytest.mark.parametrize("n_vnodes,cap", [(24, 64), (64, 256)])
def test_gate_matches_reference(n_vnodes, cap):
    rng = np.random.default_rng(cap)
    own = sorted(int(v) for v in rng.choice(n_vnodes, n_vnodes // 2,
                                            replace=False))
    jg = jgate.VnodeGateExecutor(
        JSchema((JField("k", JType.INT64, nullable=False),)), JRef(0),
        n_vnodes)
    tg = tgate.VnodeGateExecutor(
        Schema((Field("k", DataType.INT64, nullable=False),)), InputRef(0),
        n_vnodes)
    # the pair form, the dropped counter carried over several chunks
    jst = (jg.make_mask(own), jnp.asarray(5, jnp.int64))
    tst = (tg.make_mask(own), torch.tensor(5, dtype=torch.int64))
    degraded = 0
    for _ in range(4):
        keys, ops, valid = _chunk(rng, cap, n_vnodes, own)
        jst, jout = jg.apply(jst, _jchunk(keys, ops, valid))
        tst, tout = tg.apply(tst, _tchunk(keys, ops, valid))
        assert np.array_equal(tout.ops.numpy(), np.asarray(jout.ops))
        assert np.array_equal(tout.valid.numpy(), np.asarray(jout.valid))
        assert np.array_equal(tst[0].numpy(), np.asarray(jst[0]))
        assert int(tst[1]) == int(jst[1])
        degraded += int((tout.ops.numpy() != ops).sum())
        assert tout.columns[0] is not None
    assert degraded > 0
    assert int(tst[1]) > 5
    # the bare-mask form returns the mask and no counter
    keys, ops, valid = _chunk(rng, cap, n_vnodes, own)
    jm, jout = jg.apply(jg.make_mask(own), _jchunk(keys, ops, valid))
    tm, tout = tg.apply(tg.make_mask(own), _tchunk(keys, ops, valid))
    assert isinstance(tm, torch.Tensor)
    assert np.array_equal(tm.numpy(), np.asarray(jm))
    assert np.array_equal(tout.ops.numpy(), np.asarray(jout.ops))
    assert np.array_equal(tout.valid.numpy(), np.asarray(jout.valid))
    # init_state owns everything: nothing dropped, and only pairs with an
    # invalid partner degrade
    jst, jout = jg.apply(jg.init_state(), _jchunk(keys, ops, valid))
    tst, tout = tg.apply(tg.init_state("cpu"), _tchunk(keys, ops, valid))
    assert np.array_equal(tout.valid.numpy(), valid)
    assert np.array_equal(tout.ops.numpy(), np.asarray(jout.ops))
    assert int(tst[1]) == int(jst[1]) == 0
