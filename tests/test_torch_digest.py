"""Port parity: block digests (K11's arithmetic) and the dense row
permutation (K4), plain versions against the reference.

``leaf_digest`` must equal ``risingwave_tpu.storage.digest.leaf_digest``
bit for bit (the port's int64 digests viewed as the reference's uint64)
for every dtype executor states hold: bool, int8/uint8 (2-D string data
included), int16, int32, int64, uint64 and float32, and float64 with
nan, ±inf, -0.0 and subnormals; at the shapes scalar, empty, ragged tail
and exact multiple of the block.  ``gather_plan`` must cut the
reference's runs.  ``permute_dense`` must equal the reference's with and
without ``init``, for ``NCol`` and ``StrCol`` columns and with the drop
sentinel.  Tolerance: none.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.common.chunk import NCol as JNCol, StrCol as JStrCol
from risingwave_tpu.state.hash_table import permute_dense as j_permute
from risingwave_tpu.storage import digest as R
from risingwave_tpu_torch.common.chunk import NCol, StrCol
from risingwave_tpu_torch.state.hash_table import (
    permute_dense,
    permute_dense_many,
)
from risingwave_tpu_torch.storage import digest as P

BLOCK = 64
SHAPES = [(), (0,), (1000,), (1024,), (70, 24)]
DTYPES = [np.bool_, np.int8, np.uint8, np.int16, np.int32, np.int64,
          np.uint64, np.float32]


def _data(dt, shape, seed):
    rng = np.random.default_rng(seed)
    if dt == np.bool_:
        return rng.integers(0, 2, shape).astype(dt)
    if dt == np.float32:
        return rng.standard_normal(shape).astype(dt)
    info = np.iinfo(dt)
    return rng.integers(info.min, info.max, shape, dtype=dt, endpoint=True)


def _both(a, block=BLOCK):
    nb = R.leaf_block_count(a.shape, block)
    assert P.leaf_block_count(a.shape, block) == nb
    ref = np.asarray(R.leaf_digest(jnp.asarray(a), nb, block))
    port = P.leaf_digest(torch.from_numpy(a.copy()), nb, block).numpy()
    return ref, port


@pytest.mark.parametrize("dt", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_leaf_digest_equals_reference(dt, shape):
    ref, port = _both(_data(dt, shape, 7))
    assert np.array_equal(port.view(np.uint64), ref)


def test_float64_digest_special_values_and_subnormals():
    a = np.random.default_rng(3).standard_normal(3000)
    a[:12] = [np.nan, -np.nan, np.inf, -np.inf, -0.0, 0.0, 5e-324,
              -5e-324, 1e-310, -2.2e-310, 2.2250738585072014e-308,
              np.finfo(np.float64).max]
    a[100:400] *= 1e-310  # a run of subnormals
    ref, port = _both(a)
    assert np.array_equal(port.view(np.uint64), ref)
    # -0.0 digests as +0.0, nan and inf stay distinct from zero
    z = P.normalize_u64(torch.tensor([0.0, -0.0, np.nan, np.inf],
                                     dtype=torch.float64))
    assert z[0] == z[1] and len(set(z.tolist())) == 3
    ref, port = _both(np.array(2.5))
    assert np.array_equal(port.view(np.uint64), ref)


def test_digest_leaves_concatenates_and_changes_per_block():
    leaves = [_data(np.int64, (300,), 1), _data(np.uint8, (50, 24), 2)]
    nbs = [R.leaf_block_count(x.shape, BLOCK) for x in leaves]
    ref = np.asarray(R.digest_leaves([jnp.asarray(x) for x in leaves], nbs,
                                     BLOCK))
    port = P.digest_leaves([torch.from_numpy(x) for x in leaves], nbs, BLOCK)
    assert np.array_equal(port.numpy().view(np.uint64), ref)
    changed = leaves[0].copy()
    changed[130] += 1
    d2 = P.digest_leaves([torch.from_numpy(changed),
                          torch.from_numpy(leaves[1])], nbs, BLOCK)
    assert (d2 != port).nonzero().flatten().tolist() == [130 // BLOCK]


def test_gather_plan_cuts_the_references_runs():
    sizes, esizes = [1000, 70 * 24, 5], [8, 1, 4]
    nblocks = [P.leaf_block_count((n,), BLOCK) for n in sizes]
    dirty = np.zeros(sum(nblocks), bool)
    dirty[[0, 1, 2, 5, 15, 16, 17, 20, 41]] = True
    entries, runs, total = P.gather_plan(dirty, nblocks, sizes, esizes,
                                         BLOCK)
    # the reference's coalescing loop (checkpoint_store.py:259-280)
    want, off = [], 0
    for i, (n, nb) in enumerate(zip(sizes, nblocks)):
        d = dirty[off:off + nb]
        off += nb
        b = 0
        while b < nb:
            if not d[b]:
                b += 1
                continue
            e = b
            while e + 1 < nb and d[e + 1]:
                e += 1
            want.append((i, b * BLOCK, min((e + 1) * BLOCK, n)))
            b = e + 1
    assert [r[:3] for r in runs] == want
    assert entries.shape == (9, 2) and total % 16 == 0
    # the plain gather packs the blocks where the runs say
    src = [torch.from_numpy(_data(np.int64, (1000,), 4)),
           torch.from_numpy(_data(np.uint8, (70 * 24,), 5)),
           torch.from_numpy(_data(np.int32, (5,), 6))]
    staging = torch.zeros(total, dtype=torch.uint8)
    P.dirty_gather(src, torch.from_numpy(entries), staging, nblocks, BLOCK)
    host = staging.numpy()
    for li, s, e, o in runs:
        got = host[o:o + (e - s) * esizes[li]].view(src[li].numpy().dtype)
        assert np.array_equal(got, src[li].numpy()[s:e])


def _moved(size, seed, live_frac=0.6):
    rng = np.random.default_rng(seed)
    live = rng.random(size) < live_frac
    tgt = rng.permutation(size)[:size]
    return np.where(live, tgt, size).astype(np.int32)


@pytest.mark.parametrize("init", [None, -7, 2 ** 40])
def test_permute_dense_equals_reference(init):
    size = 512
    moved = _moved(size, 11)
    a = _data(np.int64, (size,), 12)
    ref = np.asarray(j_permute(jnp.asarray(a), jnp.asarray(moved), init))
    port = permute_dense(torch.from_numpy(a), torch.from_numpy(moved), init)
    assert np.array_equal(port.numpy(), ref)


def test_permute_dense_ncol_strcol_and_many():
    size = 256
    moved = _moved(size, 21)
    data = _data(np.int32, (size,), 22)
    null = _data(np.bool_, (size,), 23)
    sdata = _data(np.uint8, (size, 24), 24)
    lens = _data(np.int32, (size,), 25)
    ref_n = j_permute(JNCol(jnp.asarray(data), jnp.asarray(null)),
                      jnp.asarray(moved), 5)
    ref_s = j_permute(JStrCol(jnp.asarray(sdata), jnp.asarray(lens)),
                      jnp.asarray(moved))
    tm = torch.from_numpy(moved)
    port_n = permute_dense(NCol(torch.from_numpy(data),
                                torch.from_numpy(null)), tm, 5)
    port_s = permute_dense(StrCol(torch.from_numpy(sdata),
                                  torch.from_numpy(lens)), tm)
    for r, p in ((ref_n.data, port_n.data), (ref_n.null, port_n.null),
                 (ref_s.data, port_s.data), (ref_s.lens, port_s.lens)):
        assert np.array_equal(p.numpy(), np.asarray(r))
    # several columns through one call equal one call per column
    cols = [torch.from_numpy(data), StrCol(torch.from_numpy(sdata),
                                           torch.from_numpy(lens))]
    many = permute_dense_many(cols, tm)
    assert torch.equal(many[0], permute_dense(cols[0], tm))
    assert torch.equal(many[1].data, port_s.data)
