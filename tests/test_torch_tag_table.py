"""Port parity: the split hash and the join's fused (key-hash, rank) tag
table (``TagTable``), against the reference on the CPU.

The same numpy-seeded inputs go through the reference's functions and
the port's plain versions (the card's kernel K12 is held against the
same plain versions by ``chip_smoke.py``).  Tolerance: none — every
output is an integer, and tags compare by their 64-bit pattern (the
reference's uint64 viewed as the port's int64).
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.common.hash import (
    hash64_columns as j_hash64_columns,
    hash64_extend as j_extend,
    hash64_finish as j_finish,
    hash64_partial as j_partial,
)
from risingwave_tpu.state.hash_table import (
    TagTable as JTagTable,
    finish_tag as j_finish_tag,
    pair_tag as j_pair_tag,
)
from risingwave_tpu.stream.hash_join import _rank_by_sorted as j_rank
from risingwave_tpu_torch.common.hash import (
    hash64_columns_plain,
    hash64_extend,
    hash64_finish,
    hash64_partial,
)
from risingwave_tpu_torch.compat import (
    state_from_numpy,
    state_mismatches,
    state_to_numpy,
)
from risingwave_tpu_torch.state.tag_table import (
    TagTable,
    finish_tag,
    pair_tag,
)


def _bits(x) -> np.ndarray:
    """A reference uint64 array as its int64 bit pattern."""
    return np.asarray(x).view(np.int64)


def _u64(h: np.ndarray):
    return jnp.asarray(h.view(np.uint64))


def test_split_hash_and_pair_tag_match_the_reference():
    rng = np.random.default_rng(0)
    h = rng.integers(-2**63, 2**63 - 1, 4096, dtype=np.int64)
    h[:4] = [0, -1, -2, 1]
    r = rng.integers(0, 2**31 - 1, 4096, dtype=np.int32)
    r[:4] = [0, 0, 1, 2**31 - 1]
    th, tr = torch.from_numpy(h), torch.from_numpy(r)
    jp = j_partial([_u64(h)])
    tp = hash64_partial([th])
    np.testing.assert_array_equal(_bits(jp), tp.numpy())
    je = j_extend(jp, jnp.asarray(r))
    te = hash64_extend(tp, tr)
    np.testing.assert_array_equal(_bits(je), te.numpy())
    np.testing.assert_array_equal(_bits(j_finish(je)),
                                  hash64_finish(te).numpy())
    # the composition is hash64_columns of both columns
    np.testing.assert_array_equal(_bits(j_hash64_columns([_u64(h),
                                                          jnp.asarray(r)])),
                                  hash64_columns_plain([th, tr]).numpy())
    np.testing.assert_array_equal(_bits(j_pair_tag(_u64(h), jnp.asarray(r))),
                                  pair_tag(th, tr).numpy())
    # the sentinel remaps: all-ones -> ~1, then tags 0 and 1 move up by 2
    raw = np.array([0, 1, 2, -1, -2, 5], np.int64)
    np.testing.assert_array_equal(_bits(j_finish(_u64(raw))),
                                  hash64_finish(torch.from_numpy(raw)).numpy())
    np.testing.assert_array_equal(_bits(j_finish_tag(_u64(raw))),
                                  finish_tag(torch.from_numpy(raw)).numpy())


@jax.jit
def _j_rank(h, valid):
    return j_rank(h, valid)[0]


@jax.jit
def _j_ranked(tags, h, cr, degree, valid):
    return JTagTable(tags, tags.shape[0]).lookup_or_insert_ranked(
        h, cr, degree, valid)


def _tables(size: int):
    jt = JTagTable.create(size)
    tt = state_from_numpy(jax.device_get(jt))
    assert isinstance(tt, TagTable) and tt.size == size
    return jt, tt


def _ranked_both(jt, tt, h, degree, valid):
    """One ranked insert on both tables (ranks from the reference's
    rank-by-sort); asserts every output and the tags equal."""
    cr = np.array(_j_rank(_u64(h), jnp.asarray(valid)))
    jout = _j_ranked(jt.tags, _u64(h), jnp.asarray(cr), jnp.asarray(degree),
                     jnp.asarray(valid))
    tout = tt.lookup_or_insert_ranked(torch.from_numpy(h),
                                      torch.from_numpy(cr),
                                      torch.from_numpy(degree.copy()),
                                      torch.from_numpy(valid))
    names = ("slots", "target", "head_slot", "inserted", "existed",
             "overflow", "iters")
    for name, a, b in zip(names, jout[1:], tout[1:]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                      err_msg=name)
    assert tout[0] is tt  # updated in place
    np.testing.assert_array_equal(_bits(jout[0].tags), tt.tags.numpy())
    return jout[0], [np.asarray(x) for x in jout[1:]], cr


def _add_degrees(degree, h, cr, out, valid):
    """The executor's degree update: each key's rank-0 row adds the key's
    accepted inserts at its head slot."""
    slots, _, head, _, _, over, _ = out
    got = valid & ~over
    for key in np.unique(h[got]):
        rows = got & (h == key)
        rep = np.flatnonzero(rows & (cr == 0))
        if rep.size and head[rep[0]] < degree.shape[0]:
            degree[head[rep[0]]] += rows.sum()


def _keys(rng, n, pool):
    return rng.choice(pool, n)


@pytest.mark.parametrize("case", ["hot_key", "existed", "overflow"])
def test_lookup_or_insert_ranked_layout_equals_the_reference(case):
    rng = np.random.default_rng(1)
    size = {"hot_key": 1024, "existed": 256, "overflow": 16}[case]
    jt, tt = _tables(size)
    degree = np.zeros(size, np.int32)
    keys = rng.integers(-2**63, 2**63 - 1, 64, dtype=np.int64)
    if case == "hot_key":
        # 3 chunks of 128 rows, ~100 on one key: ranks run past the
        # chunk into the key's pre-chunk degree
        for _ in range(3):
            h = np.where(rng.random(128) < 0.8, keys[0],
                         _keys(rng, 128, keys[1:40]))
            valid = rng.random(128) < 0.95
            jt, out, cr = _ranked_both(jt, tt, h, degree, valid)
            _add_degrees(degree, h, cr, out, valid)
        assert degree.max() > 200
    elif case == "existed":
        # entries land but the degree stays 0: the next chunk finds its
        # head and rank entries already present (stranded)
        h = np.resize(np.repeat(keys[:3], [5, 3, 1]), 16)
        valid = np.arange(16) < 9
        jt, out, _ = _ranked_both(jt, tt, h, degree, valid)
        h2 = np.resize(np.repeat(keys[:4], [2, 1, 1, 2]), 16)
        jt, out, _ = _ranked_both(jt, tt, h2, degree, np.arange(16) < 6)
        assert out[4].sum() >= 3  # existed
    else:
        # 40 distinct keys into 16 slots with tombstones: the round bound
        # min(2 * size + 4, 1024) leaves rows over
        jt = JTagTable(jt.tags.at[jnp.asarray([3, 9])].set(1), size)
        tt.tags[[3, 9]] = 1
        h = keys[:40]
        jt, out, _ = _ranked_both(jt, tt, h, degree, np.ones(40, bool))
        assert out[5].sum() > 0 and out[6] == 2 * size + 4


def test_lookups_clears_and_rehash_equal_the_reference():
    rng = np.random.default_rng(2)
    size = 512
    jt, tt = _tables(size)
    degree = np.zeros(size, np.int32)
    keys = rng.integers(-2**63, 2**63 - 1, 96, dtype=np.int64)
    for _ in range(2):
        h = np.where(rng.random(128) < 0.5, keys[0],
                     _keys(rng, 128, keys[1:]))
        valid = np.ones(128, bool)
        jt, out, cr = _ranked_both(jt, tt, h, degree, valid)
        _add_degrees(degree, h, cr, out, valid)
    # lookups of present and absent (hash, rank) pairs
    lh = np.concatenate([keys[:40], rng.integers(-2**63, 2**63 - 1, 40,
                                                 dtype=np.int64)])
    lr = rng.integers(0, 4, 80).astype(np.int32)
    lv = rng.random(80) < 0.9
    jl = jt.lookup_pair_counted(_u64(lh), jnp.asarray(lr), jnp.asarray(lv))
    tl = tt.lookup_pair_counted(torch.from_numpy(lh), torch.from_numpy(lr),
                                torch.from_numpy(lv))
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert np.asarray(jl[1]).sum() > 10
    # clear_where (tombstones), clear_slots (un-claims)
    pred = rng.random(size) < 0.3
    jt = jt.clear_where(jnp.asarray(pred))
    tt.clear_where(torch.from_numpy(pred))
    slots = rng.integers(0, size + 1, 50).astype(np.int32)
    mask = rng.random(50) < 0.5
    jt = jt.clear_slots(jnp.asarray(slots), jnp.asarray(mask))
    tt.clear_slots(torch.from_numpy(slots), torch.from_numpy(mask))
    assert state_mismatches(jax.device_get(jt), tt) == []
    assert int(tt.tombstone_count()) == int(jt.tombstone_count()) > 0
    assert int(tt.count()) == int(jt.count())
    # the rehash: a fresh layout and the moved map
    jfresh, jmoved = jt.rehashed()
    tfresh, tmoved = tt.rehashed()
    np.testing.assert_array_equal(np.asarray(jmoved), tmoved.numpy())
    np.testing.assert_array_equal(_bits(jfresh.tags), tfresh.tags.numpy())
    assert int(tfresh.tombstone_count()) == 0
    # compat carries the table back to the reference's uint64 tags
    back = state_to_numpy(tfresh)
    np.testing.assert_array_equal(back.tags.view(np.uint64),
                                  np.asarray(jfresh.tags))


def test_lookup_bound_overflow_is_counted():
    """A table of tombstones never ends a probe chain: every lookup runs
    to the bound min(size + 2, 1024) and counts as overflow."""
    size = 16
    jt = JTagTable(jnp.ones((size,), jnp.uint64), size)
    tt = state_from_numpy(jax.device_get(jt))
    h = np.arange(10, dtype=np.int64) * 7919
    r = np.zeros(10, np.int32)
    v = np.ones(10, bool)
    jl = jt.lookup_pair_counted(_u64(h), jnp.asarray(r), jnp.asarray(v))
    tl = tt.lookup_pair_counted(torch.from_numpy(h), torch.from_numpy(r),
                                torch.from_numpy(v))
    for a, b in zip(jl, tl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(tl[2]) == 10
