"""Port parity on the corner cases of the join's ranked find-or-claim (K12
ranked) and of the agg's pre-aggregation (K5).

K12 ranked's kernel walks each row over the call-start table first and
replays the reference's rounds over the rows that reach a true-empty slot
only; K5's runs a grid of tiles whose segments carry across tile edges by
look-back.  These cases are the ones such a redesign could get wrong.
Each is built from a numpy seed (``chip_smoke.k12_cases``,
``chip_smoke.k5_cases``, which the card runs too) and goes through the
reference and the port's plain versions, which ``chip_smoke.py`` holds the
kernels against on the card:

- K12: ``TagTable.lookup_or_insert_ranked`` against ``_ranked_plain``:
  the table's tags, ``slots``, ``target``, ``head_slot``, ``inserted``,
  ``existed``, ``overflow`` and ``iters``.  Tolerance: none (integer, and
  the lowest row index wins a claim).
- K5: the reference's accelerator branch of ``HashAggExecutor.apply``
  (hash_agg.py:394-436, :613-641), written out here over its own
  ``common/compact.py`` primitives, against ``agg_preagg_plain``.  The
  reference's segment values stand at every row and the port's at END
  rows only (the identity elsewhere), so they compare at END rows.
  Tolerance: none, except the float64 sum: within 1e-12 relative and 1e-9
  absolute (``chip_smoke.K5_F64_RTOL``, ``K5_F64_ATOL``), as both sides
  take cumsum differences in their own summation order.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import sys
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.common.chunk import NCol as JNCol, StrCol as JStrCol
from risingwave_tpu.common.compact import (
    segment_start_positions,
    segment_starts,
    segmented_minmax_at_ends,
    segmented_sum,
)
from risingwave_tpu.common.hash import hash64_columns as j_hash64
from risingwave_tpu.state.hash_table import (
    TagTable as JTagTable,
    gather_key,
    keys_equal,
)
from risingwave_tpu_torch.common.tree import flatten
from risingwave_tpu_torch.state.tag_table import TagTable
from risingwave_tpu_torch.stream.hash_agg import agg_preagg_plain

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the cases, shared with the card's phases)

# ---------------------------------------------------------------------------
# K12 ranked: TagTable.lookup_or_insert_ranked


@jax.jit
def _j_ranked(tags, hashes, chunk_rank, degree, valid):
    t = JTagTable(tags, tags.shape[0])
    t, *out = t.lookup_or_insert_ranked(hashes, chunk_rank, degree, valid)
    return (t.tags, *out)


K12_CASES = {c[0]: c[1:] for c in chip_smoke.k12_cases()}
RANKED_NAMES = ("slots", "target", "head_slot", "inserted", "existed",
                "overflow", "iters")


def _replay_ranked(size, tags, degree, calls):
    """Every call through both; asserts equal outputs and tables after each
    and returns the port's outputs of each call as numpy arrays."""
    jtags = jnp.asarray(tags.view(np.uint64))
    tt = TagTable(torch.from_numpy(tags.copy()), size)
    jdeg, tdeg = jnp.asarray(degree), torch.from_numpy(degree)
    outs = []
    for h, cr, valid in calls:
        jtags, *jo = _j_ranked(jtags, jnp.asarray(h.view(np.uint64)),
                               jnp.asarray(cr), jdeg, jnp.asarray(valid))
        to = tt._ranked_plain(torch.from_numpy(h), torch.from_numpy(cr),
                              tdeg, torch.from_numpy(valid))[1:]
        for name, a, b in zip(RANKED_NAMES, jo, to):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(), name)
        np.testing.assert_array_equal(np.asarray(jtags).view(np.int64),
                                      tt.tags.numpy(), "tags")
        outs.append({n: t.numpy() for n, t in zip(RANKED_NAMES, to)})
    return tt, outs


def _check_hot(size, tags, degree, calls, outs):
    h, cr, _ = calls[0]
    o = outs[0]
    keys, counts = np.unique(h, return_counts=True)
    hot = h == keys[counts.argmax()]
    assert hot.sum() == 200
    np.testing.assert_array_equal(o["target"][hot], 40 + cr[hot])
    assert o["target"].max() == 239 and o["inserted"][hot].all()


def _check_head_claimed(size, tags, degree, calls, outs):
    o = outs[0]
    # b: row 1 claims the head at 200 in round 0; its repeated rank-0 row 4
    # loses, meets the head in round 1 and reads degree 3 there; row 8
    # (rank 1) saw the head empty in round 0: degree 0, target 1
    assert o["slots"][1] == 200 and o["inserted"][1]
    assert o["head_slot"][4] == 200 and o["target"][4] == 3
    assert o["target"][8] == 1 and o["head_slot"][8] == size
    # a: its rows walk the head chain in lock-step, past two tombstones
    a_rows = [0, 2, 5, 7]
    assert list(o["target"][a_rows]) == [0, 1, 2, 3]
    assert o["slots"][0] not in (100, 101) and o["inserted"][a_rows].all()


def _check_degrees(size, tags, degree, calls, outs):
    o = outs[0]
    assert o["existed"].any() and (o["target"] > 0).any()


def _check_stranded(size, tags, degree, calls, outs):
    o = outs[0]
    assert o["existed"].sum() == 96 and o["inserted"].sum() == 48


def _check_tombstones(size, tags, degree, calls, outs):
    assert (tags == 1).sum() > 0 and outs[0]["inserted"].any()


def _check_collisions(size, tags, degree, calls, outs):
    o = outs[0]
    assert list(o["slots"][:5]) == [1064, 1000, 1128, 2000, 2064]
    assert o["iters"] >= 3


def _check_invalid(size, tags, degree, calls, outs):
    _, _, valid = calls[0]
    o = outs[0]
    assert (o["slots"][~valid] == size).all()
    assert not o["inserted"][~valid].any()
    o = outs[1]
    assert o["iters"] == 1 and not o["inserted"].any()
    assert (o["slots"] == size).all()


def _check_bound(size, tags, degree, calls, outs):
    o = outs[0]
    assert o["iters"] == 2 * size + 4
    assert o["overflow"].sum() == 7 and o["inserted"].sum() == 1


def _check_q8_like(size, tags, degree, calls, outs):
    assert outs[0]["inserted"].sum() > 1024


K12_CHECKS = {"hot key past its degree": _check_hot,
              "head claimed in the call": _check_head_claimed,
              "nonzero degree at heads": _check_degrees,
              "stranded entries": _check_stranded,
              "tombstones in the chains": _check_tombstones,
              "scratch collisions": _check_collisions,
              "invalid rows": _check_invalid,
              "round bound": _check_bound,
              "q8-like chunk": _check_q8_like}


@pytest.mark.parametrize("name", list(K12_CASES))
def test_ranked_case(name):
    """The reference's rounds on each case; each case also checks that it
    exercises what it names."""
    size, tags, degree, calls = K12_CASES[name]
    _, outs = _replay_ranked(size, tags, degree, calls)
    K12_CHECKS[name](size, tags, degree, calls, outs)


def test_ranked_collision_layout():
    """The heads of the collision case are homed 64 (= 4 * cap) apart."""
    size, _, _, calls = K12_CASES["scratch collisions"]
    h = calls[0][0][:5]
    homes = chip_smoke._pair_tags(h, np.zeros(5, np.int32)) & (size - 1)
    assert list(homes) == [1064, 1000, 1128, 2000, 2064]
    assert len({int(x) % 64 for x in homes[:3]}) == 1


# ---------------------------------------------------------------------------
# K5: the accelerator branch's pre-aggregation


K5_CASES = {c["name"]: c for c in chip_smoke.k5_cases()}


def _j_col(c):
    if isinstance(c, tuple) and c[0] == "str":
        return JStrCol(jnp.asarray(c[1]), jnp.asarray(c[2]))
    if isinstance(c, tuple):
        return JNCol(_j_col(c[1]), jnp.asarray(c[2]))
    return jnp.asarray(c)


@partial(jax.jit, static_argnums=(0,))
def _j_preagg(modes, key_cols, h, valid, signs, values):
    """hash_agg.py:394-436 and :613-641, the reference's lines on its own
    primitives: sort, segment starts over hash and keys, the row count,
    each primitive's segment reduce and the sign sum."""
    cap = valid.shape[0]
    sort_key = jnp.where(valid, h, ~jnp.uint64(0))
    s_h, perm = jax.lax.sort_key_val(sort_key,
                                     jnp.arange(cap, dtype=jnp.int32))
    s_valid = valid[perm]
    s_signs = signs[perm]
    s_keys = [gather_key(c, perm) for c in key_cols]
    neq = s_h[1:] != s_h[:-1]
    for c in s_keys:
        neq = neq | ~keys_equal(gather_key(c, jnp.arange(1, cap)),
                                gather_key(c, jnp.arange(0, cap - 1)))
    starts = segment_starts(neq)
    ends = jnp.concatenate([neq, jnp.ones((1,), jnp.bool_)])
    start_pos = segment_start_positions(starts)
    seg_id = jnp.cumsum(starts.astype(jnp.int32))
    seg = []
    for mode, val in zip(modes, values):
        contrib = gather_key(val, perm)
        seg.append(segmented_sum(contrib, start_pos) if mode == "add" else
                   segmented_minmax_at_ends(seg_id, contrib, start_pos,
                                            mode))
    return (s_h, perm, s_keys, starts, ends, ends & s_valid,
            segmented_sum(s_valid.astype(jnp.int64), start_pos),
            segmented_sum(s_signs.astype(jnp.int64), start_pos), seg)


def _both_preagg(case):
    args = chip_smoke.k5_torch_args(torch, case, "cpu")
    p = agg_preagg_plain(*args)
    jkeys = [_j_col(c) for c in case["keys"]]
    jh = j_hash64(jkeys) if case["hash"] is None \
        else jnp.asarray(case["hash"].view(np.uint64))
    modes = tuple(m for m, _, _ in case["prims"])
    j = _j_preagg(modes, jkeys, jh, jnp.asarray(case["valid"]),
                  jnp.asarray(case["signs"]),
                  [jnp.asarray(v) for _, _, v in case["prims"]])
    return args, p, j


@pytest.mark.parametrize("name", list(K5_CASES))
def test_preagg_case(name):
    case = K5_CASES[name]
    args, p, j = _both_preagg(case)
    s_h, perm, s_keys, starts, ends, rep, seg_rows, seg_signs, seg = j
    eq = np.testing.assert_array_equal
    eq(np.asarray(s_h).view(np.int64), p.s_hash.numpy(), "s_hash")
    eq(np.asarray(perm), p.perm.numpy(), "perm")
    eq(np.asarray(starts), p.starts.numpy(), "starts")
    eq(np.asarray(rep), p.rep.numpy(), "rep")
    for i, (jc, tc) in enumerate(zip(s_keys, p.s_keys)):
        for k, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(jc),
                                       flatten(tc)[0])):
            eq(np.asarray(a), b.numpy(), f"key {i}.{k}")
    ends = np.asarray(ends)
    eq(np.asarray(seg_rows)[ends], p.seg_rows.numpy()[ends], "seg_rows")
    eq(np.asarray(seg_signs)[ends], p.seg_signs.numpy()[ends], "seg_signs")
    assert not p.seg_rows.numpy()[~ends].any()
    assert not p.seg_signs.numpy()[~ends].any()
    for i, ((mode, init, v), a, b) in enumerate(zip(case["prims"], seg,
                                                    p.seg_values)):
        a, b = np.asarray(a), b.numpy()
        if v.dtype == np.float64 and mode == "add":
            np.testing.assert_allclose(b[ends], a[ends],
                                       rtol=chip_smoke.K5_F64_RTOL,
                                       atol=chip_smoke.K5_F64_ATOL)
        elif v.dtype == np.float64:  # by bits
            eq(a[ends].view(np.int64), b[ends].view(np.int64), f"prim {i}")
        else:
            eq(a[ends], b[ends], f"prim {i}")
        assert (b[~ends] == (0 if mode == "add" else init)).all()
    K5_CHECKS.get(name, lambda *_: None)(case, p)


def _check_one_segment(case, p):
    assert len(case["valid"]) > 8 * 512
    assert int(p.starts.sum()) == 2  # the valid run and the invalid tail


def _check_tile_edges(case, p):
    assert (np.flatnonzero(p.starts.numpy()) % 512 == 0).all()
    assert int(p.starts.sum()) == 4


def _check_ragged(case, p):
    assert len(case["valid"]) % 512 != 0 and int(p.starts.sum()) > 100


def _check_all_invalid(case, p):
    assert not p.rep.any() and not p.seg_rows.any()


def _check_nulls(case, p):
    null = p.s_keys[0].null.numpy()
    payload = p.s_keys[0].data.numpy()
    seg = np.cumsum(p.starts.numpy())
    mixed = [s for s in np.unique(seg[null])
             if len(np.unique(payload[null & (seg == s)])) > 1]
    assert mixed  # NULL rows of differing payloads in one segment


def _check_strings(case, p):
    assert int(p.starts.sum()) > 10 and len(np.unique(case["hash"])) == 1
    data = p.s_keys[0].data.numpy()
    starts = p.starts.numpy()
    by_pad = starts[1:] & (data[1:, :7] == data[:-1, :7]).all(1) & (
        p.s_keys[0].lens.numpy()[1:] == p.s_keys[0].lens.numpy()[:-1])
    assert by_pad.any()  # a run split by its padding alone


def _check_inits(case, p):
    assert {v.dtype for _, _, v in case["prims"]} == {
        np.dtype(np.int64), np.dtype(np.int32), np.dtype(np.float64)}


def _check_lane(case, p):
    assert int(p.rep.sum()) > 0 and int(case["valid"].sum()) == 27


K5_CHECKS = {"one segment over every tile": _check_one_segment,
             "segment edges on tile edges": _check_tile_edges,
             "ragged n": _check_ragged,
             "all invalid": _check_all_invalid,
             "NULL keys": _check_nulls,
             "string keys, one hash": _check_strings,
             "min and max with inits": _check_inits,
             "sharded lane": _check_lane}
