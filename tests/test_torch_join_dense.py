"""Port parity: dense (bucket) join sides and the join matrix of
``stream/hash_join.py`` against the reference's ``HashJoinExecutor``.

The same numpy-built chunks go through the reference executor and the
port's (plain versions on the CPU):

- ``_update_side`` (K13d's plain version with K1, the ranks and K3) on a
  dense side with string and nullable columns: duplicates of one value,
  a delete and an insert of one value in one chunk (annihilation),
  deletes with no match, a full bucket;
- the eight join types over dense/dense, pool/dense and pool/pool
  sides: every emission window of ``apply_begin`` / ``emit_window``
  (columns, null planes, ops, valid flags), every state tensor after
  each chunk, and the folded changelog against a brute-force join of
  the live multisets (the oracle of ``tests/test_join_matrix.py``);
- ``clean_below`` and ``maybe_rehash``'s ``rebuild`` on a dense side.

Tolerance: none — the path is integer end to end.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from risingwave_tpu.common.chunk import Chunk as JChunk
from risingwave_tpu.common.types import (
    DataType as JType,
    Field as JField,
    Schema as JSchema,
)
from risingwave_tpu.expr.node import InputRef as JRef
from risingwave_tpu.stream import hash_join as jhj
from risingwave_tpu_torch.common.chunk import Chunk
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.compat import state_mismatches
from risingwave_tpu_torch.expr.node import InputRef
from risingwave_tpu_torch.stream import hash_join as hj

CAP = 16


def _schemas(F, T, S):
    left = S((F("k", T.INT64), F("a", T.INT64)))
    right = S((F("k", T.INT64), F("b", T.INT64)))
    wide = S((F("k", T.INT64), F("s", T.VARCHAR, str_width=8),
              F("v", T.INT64, nullable=True)))
    return left, right, wide


JL, JR, JW = _schemas(JField, JType, JSchema)
TL, TR, TW = _schemas(Field, DataType, Schema)


def _chunks(jschema, tschema, rows, ops, cap=CAP):
    arrays = [np.array([r[i] for r in rows], object)
              for i in range(len(tschema))]
    ops = np.asarray(ops, np.int8)
    return (JChunk.from_numpy(jschema, arrays, ops=ops, capacity=cap),
            Chunk.from_numpy(tschema, arrays, ops=ops, capacity=cap))


def _planes(col):
    """Every plane of a column (payload, string lengths, null flags)."""
    if hasattr(col, "null"):
        return _planes(col.data) + [np.asarray(col.null)]
    if hasattr(col, "lens"):
        return [np.asarray(col.data), np.asarray(col.lens)]
    return [np.asarray(col)]


def _fold(acc: Counter, chunk: Chunk) -> Counter:
    """Fold an emitted changelog window into a multiset of rows."""
    ops, cols, _ = chunk.to_host()
    for i in range(len(ops)):
        row = tuple(None if c[i] is None else int(c[i]) for c in cols)
        acc[row] += 1 if ops[i] in (0, 3) else -1
    return acc


def expected(join_type, left_rows, right_rows):
    """Brute-force expected multiset for the current live rows (the
    oracle of ``tests/test_join_matrix.py``)."""
    out = Counter()
    if join_type in ("inner", "left_outer", "right_outer", "full_outer"):
        for lk, la in left_rows:
            for rk, rb in right_rows:
                if lk == rk:
                    out[(lk, la, rk, rb)] += 1
        if join_type in ("left_outer", "full_outer"):
            for lk, la in left_rows:
                if not any(rk == lk for rk, _ in right_rows):
                    out[(lk, la, None, None)] += 1
        if join_type in ("right_outer", "full_outer"):
            for rk, rb in right_rows:
                if not any(lk == rk for lk, _ in left_rows):
                    out[(None, None, rk, rb)] += 1
        return out
    side_rows = left_rows if join_type.startswith("left") else right_rows
    other = right_rows if join_type.startswith("left") else left_rows
    anti = join_type.endswith("anti")
    for k, v in side_rows:
        if any(ok == k for ok, _ in other) != anti:
            out[(k, v)] += 1
    return out


#: (side, rows, ops): 0 insert, 1 delete; every delete retracts a live
#: row.  The pool/dense script keeps the left side append-only, the
#: pool/pool script both.
SCRIPT = [
    ("left", [(1, 10)], [0]),
    ("right", [(1, 100), (2, 200)], [0, 0]),
    ("left", [(2, 20), (3, 30)], [0, 0]),
    ("right", [(1, 101), (3, 300)], [0, 0]),
    ("right", [(1, 100)], [1]),
    ("left", [(1, 10)], [1]),
    ("right", [(1, 101)], [1]),
    ("left", [(4, 40), (4, 41)], [0, 0]),
    ("right", [(4, 400), (4, 400)], [0, 0]),
    ("right", [(4, 400), (4, 400)], [1, 1]),
    ("left", [(5, 50), (5, 50)], [0, 1]),
    ("right", [(3, 300), (3, 300), (2, 201)], [1, 0, 0]),
]
SCRIPT_POOL_LEFT = [
    ("left", [(1, 10), (1, 11)], [0, 0]),
    ("right", [(1, 100), (2, 200)], [0, 0]),
    ("left", [(2, 20), (3, 30), (9, 90)], [0, 0, 0]),
    ("right", [(1, 100), (3, 300)], [1, 0]),
    ("right", [(2, 200), (2, 201), (1, 102)], [1, 0, 0]),
    ("right", [(3, 300), (3, 301), (3, 301)], [1, 0, 1]),
    ("left", [(3, 31)], [0]),
]
SCRIPT_APPEND_ONLY = [
    ("left", [(1, 10), (1, 11)], [0, 0]),
    ("right", [(2, 200)], [0]),
    ("right", [(1, 100), (1, 101), (3, 300)], [0, 0, 0]),
    ("left", [(2, 20), (4, 40), (3, 30), (3, 31)], [0, 0, 0, 0]),
    ("right", [(4, 400), (5, 500)], [0, 0]),
]

_JIT: dict = {}


def _jitted(j):
    if id(j) not in _JIT:
        _JIT[id(j)] = (
            j,
            jax.jit(j.apply_begin, static_argnums=(2,)),
            jax.jit(j.emit_window, static_argnums=(3,)),
        )
    return _JIT[id(j)][1:]


def _apply_both(j, t, jst, tst, jc, tc, side):
    """apply_begin on both, then every emission window; asserts the
    windows and the states equal and returns the port's windows."""
    j_begin, j_emit = _jitted(j)
    jst, jp = j_begin(jst, jc, side)
    tst, tp = t.apply_begin(tst, tc, side)
    total = int(jp.total)
    assert int(tp.total) == total
    jb, tb = j.build_rows_of(jst, side), t.build_rows_of(tst, side)
    outs = []
    w = 0
    while w == 0 or w * j.out_capacity < total:
        jo, jbound = j_emit(jb, jp, jnp.int32(w), side)
        to, tbound = t.emit_window(tb, tp, w, side)
        jst = jst._replace(emit_overflow=jst.emit_overflow + jbound)
        tst.emit_overflow.add_(tbound)
        np.testing.assert_array_equal(np.asarray(jo.ops), to.ops.numpy())
        np.testing.assert_array_equal(np.asarray(jo.valid), to.valid.numpy())
        assert [(f.name, f.nullable) for f in jo.schema] == \
            [(f.name, f.nullable) for f in to.schema]
        for a, b in zip(jo.columns, to.columns):
            pa, pb = _planes(a), _planes(b)
            assert len(pa) == len(pb)
            for x, y in zip(pa, pb):
                np.testing.assert_array_equal(x, y)
        outs.append(to)
        w += 1
    assert state_mismatches(jax.device_get(jst), tst) == []
    return jst, tst, outs


def _executors(join_type, storage, out_cap=4, bucket=8):
    left, _, right = storage.partition("_")
    kw = dict(table_size=16, bucket_cap=bucket, out_capacity=out_cap,
              join_type=join_type, left_storage=left,
              right_storage=right or "dense", left_pool_size=64,
              right_pool_size=64)
    return (jhj.HashJoinExecutor(JL, JR, [JRef(0)], [JRef(0)], **kw),
            hj.HashJoinExecutor(TL, TR, [InputRef(0)], [InputRef(0)], **kw))


@pytest.mark.parametrize("storage", ["dense", "pool", "pool_pool"])
@pytest.mark.parametrize("join_type", hj.JOIN_TYPES)
def test_join_matrix_matches_reference(join_type, storage):
    """``storage``: the left side's (the right one dense), or pool on
    both sides (append-only inputs)."""
    j, t = _executors(join_type, storage)
    jst, tst = j.init_state(), t.init_state("cpu")
    script = {"dense": SCRIPT, "pool": SCRIPT_POOL_LEFT,
              "pool_pool": SCRIPT_APPEND_ONLY}[storage]
    acc = Counter()
    live = {"left": [], "right": []}
    for side, rows, ops in script:
        for r, o in zip(rows, ops):
            if o == 0:
                live[side].append(r)
            else:
                live[side].remove(r)
        schemas = (JL, TL) if side == "left" else (JR, TR)
        jc, tc = _chunks(*schemas, rows, ops)
        jst, tst, outs = _apply_both(j, t, jst, tst, jc, tc, side)
        for o in outs:
            _fold(acc, o)
        want = expected(join_type, live["left"], live["right"])
        assert +acc == +want, f"{join_type} after {side} {rows} {ops}"
    for s in (tst.left, tst.right):
        assert int(s.inconsistency) == 0 and int(s.overflow) == 0
    assert int(tst.emit_overflow) == 0


def _side_pair(bucket):
    kw = dict(table_size=8, bucket_cap=bucket, out_capacity=8,
              join_type="left_outer")
    j = jhj.HashJoinExecutor(JL, JW, [JRef(0)], [JRef(0)], **kw)
    t = hj.HashJoinExecutor(TL, TW, [InputRef(0)], [InputRef(0)], **kw)
    return j, t


#: dense-side update cases on (k, s VARCHAR, v nullable): rows, ops
UPDATE_CASES = {
    "duplicates": [
        ([(1, "a", 5), (1, "a", 5), (1, "a", 5), (2, "b", None)],
         [0, 0, 0, 0]),
        ([(1, "a", 5), (1, "a", 5)], [1, 1]),
    ],
    "annihilation": [
        ([(1, "a", 5), (3, "c", None)], [0, 0]),
        ([(1, "a", 5), (1, "a", 5), (1, "a", 6), (3, "c", None),
          (3, "c", None)], [1, 0, 3, 0, 1]),
    ],
    "missing_delete": [
        ([(1, "a", 5)], [0]),
        ([(1, "a", 6), (7, "z", None), (1, "a", None)], [1, 1, 2]),
    ],
    "full_bucket": [
        ([(1, "a", i) for i in range(6)] + [(2, "bb", None)], [0] * 7),
        ([(1, "a", 0), (1, "x", 9), (1, "y", 9)], [1, 0, 0]),
    ],
}


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_update_side_dense_matches_reference(case):
    j, t = _side_pair(bucket=4)
    jst, tst = j.init_state(), t.init_state("cpu")
    upd = jax.jit(lambda side, chunk: j._update_side(side, chunk,
                                                     j.right_keys))
    jside, tside = jst.right, tst.right
    for rows, ops in UPDATE_CASES[case]:
        jc, tc = _chunks(JW, TW, rows, ops, cap=8)
        jside = upd(jside, jc)
        key_cols, null_keys = hj._null_stripped_keys(
            [e.eval(tc) for e in t.right_keys])
        hj.update_side_dense(tside, tc, key_cols, null_keys,
                             hj.hash64_columns(key_cols))
        assert state_mismatches(jax.device_get(jside), tside) == []


def test_wide_dense_build_emission_matches_reference():
    """A left-outer probe of a dense build holding strings and NULLs,
    with transitions of the padded auction rows."""
    j, t = _side_pair(bucket=4)
    jst, tst = j.init_state(), t.init_state("cpu")
    steps = [
        ("left", [(1, 10), (2, 20), (3, 30)], [0, 0, 0]),
        ("right", [(1, "a", 5), (1, "b", None), (2, "c", 7)], [0, 0, 0]),
        ("left", [(1, 11), (2, 21), (4, 40)], [0, 0, 0]),
        ("right", [(1, "a", 5), (1, "b", None), (2, "c", 7), (2, "c", 8)],
         [1, 1, 3, 2]),
    ]
    for side, rows, ops in steps:
        schemas = (JL, TL) if side == "left" else (JW, TW)
        jc, tc = _chunks(*schemas, rows, ops, cap=8)
        jst, tst, _ = _apply_both(j, t, jst, tst, jc, tc, side)


def test_dense_clean_and_rebuild_match_reference():
    """``clean_below`` on a dense side, then ``maybe_rehash``'s rebuild
    once tombstones pass a quarter of the table."""
    j, t = _executors("full_outer", "dense", out_cap=16)
    jst, tst = j.init_state(), t.init_state("cpu")
    rows = [(k, 100 + k) for k in range(9)]
    for side in ("left", "right"):
        schemas = (JL, TL) if side == "left" else (JR, TR)
        jc, tc = _chunks(*schemas, rows, [0] * len(rows))
        jst, tst, _ = _apply_both(j, t, jst, tst, jc, tc, side)
    jst = j.clean_below(jst, "right", 0, 6)
    tst = t.clean_below(tst, "right", 0, 6)
    assert state_mismatches(jax.device_get(jst), tst) == []
    assert int(tst.right.key_table.tombstone_count()) > 16 // 4
    jst = j.maybe_rehash(jst)
    tst = t.maybe_rehash(tst)
    assert state_mismatches(jax.device_get(jst), tst) == []
    jc, tc = _chunks(JR, TR, [(7, 1), (2, 2)], [1, 0])
    _apply_both(j, t, jst, tst, jc, tc, "right")
