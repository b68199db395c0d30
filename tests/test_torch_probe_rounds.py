"""Port parity on the corner cases of the probe's claim rounds (K3) and of
the join's pool update (K13).

K3's kernel resolves each row's walk over the call-start table first and
replays the reference's claim rounds over the claimants only; K13's runs
as grid passes (a rank by binary search, the bump offsets, the degree
add from each key's rank-0 row).  These cases are the ones such a
redesign could get wrong.  Each is built from a numpy seed and goes
through the reference (``HashTable._probe`` behind ``lookup_or_insert``
and ``lookup_counted``, ``HashJoinExecutor._update_side_pool``) and the
port's plain versions (``HashTable._probe_plain``,
``_update_side_pool_plain``), which ``chip_smoke.py`` holds the kernels
against on the card with the same cases (``chip_smoke.k3_cases``,
``chip_smoke.k13_cases``).  Tolerance: none — both paths are integer
and deterministic (the lowest row index wins a claim).
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.common.chunk import Chunk as JChunk, StrCol as JStrCol
from risingwave_tpu.common.types import (
    DataType as JType,
    Field as JField,
    Schema as JSchema,
)
from risingwave_tpu.expr.node import InputRef as JRef
from risingwave_tpu.state.hash_table import HashTable as JTable
from risingwave_tpu.stream import hash_join as jhj
from risingwave_tpu_torch.common.chunk import (
    OP_DELETE, OP_UPDATE_DELETE, Chunk)
from risingwave_tpu_torch.common.hash import hash64_columns_plain
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.compat import state_from_numpy, state_mismatches
from risingwave_tpu_torch.expr.node import InputRef
from risingwave_tpu_torch.stream import hash_join as hj

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the cases, shared with the card's phases)

# ---------------------------------------------------------------------------
# K3: HashTable._probe


@jax.jit
def _j_insert(t, keys, valid):
    return t.lookup_or_insert(keys, valid)


@jax.jit
def _j_lookup(t, keys, valid):
    return t.lookup_counted(keys, valid)


K3_CASES = {name: (size, kind, steps)
            for name, size, kind, steps in chip_smoke.k3_cases()}


def _j_cols(cols):
    return [JStrCol(jnp.asarray(c[0]), jnp.asarray(c[1]))
            if isinstance(c, tuple) else jnp.asarray(c) for c in cols]


def _j_empty(size: int, kind: str):
    protos = [jnp.zeros((1,), jnp.float64 if kind == "float64"
                        else jnp.int64)]
    if kind == "int64+varchar8":
        protos.append(JStrCol(jnp.zeros((1, 8), jnp.uint8),
                              jnp.zeros((1,), jnp.int32)))
    return JTable.create(protos, size)


def _assert_tables_equal(jt, tt):
    jh = jax.device_get(jt)
    for jc, tc in zip(jh.key_cols, tt.key_cols):
        if isinstance(tc, torch.Tensor) and tc.dtype.is_floating_point:
            # NaN keys: compare the key store by bit pattern
            np.testing.assert_array_equal(
                np.asarray(jc).view(np.int64), tc.numpy().view(np.int64))
        else:
            assert state_mismatches(jc, tc) == []
    assert state_mismatches((jh.occupied, jh.tombstone),
                            (tt.occupied, tt.tombstone)) == []


def _replay(size: int, kind: str, steps):
    """Every step through both; asserts equal rows and tables after each
    and returns the port's ``(slots, inserted/found, overflow, n_over)``
    of each probe step."""
    jt = _j_empty(size, kind)
    tt = state_from_numpy(jax.device_get(jt))
    outs = []
    for step in steps:
        if step[0] == "clear":
            jt = jt.clear_where(jnp.asarray(step[1]))
            tt = tt.clear_where(torch.from_numpy(step[1]))
            _assert_tables_equal(jt, tt)
            continue
        op, cols, valid = step
        jk, tk = _j_cols(cols), chip_smoke.k3_torch_cols(torch, cols, "cpu")
        jv, tv = jnp.asarray(valid), torch.from_numpy(valid)
        if op == "insert":
            jt, js, ji, jo = _j_insert(jt, jk, jv)
            jn = jnp.sum(jo & jv)
        else:
            js, ji, jn = _j_lookup(jt, jk, jv)
            jo = None
        _, ts, ti, to, tn = tt._probe_plain(tk, tv, op == "insert")
        np.testing.assert_array_equal(np.asarray(js), ts.numpy(), "slots")
        np.testing.assert_array_equal(np.asarray(ji), ti.numpy(),
                                      "inserted/found")
        if jo is not None:
            np.testing.assert_array_equal(np.asarray(jo), to.numpy(),
                                          "overflow")
        assert int(jn) == int(tn)
        _assert_tables_equal(jt, tt)
        outs.append((ts.numpy(), ti.numpy(), to.numpy(), int(tn)))
    return tt, outs


def _home(key: int, size: int) -> int:
    h = hash64_columns_plain([torch.tensor([key], dtype=torch.int64)])
    return int(h[0]) & (size - 1)


def _check_duplicates(tt, outs):
    slots, ins, _, _ = outs[1]
    assert ins[5] and not ins[17] and not ins[40]
    assert slots[5] == slots[17] == slots[40] < tt.size
    assert ins[2] and not ins[3] and slots[2] == slots[3]


def _check_collision(tt, outs):
    slots, ins, _, _ = outs[0]
    assert ins[3] and ins[9]
    assert slots[9] == 1000 and slots[3] == 1000 + 4 * 64


def _check_late_entry(tt, outs):
    slots, ins, _, _ = outs[1]
    assert ins[0] and ins[50]
    assert slots[50] == 2002 and slots[0] == 2003


def _check_tombstones(tt, outs):
    assert list(outs[0][0]) == list(range(300, 308))
    assert list(outs[1][1][:6]) == [True] * 3 + [False] * 3
    slots, ins, _, _ = outs[2]
    assert list(ins[:6]) == [False] * 3 + [True] * 3
    assert sorted(slots[3:6]) == [308, 309, 310]


def _check_near_full(tt, outs):
    _, _, over, n_over = outs[3]
    assert over.any() and n_over == over.sum()
    _, found, _, n_over = outs[4]
    assert not found.any() and n_over == 64


def _check_all_invalid(tt, outs):
    for slots, ins, over, n_over in outs[1:]:
        assert (slots == tt.size).all() and not ins.any() and not over.any()
        assert n_over == 0


K3_CHECKS = {"duplicate new keys": _check_duplicates,
             "scratch collision": _check_collision,
             "late entry": _check_late_entry,
             "tombstones": _check_tombstones,
             "near full": _check_near_full,
             "all invalid": _check_all_invalid}


@pytest.mark.parametrize("name", list(K3_CASES))
def test_probe_case(name):
    """The reference's rounds on each case, insert and lookup; the named
    cases also check that they exercise what they name."""
    tt, outs = _replay(*K3_CASES[name])
    if name in K3_CHECKS:
        K3_CHECKS[name](tt, outs)


def test_probe_cases_hit_their_homes():
    """The layouts the collision and late-entry cases rely on."""
    _, _, steps = K3_CASES["scratch collision"]
    k = steps[0][1][0]
    assert _home(int(k[9]), 1 << 12) + 4 * 64 == _home(int(k[3]), 1 << 12)
    _, _, steps = K3_CASES["late entry"]
    p1, p2 = steps[0][1][0]
    k = steps[1][1][0]
    assert [_home(int(x), 1 << 12) for x in (p1, p2, k[0], k[50])] == \
        [2000, 2001, 2000, 2002]


# ---------------------------------------------------------------------------
# K13: HashJoinExecutor._update_side_pool


JL = JSchema((JField("k", JType.INT64), JField("w", JType.TIMESTAMP),
              JField("name", JType.VARCHAR, str_width=8)))
TL = Schema((Field("k", DataType.INT64), Field("w", DataType.TIMESTAMP),
             Field("name", DataType.VARCHAR, str_width=8)))
K13_CASES = {c[0]: c[1:] for c in chip_smoke.k13_cases()}


def _join_pair(pool: int):
    kw = dict(out_capacity=16, join_type="inner", left_storage="pool",
              right_storage="pool", left_pool_size=pool,
              right_pool_size=pool)
    j = jhj.HashJoinExecutor(JL, JL, [JRef(0), JRef(1)], [JRef(0), JRef(1)],
                             **kw)
    t = hj.HashJoinExecutor(TL, TL, [InputRef(0), InputRef(1)],
                            [InputRef(0), InputRef(1)], **kw)
    j.left_clean = t.left_clean = (1, 1000, 1)
    upd = jax.jit(lambda side, chunk: j._update_side_pool(
        side, chunk, j.left_keys, j.left_clean))
    return j, t, upd


def _side_chunk(k, ops, valid, cap):
    arrays = chip_smoke.k13_chunk_arrays(k)
    jc = JChunk.from_numpy(JL, arrays, ops=ops, capacity=cap)
    tc = Chunk.from_numpy(TL, arrays, ops=ops, capacity=cap)
    if valid is not None:
        full = np.zeros(cap, bool)
        full[:len(k)] = valid
        jc = JChunk(jc.columns, jc.ops, jnp.asarray(full), jc.schema)
        tc = Chunk(tc.columns, tc.ops, torch.from_numpy(full), tc.schema)
    return jc, tc


def _key_hash(t, tc):
    key_cols, null_keys = hj._null_stripped_keys(
        [e.eval(tc) for e in t.left_keys])
    return key_cols, null_keys, hash64_columns_plain(key_cols)


def _rank0_over_while_placed(t, tside, tc) -> bool:
    """Some key's rank-0 row runs over the ranked probe's bound while a
    later row of the key is accepted (the plain K12 on a copy)."""
    _, null_keys, h = _key_hash(t, tc)
    is_ins = hj.insert_mask(tc, null_keys)
    cr = hj._rank_by(h, is_ins)
    over = tside.table.clone()._ranked_plain(
        h, cr, tside.count.clone(), is_ins)[6].numpy()
    ins = is_ins.numpy()
    got = ins & ~over
    keys, cr = tc.columns[0].numpy(), cr.numpy()
    for key in np.unique(keys[ins]):
        rows = np.flatnonzero((keys == key) & ins)
        r0 = rows[cr[rows] == 0]
        if len(r0) and over[r0[0]] and got[rows].any():
            return True
    return False


@pytest.mark.parametrize("name", list(K13_CASES))
def test_pool_update_case(name):
    """The pool side update through both after each chunk of the case:
    the whole side (tags, count, pool_pos, slot_clean, rows, pool_len,
    counters) and the probe rounds."""
    pool, pool_len, tags, chunks = K13_CASES[name]
    j, t, upd = _join_pair(pool)
    jside = j.init_state().left._replace(pool_len=jnp.int32(pool_len))
    if tags is not None:
        jside = jside._replace(table=jside.table.__class__(
            jnp.asarray(tags), pool))
    tside = state_from_numpy(jax.device_get(jside))
    for k, ops, valid, cap in chunks:
        jc, tc = _side_chunk(k, ops, valid, cap)
        if name == "rank-0 row over the bound":
            assert _rank0_over_while_placed(t, tside, tc)
        jside, jit_ = upd(jside, jc)
        key_cols, null_keys, h = _key_hash(t, tc)
        tside, tit = hj._update_side_pool_plain(tside, tc, t.left_clean,
                                                key_cols, null_keys, h)
        assert int(jit_) == int(tit)
        assert state_mismatches(jax.device_get(jside), tside) == []
    if name == "hot key":
        assert int(tside.count.max()) == 400
    elif name == "pool overflow":
        assert int(tside.pool_len) == 64 and int(tside.overflow) == 16
        assert int(tside.table.tombstone_count()) > 0
    elif name == "inactive rows and deletes":
        k, ops, valid, _ = chunks[0]
        dels = valid & ((ops == OP_DELETE) | (ops == OP_UPDATE_DELETE))
        assert int(tside.inconsistency) == dels.sum() > 0
        assert int(tside.pool_len) == (valid & ~dels).sum()
