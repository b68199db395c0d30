"""Port parity: the open-addressing ``HashTable`` (kernel B's plain
version).

Both tables start from the same state and take the same chunks; the
port's table must equal the reference's element for element after every
step (occupied, tombstone, key store), and the per-row outputs (slots,
inserted/found, overflow) must be equal.  Tolerance: none — the probe
is integer and deterministic (lowest row index wins a claim).
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.common.chunk import NCol as JNCol, StrCol as JStrCol
from risingwave_tpu.common.hash import hash64_columns as jhash64
from risingwave_tpu.state.hash_table import (
    HashTable as JTable,
    permute_dense as jpermute,
)
from risingwave_tpu_torch.common.chunk import NCol, StrCol
from risingwave_tpu_torch.common.hash import hash64_columns_plain
from risingwave_tpu_torch.compat import state_from_numpy, state_mismatches
from risingwave_tpu_torch.state.hash_table import HashTable, permute_dense

CAP = 64


@jax.jit
def _j_insert(t, keys, valid):
    return t.lookup_or_insert(keys, valid)


@jax.jit
def _j_lookup(t, keys, valid):
    return t.lookup_counted(keys, valid)


def _both(nullable: bool, size: int):
    protos = [jnp.zeros((1,), jnp.int64)]
    if nullable:
        protos.append(JNCol(jnp.zeros((1,), jnp.int32),
                            jnp.zeros((1,), jnp.bool_)))
    jt = JTable.create(protos, size)
    return jt, state_from_numpy(jax.device_get(jt))


def _chunk(rng, key_range: int, nullable: bool):
    k = rng.integers(0, key_range, CAP).astype(np.int64)
    valid = rng.random(CAP) < 0.9
    jk, tk = [jnp.asarray(k)], [torch.from_numpy(k)]
    if nullable:
        k2 = rng.integers(0, 3, CAP).astype(np.int32)
        null = rng.random(CAP) < 0.3
        jk.append(JNCol(jnp.asarray(k2), jnp.asarray(null)))
        tk.append(NCol(torch.from_numpy(k2), torch.from_numpy(null)))
    return jk, tk, jnp.asarray(valid), torch.from_numpy(valid)


def _assert_rows_equal(jres, tres):
    for name, a, b in zip(("slots", "inserted/found", "overflow"),
                          jres, tres):
        np.testing.assert_array_equal(np.asarray(a), b.numpy(), err_msg=name)


def _assert_tables_equal(jt, tt):
    assert state_mismatches(jax.device_get(jt), tt) == []


@pytest.mark.parametrize("nullable", [False, True])
@pytest.mark.parametrize("key_range", [40, 1000, 10**12])
def test_lookup_or_insert_chunks_tombstones(nullable, key_range):
    """Several chunks with duplicate keys, collisions in a 2^8 table and
    tombstones from ``clear_where`` in between."""
    rng = np.random.default_rng(key_range + nullable)
    jt, tt = _both(nullable, 1 << 8)
    for step in range(4):
        jk, tk, jv, tv = _chunk(rng, key_range, nullable)
        jt, js, ji, jo = _j_insert(jt, jk, jv)
        tt, ts, ti, to = tt.lookup_or_insert(tk, tv)
        _assert_rows_equal((js, ji, jo), (ts, ti, to))
        _assert_tables_equal(jt, tt)
        if step == 1:
            pred = rng.random(1 << 8) < 0.4
            jt = jt.clear_where(jnp.asarray(pred))
            tt = tt.clear_where(torch.from_numpy(pred))
            _assert_tables_equal(jt, tt)
    # probe-only lookups over the final table
    jk, tk, jv, tv = _chunk(rng, key_range, nullable)
    js, jf, jn = _j_lookup(jt, jk, jv)
    ts, tf, tn = tt.lookup_counted(tk, tv)
    _assert_rows_equal((js, jf), (ts, tf))
    assert int(jn) == int(tn)
    _assert_rows_equal((js, jf), tt.lookup(tk, tv))


def test_near_full_table_overflows_identically():
    rng = np.random.default_rng(7)
    jt, tt = _both(False, 1 << 8)
    for _ in range(5):  # 320 distinct keys into 256 slots
        jk, tk, jv, tv = _chunk(rng, 10**12, False)
        jt, js, ji, jo = _j_insert(jt, jk, jv)
        tt, ts, ti, to = tt.lookup_or_insert(tk, tv)
        _assert_rows_equal((js, ji, jo), (ts, ti, to))
        _assert_tables_equal(jt, tt)
    assert to.any()


def test_rehashed_same_permutation():
    rng = np.random.default_rng(11)
    jt, tt = _both(False, 1 << 8)
    for _ in range(3):
        jk, tk, jv, tv = _chunk(rng, 10**6, False)
        jt, *_ = _j_insert(jt, jk, jv)
        tt, *_ = tt.lookup_or_insert(tk, tv)
    pred = rng.random(1 << 8) < 0.5
    jt = jt.clear_where(jnp.asarray(pred))
    tt = tt.clear_where(torch.from_numpy(pred))
    jfresh, jmoved = jt.rehashed()
    tfresh, tmoved = tt.rehashed()
    np.testing.assert_array_equal(np.asarray(jmoved), tmoved.numpy())
    _assert_tables_equal(jfresh, tfresh)
    vals = rng.integers(-100, 100, 1 << 8).astype(np.int64)
    np.testing.assert_array_equal(
        np.asarray(jpermute(jnp.asarray(vals), jmoved, init=-7)),
        permute_dense(torch.from_numpy(vals), tmoved, init=-7).numpy())


def test_clear_slots_and_gather_keys():
    rng = np.random.default_rng(3)
    jt, tt = _both(False, 1 << 8)
    jk, tk, jv, tv = _chunk(rng, 10**6, False)
    jt, js, *_ = _j_insert(jt, jk, jv)
    tt, ts, *_ = tt.lookup_or_insert(tk, tv)
    mask = rng.random(CAP) < 0.5
    jt = jt.clear_slots(js, jnp.asarray(mask))
    tt = tt.clear_slots(ts, torch.from_numpy(mask))
    _assert_tables_equal(jt, tt)
    np.testing.assert_array_equal(np.asarray(jt.gather_keys(js)[0]),
                                  tt.gather_keys(ts)[0].numpy())


def test_string_keys_compare_padding_hash_masks_it():
    """A (BIGINT, VARCHAR) pk as an MV's whole-row key: equal strings with
    different bytes past their length hash alike (the hash masks them)
    but are different keys (``_keys_equal`` compares all ``w`` bytes),
    so they claim neighbouring slots of one probe chain, as in the
    reference; tombstones from ``clear_where`` in between."""
    w = 8
    rng = np.random.default_rng(21)
    protos = [jnp.zeros((1,), jnp.int64),
              JStrCol(jnp.zeros((1, w), jnp.uint8),
                      jnp.zeros((1,), jnp.int32))]
    jt = JTable.create(protos, 1 << 8)
    tt = state_from_numpy(jax.device_get(jt))
    for step in range(4):
        k = rng.integers(0, 4, CAP).astype(np.int64)
        data = rng.integers(0, 256, (CAP, w)).astype(np.uint8)
        lens = rng.integers(0, 4, CAP).astype(np.int32)
        data[:, :4] = data[0, :4]               # few distinct prefixes
        valid = rng.random(CAP) < 0.9
        jk = [jnp.asarray(k), JStrCol(jnp.asarray(data), jnp.asarray(lens))]
        tk = [torch.from_numpy(k), StrCol(torch.from_numpy(data),
                                          torch.from_numpy(lens))]
        jt, js, ji, jo = _j_insert(jt, jk, jnp.asarray(valid))
        tt, ts, ti, to = tt.lookup_or_insert(tk, torch.from_numpy(valid))
        _assert_rows_equal((js, ji, jo), (ts, ti, to))
        _assert_tables_equal(jt, tt)
        if step == 1:
            pred = rng.random(1 << 8) < 0.3
            jt = jt.clear_where(jnp.asarray(pred))
            tt = tt.clear_where(torch.from_numpy(pred))
    # equal (key, string up to lens) rows with other padding: equal
    # hashes, and a lookup finds only the byte-identical key
    jh = np.asarray(jhash64(jk))
    th = hash64_columns_plain(tk).numpy().view(np.uint64)
    np.testing.assert_array_equal(jh, th)
    js, jf, _ = _j_lookup(jt, jk, jnp.asarray(valid))
    ts, tf, _ = tt.lookup_counted(tk, torch.from_numpy(valid))
    _assert_rows_equal((js, jf), (ts, tf))
    flipped = data.copy()
    flipped[:, w - 1] ^= 0xFF                   # past every length
    tk2 = [tk[0], StrCol(torch.from_numpy(flipped), tk[1].lens)]
    np.testing.assert_array_equal(hash64_columns_plain(tk2).numpy(),
                                  hash64_columns_plain(tk).numpy())
    assert not tt.lookup(tk2, torch.from_numpy(valid))[1].any()


def test_create_requires_power_of_two():
    with pytest.raises(ValueError):
        HashTable.create([torch.zeros(1, dtype=torch.int64)], 100, "cpu")


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_float_keys_compare_with_ieee_equality(dtype):
    """Float keys compare as the reference's ``==`` under XLA's CPU
    runtime (denormals-are-zero): -0.0 finds +0.0, a subnormal finds
    zero, and a NaN key finds nothing, so it claims a new slot every
    time.  The key stores are compared by bit pattern (NaN != NaN)."""
    rng = np.random.default_rng(len(dtype))
    tiny = float(np.finfo(dtype).tiny)
    special = np.array([0.0, -0.0, tiny / 4, -tiny / 8, np.nan, -np.nan,
                        np.inf, -np.inf, 1.5, -1.5], dtype)
    jt = JTable.create([jnp.zeros((1,), dtype)], 1 << 8)
    tt = state_from_numpy(jax.device_get(jt))
    for step in range(3):
        k = rng.choice(special, CAP).astype(dtype)
        k[::5] = rng.integers(-20, 20, len(k[::5])) / 4.0
        valid = rng.random(CAP) < 0.9
        jk, tk = [jnp.asarray(k)], [torch.from_numpy(k)]
        jt, js, ji, jo = _j_insert(jt, jk, jnp.asarray(valid))
        tt, ts, ti, to = tt.lookup_or_insert(tk, torch.from_numpy(valid))
        _assert_rows_equal((js, ji, jo), (ts, ti, to))
        assert state_mismatches(jax.device_get(jt.occupied), tt.occupied) \
            == []
        np.testing.assert_array_equal(
            np.asarray(jt.key_cols[0]).view(f"int{8 * k.itemsize}"),
            tt.key_cols[0].numpy().view(f"int{8 * k.itemsize}"))
    js, jf, jn = _j_lookup(jt, [jnp.asarray(special)],
                           jnp.ones(len(special), bool))
    ts, tf, tn = tt.lookup_counted([torch.from_numpy(special)],
                                   torch.ones(len(special), dtype=torch.bool))
    _assert_rows_equal((js, jf), (ts, tf))
    assert tf.tolist()[:4] == [True] * 4 and tf.tolist()[4:6] == [False] * 2
    assert int(jn) == int(tn)
