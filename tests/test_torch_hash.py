"""Port parity: the 64-bit key hash (kernel A's plain version).

The same numpy inputs go through ``risingwave_tpu.common.hash`` and
``risingwave_tpu_torch.common.hash`` on the CPU.  Tolerance: none — the
hash is integer arithmetic, so every comparison is bit for bit.  Float
keys include -0.0, NaNs of both signs and other payloads, infinities,
float64 and float32 subnormals, values whose float32 residual (``lo``)
is subnormal or sits at the float32 normal boundary, and magnitudes past
float32's range: the reference folds them as XLA's CPU runtime computes
them, with denormals-are-zero and flush-to-zero set.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.common import hash as jhash
from risingwave_tpu.common.chunk import NCol as JNCol, StrCol as JStrCol
from risingwave_tpu_torch.common import hash as thash
from risingwave_tpu_torch.common.chunk import NCol, StrCol

N = 2000
U64 = (1 << 64) - 1


def _cols(kind: str, seed: int):
    """(reference columns, port columns) of one key shape."""
    rng = np.random.default_rng(seed)
    i64 = rng.integers(-2**63, 2**63 - 1, N, dtype=np.int64)
    i64[: N // 4] = i64[: N // 4] % 5           # duplicates
    i32 = rng.integers(-2**31, 2**31 - 1, N, dtype=np.int32)
    i16 = rng.integers(-2**15, 2**15 - 1, N, dtype=np.int16)
    b = rng.random(N) < 0.5
    null = rng.random(N) < 0.3
    j, t = jnp.asarray, torch.from_numpy
    if kind == "int64":
        return [j(i64)], [t(i64)]
    if kind == "int32":
        return [j(i32)], [t(i32)]
    if kind == "int16":
        return [j(i16)], [t(i16)]
    if kind == "bool":
        return [j(b)], [t(b)]
    if kind == "int64 nullable":
        return [JNCol(j(i64), j(null))], [NCol(t(i64), t(null))]
    if kind == "multi":
        return ([j(i64), JNCol(j(i32), j(null)), j(b)],
                [t(i64), NCol(t(i32), t(null)), t(b)])
    if kind.startswith("float"):
        x = _float_values(rng)
        if kind == "float32":
            with np.errstate(all="ignore"):
                x = x.astype(np.float32)
        if kind == "float64 nullable":
            return [JNCol(j(x), j(null)), j(i32)], [NCol(t(x), t(null)),
                                                    t(i32)]
        return [j(x)], [t(x)]
    if kind.startswith("strings"):
        # q19/q18's row shape: ints around two strings (16 and 40 bytes,
        # and an odd width), random bytes past each length
        cols_j, cols_t = [j(i64)], [t(i64)]
        for w in (16, 40, 3):
            data = rng.integers(0, 256, (N, w)).astype(np.uint8)
            lens = rng.integers(0, w + 1, N).astype(np.int32)
            data[: N // 4] = data[0]             # equal up to lens, not past
            lens[: N // 4] = lens[0] // 2
            sj, st = JStrCol(j(data), j(lens)), StrCol(t(data), t(lens))
            if kind == "strings nullable" and w == 40:
                sj, st = JNCol(sj, j(null)), NCol(st, t(null))
            cols_j += [sj, j(i32)]
            cols_t += [st, t(i32)]
        return cols_j, cols_t
    raise AssertionError(kind)


FLT_MIN = float(np.finfo(np.float32).tiny)
FLOAT_EDGES = np.array([
    0.0, -0.0, np.inf, -np.inf, 1e-40, -1e-40, 1e-310, -1e-310, 5e-324,
    -5e-324, 1.5e-38 + 1e-45, float(np.float32(1.2e-38)) + 3e-46,
    1.0 + 2.0 ** -60, 1.0 + 2.0 ** -140, 3.4e38 * 1.0000001, 1e300, -1e300,
    2.5, FLT_MIN * (1 - 2.0 ** -30), -FLT_MIN * (1 - 2.0 ** -30),
    FLT_MIN * (1 - 2.0 ** -20), FLT_MIN, -FLT_MIN * (1 + 2.0 ** -40)])
NANS = np.array([0x7FF8000000000000, 0xFFF8000000000000,
                 0x7FF0000000000001, 0x7FF4000000000123],
                np.uint64).view(np.float64)


def _float_values(rng) -> np.ndarray:
    """Edge values (repeated, so equal keys meet) and random magnitudes
    from 1e-45 to 1e45, both signs."""
    x = rng.standard_normal(N) * 10.0 ** rng.integers(-45, 45, N)
    edges = np.concatenate([FLOAT_EDGES, NANS])
    x[: 4 * len(edges)] = np.tile(edges, 4)
    return x


@pytest.mark.parametrize("kind", ["int64", "int32", "int16", "bool",
                                  "int64 nullable", "multi", "strings",
                                  "strings nullable", "float64", "float32",
                                  "float64 nullable"])
@pytest.mark.parametrize("seed", [0, 1])
def test_hash64_columns_bit_identical(kind, seed):
    jcols, tcols = _cols(kind, seed)
    want = np.asarray(jhash.hash64_columns(jcols))
    got = thash.hash64_columns(tcols).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, want)


def test_hash64_nulls_zeroed_payload():
    """NULL rows hash alike whatever their payload (grouping equality)."""
    data = torch.tensor([1, 2, 3, 4], dtype=torch.int64)
    null = torch.tensor([True, True, False, False])
    h = thash.hash64_columns([NCol(data, null)])
    assert h[0] == h[1] and h[2] != h[3]


def test_hash64_string_keys_plain():
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, (N, 12), dtype=np.uint8)
    lens = rng.integers(0, 13, N).astype(np.int32)
    want = np.asarray(jhash.hash64_columns(
        [JStrCol(jnp.asarray(data), jnp.asarray(lens))]))
    got = thash.hash64_columns(
        [StrCol(torch.from_numpy(data), torch.from_numpy(lens))])
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)


def test_hash64_matches_numpy_host_twin():
    vals = np.random.default_rng(9).integers(-2**63, 2**63 - 1, 5000,
                                             dtype=np.int64)
    got = thash.hash64_columns([torch.from_numpy(vals)]).numpy()
    np.testing.assert_array_equal(got.view(np.uint64),
                                  jhash.hash64_i64_host(vals))


def _inv_xorshift(y: int, s: int) -> int:
    x = y
    for _ in range(64 // s + 1):
        x = y ^ (x >> s)
    return x & U64


def _key_hashing_to_all_ones() -> int:
    """The int64 key whose unfinalized hash is ~0 (the mix inverted)."""
    k1, k2, k3 = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9,
                  0x94D049BB133111EB)
    x = _inv_xorshift(U64, 31)
    x = _inv_xorshift(x * pow(k3, -1, 1 << 64) & U64, 27)
    x = _inv_xorshift(x * pow(k2, -1, 1 << 64) & U64, 30)
    u = ((x ^ k1) * pow(k1, -1, 1 << 64)) & U64
    return u - (1 << 64) if u >= 1 << 63 else u


def test_hash64_all_ones_remapped():
    """A key hashing to ~0 maps to ~1, in the port as in the reference."""
    key = np.array([_key_hashing_to_all_ones(), 7], dtype=np.int64)
    want = np.asarray(jhash.hash64_columns([jnp.asarray(key)]))
    got = thash.hash64_columns([torch.from_numpy(key)]).numpy()
    assert want[0] == np.uint64(U64 - 1)
    np.testing.assert_array_equal(got.view(np.uint64), want)
    np.testing.assert_array_equal(got.view(np.uint64),
                                  jhash.hash64_i64_host(key))


def test_string_keys_refused_on_cuda_descriptor():
    """String keys reach the kernels' descriptor as two leaves, the bytes
    (marked as a string for the hash) and the lengths, both with the
    column's null plane; float keys as one leaf of a float kind; the CUDA
    entry refuses tensors that are not on the card."""
    from risingwave_tpu_torch import kernels

    s = StrCol(torch.zeros((2, 40), dtype=torch.uint8),
               torch.zeros(2, dtype=torch.int32))
    null = torch.tensor([True, False])
    leaves = thash.key_leaves([torch.zeros(2, dtype=torch.int64),
                               NCol(s, null)])
    assert [k for _, _, k in leaves] == [
        kernels.KIND_WORD, kernels.KIND_STR, kernels.KIND_LENS]
    assert [thash.leaf_width(d) for d, _, _ in leaves] == [8, 40, 4]
    assert leaves[1][1] is null and leaves[2][1] is null
    floats = thash.key_leaves([torch.zeros(2, dtype=torch.float64),
                               NCol(torch.zeros(2), null)])
    assert [k for _, _, k in floats] == [kernels.KIND_F64, kernels.KIND_F32]
    assert floats[1][1] is null
    with pytest.raises(ValueError, match="CUDA"):
        thash.hash64_columns_cuda([torch.zeros(2, dtype=torch.float64)])
    with pytest.raises(NotImplementedError):
        thash.key_leaves([torch.zeros(2, dtype=torch.float16)])


def test_float_key_words_canonical():
    """SQL-equal floats fold to equal words: -0.0 and subnormals as +0.0,
    every NaN as one NaN (0x7FC00000 in both float64 words)."""
    x = torch.tensor([0.0, -0.0, 1e-310, -1e-310, float("nan"),
                      -float("nan")], dtype=torch.float64)
    hi, lo = thash.float_key_words(x)
    assert hi.tolist() == [0, 0, 0, 0, 0x7FC00000, 0x7FC00000]
    assert lo.tolist() == [0, 0, 0, 0, 0x7FC00000, 0x7FC00000]
    h = thash.hash64_columns([x])
    assert len(set(h[:4].tolist())) == 1 and h[4] == h[5]
