"""Port parity: the vnode hash (K2's plain version, ``common/hash.py``)
and the lane mesh's hash exchange (K24's plain version,
``parallel/exchange.py``).

K2: ``compute_vnodes_plain`` and ``crc32_columns_plain`` against the
reference's ``compute_vnodes`` / ``crc32_columns`` and against
``zlib.crc32`` of each row's little-endian key bytes, over int16, int32,
int64, bool, float32 and float64 keys (NaN, -0.0, infinities, subnormals),
nullable keys and strings with random bytes past their lengths.

K24: the same numpy-seeded chunks of 4 lanes (int64, nullable int32,
nullable VARCHAR with bytes past the lengths, float64; random ops and
invalid rows; keys skewed onto one lane) go through the reference's
``shuffle_chunk`` inside its ``shard_map`` over 4 CPU devices and through
the port's ``shuffle_chunk`` over 4 lanes; every leaf of every lane's
received chunk (payloads, string bytes and lengths, NULL planes, ops,
valid, the fill of the unfilled slots) must be equal bit for bit.
Tolerance: none.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from risingwave_tpu.common import hash as jhash
from risingwave_tpu.common.chunk import (
    Chunk as JChunk,
    NCol as JNCol,
    StrCol as JStrCol,
)
from risingwave_tpu.common.types import (
    DataType as JDT,
    Field as JField,
    Schema as JSchema,
)
from risingwave_tpu.parallel.exchange import (
    shard_map_nocheck,
    shard_of_vnode as j_shard_of_vnode,
    shuffle_chunk as j_shuffle_chunk,
)
from risingwave_tpu.stream.sharded import make_mesh
from risingwave_tpu_torch.common.chunk import Chunk, NCol, StrCol
from risingwave_tpu_torch.common.hash import (
    VNODE_COUNT,
    compute_vnodes,
    compute_vnodes_plain,
    crc32_columns_plain,
)
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.parallel.exchange import (
    EXCHANGE_TRACE,
    reset_exchange_trace,
    shard_of_vnode,
    shuffle_chunk,
    single_shard_keys,
)

N = 300


def _keys(seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal(N).astype(np.float32)
    f32[:6] = [np.nan, -0.0, 0.0, np.inf, -np.inf, 1e-40]
    f64 = rng.standard_normal(N) * 1e6
    f64[:7] = [np.nan, -0.0, 0.0, -np.inf, np.inf, 1e-310, 1e300]
    return {
        "int64": rng.integers(-2**62, 2**62, N),
        "int32": rng.integers(-2**31, 2**31, N).astype(np.int32),
        "int16": rng.integers(-2**15, 2**15, N).astype(np.int16),
        "bool": rng.random(N) < 0.5,
        "float32": f32,
        "float64": f64,
    }


@pytest.mark.parametrize("kind", list(_keys()), ids=list(_keys()))
def test_vnodes_match_reference_and_zlib(kind):
    x = _keys()[kind]
    want = np.asarray(jhash.compute_vnodes([jnp.asarray(x)]))
    got = compute_vnodes([torch.from_numpy(x.copy())])
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
    crc = crc32_columns_plain([torch.from_numpy(x.copy())]).numpy()
    assert np.array_equal(crc, np.asarray(
        jhash.crc32_columns([jnp.asarray(x)])).astype(np.int64))
    if kind in ("int64", "int32", "int16"):
        assert all(crc[i] == zlib.crc32(x[i].tobytes()) for i in range(N))
    # nullable: a zeroed payload and the flag as 8 bytes; NULLs on one vnode
    nl = np.random.default_rng(1).random(N) < 0.3
    want = np.asarray(jhash.compute_vnodes(
        [JNCol(jnp.asarray(x), jnp.asarray(nl))]))
    got = compute_vnodes_plain([NCol(torch.from_numpy(x.copy()),
                                     torch.from_numpy(nl))]).numpy()
    assert np.array_equal(got, want) and len(set(got[nl])) == 1


def test_string_and_compound_vnodes():
    rng = np.random.default_rng(2)
    w = 12
    sb = rng.integers(0, 256, (N, w)).astype(np.uint8)
    sl = rng.integers(0, w + 1, N).astype(np.int32)
    nl = rng.random(N) < 0.25
    a = rng.integers(-2**40, 2**40, N)
    crc = crc32_columns_plain([StrCol(torch.from_numpy(sb),
                                      torch.from_numpy(sl))]).numpy()
    assert all(crc[i] == zlib.crc32(sb[i, :sl[i]].tobytes())
               for i in range(N))
    want = np.asarray(jhash.compute_vnodes([
        JNCol(JStrCol(jnp.asarray(sb), jnp.asarray(sl)), jnp.asarray(nl)),
        jnp.asarray(a)]))
    got = compute_vnodes([
        NCol(StrCol(torch.from_numpy(sb), torch.from_numpy(sl)),
             torch.from_numpy(nl)), torch.from_numpy(a)]).numpy()
    assert np.array_equal(got, want)
    vn = torch.arange(VNODE_COUNT, dtype=torch.int32)
    for n in (1, 3, 4, 8):
        assert np.array_equal(
            shard_of_vnode(vn, n).numpy(),
            np.asarray(j_shard_of_vnode(jnp.arange(VNODE_COUNT), n)))


LANES = 4
CAP = 64
W = 8


def _lane_chunks(seed: int):
    """(reference stacked leaves, port chunks) of LANES chunks."""
    rng = np.random.default_rng(seed)
    shape = (LANES, CAP)
    g = rng.integers(0, 40, shape).astype(np.int64)
    g[:, ::3] = 7  # skew: a third of the rows on one key
    v = rng.integers(-2**31, 2**31, shape).astype(np.int32)
    v_null = rng.random(shape) < 0.3
    sb = rng.integers(0, 256, shape + (W,)).astype(np.uint8)
    sl = rng.integers(0, W + 1, shape).astype(np.int32)
    s_null = rng.random(shape) < 0.2
    f = rng.standard_normal(shape)
    ops = rng.integers(0, 4, shape).astype(np.int8)
    valid = rng.random(shape) < 0.8
    ref = ((jnp.asarray(g), (jnp.asarray(v), jnp.asarray(v_null)),
            (jnp.asarray(sb), jnp.asarray(sl), jnp.asarray(s_null)),
            jnp.asarray(f)), jnp.asarray(ops), jnp.asarray(valid))
    schema = Schema((Field("g", DataType.INT64),
                     Field("v", DataType.INT32, nullable=True),
                     Field("s", DataType.VARCHAR, str_width=W,
                           nullable=True),
                     Field("f", DataType.FLOAT64)))
    port = [Chunk((torch.from_numpy(g[s]),
                   NCol(torch.from_numpy(v[s]), torch.from_numpy(v_null[s])),
                   NCol(StrCol(torch.from_numpy(sb[s]),
                               torch.from_numpy(sl[s])),
                        torch.from_numpy(s_null[s])),
                   torch.from_numpy(f[s])),
                  torch.from_numpy(ops[s]), torch.from_numpy(valid[s]),
                  schema) for s in range(LANES)]
    return ref, port


JSCHEMA = JSchema((JField("g", JDT.INT64),
                   JField("v", JDT.INT32, nullable=True),
                   JField("s", JDT.VARCHAR, str_width=W, nullable=True),
                   JField("f", JDT.FLOAT64)))
#: the key columns of each case, by column position
KEY_CASES = {"int64": (0,), "nullable string": (2,),
             "nullable int32 + float64": (1, 3), "constant": ()}


def _ref_shuffle(stacked, keys):
    mesh = make_mesh(LANES)

    def body(x):
        (g, (v, vn), (sb, sl, sn), f), ops, valid = jax.tree.map(
            lambda a: a[0], x)
        cols = (g, JNCol(v, vn), JNCol(JStrCol(sb, sl), sn), f)
        chunk = JChunk(cols, ops, valid, JSCHEMA)
        kc = [cols[i] for i in keys] if keys else \
            [jnp.zeros((CAP,), jnp.int64)]
        out = j_shuffle_chunk(chunk, kc, "shard", LANES)
        c = out.columns
        leaves = (c[0], c[1].data, c[1].null, c[2].data.data,
                  c[2].data.lens, c[2].null, c[3], out.ops, out.valid)
        return jax.tree.map(lambda a: a[None], leaves)

    fn = jax.jit(shard_map_nocheck(body, mesh=mesh, in_specs=(P("shard"),),
                                   out_specs=P("shard")))
    return [np.asarray(a) for a in fn(stacked)]


@pytest.mark.parametrize("case", list(KEY_CASES), ids=list(KEY_CASES))
def test_shuffle_matches_reference_all_to_all(case):
    keys = KEY_CASES[case]
    ref_stacked, chunks = _lane_chunks(len(keys) + 3)
    want = _ref_shuffle(ref_stacked, keys)
    reset_exchange_trace()
    recv = shuffle_chunk(chunks, [[c.columns[i] for i in keys] if keys
                                  else single_shard_keys(c)
                                  for c in chunks])
    assert EXCHANGE_TRACE["calls"] == 1 and EXCHANGE_TRACE["bytes"] > 0
    assert len(recv) == LANES
    for d, out in enumerate(recv):
        assert out.capacity == LANES * CAP
        c = out.columns
        got = (c[0], c[1].data, c[1].null, c[2].data.data, c[2].data.lens,
               c[2].null, c[3], out.ops, out.valid)
        for k, (w, t) in enumerate(zip(want, got)):
            t = t.numpy()
            assert w[d].dtype == t.dtype and w[d].shape == t.shape, k
            assert np.array_equal(w[d].view(np.uint8), t.view(np.uint8)), \
                (case, d, k)
    # nothing lost, nothing invented
    sent = sum(int(c.valid.sum()) for c in chunks)
    assert sum(int(o.valid.sum()) for o in recv) == sent
    if not keys:
        assert sum(int(o.valid.sum()) > 0 for o in recv) == 1
