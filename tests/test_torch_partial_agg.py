"""Port parity: the two-phase aggregation's partial phase
(``stream/partial_agg.py``, K22c's plain version).

The same numpy-seeded chunks go through the reference's and the port's
``PartialAggExecutor.apply``: ops of all four kinds (retractions), random
invalid rows, nullable arguments, int64 / int32 / float64 / VARCHAR keys
(strings with random bytes past their lengths, NULL keys, NaN and -0.0
keys) and every ``TWO_PHASE_KINDS`` kind over int64, int32 and float64
arguments.  Every output leaf of every row (sorted keys, partials, their
NULL planes, ops, valid) must be equal.  Tolerance: none for integers;
float64 sums within 1e-12 relative (the reference's XLA ``segment_sum``
and the port's serial sum may add a segment's rows in another order), min
and max of floats exact.  The two-phase plan through a global aggregation
is in ``tests/test_torch_sharded_sql.py``.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
from risingwave_tpu.expr.agg import AggCall as JAgg
from risingwave_tpu.expr.node import InputRef as JRef
from risingwave_tpu.stream.partial_agg import (
    TWO_PHASE_KINDS as J_KINDS,
    PartialAggExecutor as JPartial,
)
from risingwave_tpu_torch.common.chunk import Chunk, NCol, StrCol
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.expr.agg import AggCall
from risingwave_tpu_torch.expr.node import InputRef
from risingwave_tpu_torch.stream.partial_agg import (
    TWO_PHASE_KINDS,
    PartialAggExecutor,
)

CAP = 256
W = 8
#: (name, type, nullable): g int64, h int32, s VARCHAR(8), v int64 NULL,
#: i int32 NULL, f float64 NULL, k float64
COLS = (("g", "INT64", False), ("h", "INT32", False),
        ("s", "VARCHAR", True), ("v", "INT64", True), ("i", "INT32", True),
        ("f", "FLOAT64", True), ("k", "FLOAT64", False))


def _schemas():
    js = JSchema(tuple(JField(n, getattr(JDT, t), nullable=nl,
                              **({"str_width": W} if t == "VARCHAR" else {}))
                       for n, t, nl in COLS))
    ts = Schema(tuple(Field(n, getattr(DataType, t), nullable=nl,
                            **({"str_width": W} if t == "VARCHAR" else {}))
                      for n, t, nl in COLS))
    return js, ts


def _chunk(seed: int, n_keys: int = 6):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, n_keys, CAP).astype(np.int64)
    h = (g * 7 - 3).astype(np.int32)
    sb = rng.integers(0, 256, (CAP, W)).astype(np.uint8)
    sl = rng.integers(0, 3, CAP).astype(np.int32)
    # few distinct strings: bytes past the length vary only for length 0
    sb[:, :2] = (g[:, None] % 3 + 65).astype(np.uint8)
    sb[:, 2:] = 0
    s_null = rng.random(CAP) < 0.2
    v = rng.integers(-1000, 1000, CAP).astype(np.int64)
    v_null = rng.random(CAP) < 0.3
    i = rng.integers(-50, 50, CAP).astype(np.int32)
    i_null = rng.random(CAP) < 0.5
    f = rng.standard_normal(CAP) * 100
    f_null = rng.random(CAP) < 0.3
    k = np.array([0.5, -0.0, 0.0, np.nan, 2.0])[g % 5]
    ops = rng.integers(0, 4, CAP).astype(np.int8)
    valid = rng.random(CAP) < 0.85
    js, ts = _schemas()
    j = JChunk((jnp.asarray(g), jnp.asarray(h),
                JNCol(JStrCol(jnp.asarray(sb), jnp.asarray(sl)),
                      jnp.asarray(s_null)),
                JNCol(jnp.asarray(v), jnp.asarray(v_null)),
                JNCol(jnp.asarray(i), jnp.asarray(i_null)),
                JNCol(jnp.asarray(f), jnp.asarray(f_null)),
                jnp.asarray(k)), jnp.asarray(ops), jnp.asarray(valid), js)
    t = Chunk((torch.from_numpy(g), torch.from_numpy(h),
               NCol(StrCol(torch.from_numpy(sb), torch.from_numpy(sl)),
                    torch.from_numpy(s_null)),
               NCol(torch.from_numpy(v), torch.from_numpy(v_null)),
               NCol(torch.from_numpy(i), torch.from_numpy(i_null)),
               NCol(torch.from_numpy(f), torch.from_numpy(f_null)),
               torch.from_numpy(k)), torch.from_numpy(ops),
              torch.from_numpy(valid), ts)
    return j, t


#: every two-phase kind over every argument type
AGGS = (("count_star", None), ("count", 3), ("count", 5), ("sum", 3),
        ("sum", 4), ("sum", 5), ("sum0", 3), ("min", 3), ("max", 3),
        ("min", 4), ("max", 4), ("min", 5), ("max", 5), ("sum", 0),
        ("max", 1))
KEYS = {"int64": (0,), "int32+string": (1, 2), "string": (2,),
        "float64": (6,), "nullable int64": (3,)}


def _leaves(col):
    name = type(col).__name__
    if name == "NCol":
        return _leaves(col.data) + [np.asarray(col.null)]
    if name == "StrCol":
        return [np.asarray(col.data), np.asarray(col.lens)]
    return [np.asarray(col)]


def _executors(keys):
    js, ts = _schemas()
    jex = JPartial(js, [(COLS[i][0], JRef(i)) for i in keys],
                   [JAgg(k, None if a is None else JRef(a), f"a{n}")
                    for n, (k, a) in enumerate(AGGS)])
    tex = PartialAggExecutor(ts, [(COLS[i][0], InputRef(i)) for i in keys],
                             [AggCall(k, None if a is None else InputRef(a),
                                      f"a{n}")
                              for n, (k, a) in enumerate(AGGS)])
    return jex, tex


def test_two_phase_kinds_match():
    assert TWO_PHASE_KINDS == J_KINDS


@pytest.mark.parametrize("keys", list(KEYS), ids=list(KEYS))
def test_partial_agg_apply_matches_reference(keys):
    jex, tex = _executors(KEYS[keys])
    assert [(f.name, f.data_type.value, f.nullable)
            for f in tex.out_schema] == [
        (f.name, f.data_type.value, f.nullable) for f in jex.out_schema]
    n_keys = len(KEYS[keys])
    for seed in range(3):
        jc, tc = _chunk(seed)
        _, jo = jex.apply(jex.init_state(), jc)
        _, to = tex.apply(tex.init_state("cpu"), tc)
        assert np.array_equal(np.asarray(jo.valid), to.valid.numpy())
        assert np.array_equal(np.asarray(jo.ops), to.ops.numpy())
        for ci, (jcol, tcol) in enumerate(zip(jo.columns, to.columns)):
            for jl, tl in zip(_leaves(jcol), _leaves(tcol)):
                assert jl.dtype == tl.dtype and jl.shape == tl.shape, ci
                kind, arg = AGGS[ci - n_keys] if ci >= n_keys else (None, 0)
                if kind == "sum" and tl.dtype == np.float64:
                    assert np.allclose(jl, tl, rtol=1e-12, atol=1e-9,
                                       equal_nan=True), ci
                else:
                    assert np.array_equal(jl.view(np.uint8),
                                          tl.view(np.uint8)), (keys, ci)
        # the leaders are the distinct keys of the valid rows
        assert int(to.valid.sum()) > 0


def test_partial_agg_all_invalid_and_one_key():
    """A chunk with no valid row emits nothing; one key in every valid row
    collapses into one partial row (q7's shape)."""
    jex, tex = _executors(KEYS["int64"])
    jc, tc = _chunk(7, n_keys=1)
    _, jo = jex.apply(jex.init_state(), jc)
    _, to = tex.apply(tex.init_state("cpu"), tc)
    assert int(to.valid.sum()) == 1 == int(np.asarray(jo.valid).sum())
    for jcol, tcol in zip(jo.columns, to.columns):
        for jl, tl in zip(_leaves(jcol), _leaves(tcol)):
            assert np.allclose(jl, tl, rtol=1e-12, equal_nan=True)
    dead = tc.with_valid(torch.zeros(CAP, dtype=torch.bool))
    _, to = tex.apply(tex.init_state("cpu"), dead)
    assert not bool(to.valid.any())
