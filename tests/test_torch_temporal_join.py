"""Port parity: the temporal join (``TemporalJoinExecutor``, kernel K22a's
plain version over the build side's K3/K8 plain versions).

The same seeded chunks go through the reference's and the port's
executor: a random build changelog on the right (inserts of new keys,
``U-``/``U+`` updates, deletes, so the table holds tombstones) and probe
chunks on the left whose keys are live, deleted, never inserted or NULL,
padded with invalid rows.  Keys are one int64 column, one VARCHAR(8)
column (as in ``tests/slt/temporal_join.slt``) or two columns (int32,
float64); build values are int64, a nullable VARCHAR(8) and int32.  Each
runs as an inner and a left outer join; a 16-slot table filled to the
last slot drives the probe bound (the overflow count).  After every step
the output chunk (every column leaf, ops, valid) and every state leaf
must be equal; halfway the reference's state is carried into the port
(``compat.state_from_numpy``) and both go on.  The reference side of a
key case runs once (``_reference``) for both join types.  Tolerance: none (integer
and byte leaves; the float64 keys are compared by IEEE equality on both
sides).
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import functools

import jax
import numpy as np
import pytest

from risingwave_tpu.common.chunk import Chunk as JChunk
from risingwave_tpu.common.types import (
    DataType as JDT,
    Field as JField,
    Schema as JSchema,
)
from risingwave_tpu.expr.node import InputRef as JInputRef
from risingwave_tpu.stream.temporal_join import (
    TemporalJoinExecutor as JTemporal,
)
from risingwave_tpu_torch.common.chunk import Chunk
from risingwave_tpu_torch.common.tree import flatten
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.compat import state_from_numpy, state_mismatches
from risingwave_tpu_torch.expr.node import InputRef
from risingwave_tpu_torch.stream.temporal_join import (
    TemporalJoinExecutor,
    TjState,
    temporal_probe_plain,
)

CAP = 32
OPS = {"+": 0, "-": 1, "U-": 2, "U+": 3}
#: key column types per case (name, type, str_width)
KEYS = {
    "int64": [("k", "INT64")],
    "varchar": [("k", "VARCHAR")],
    "two_col": [("k", "INT32"), ("k2", "FLOAT64")],
}
VALUES = [("v", "INT64", False), ("s", "VARCHAR", True), ("w", "INT32", False)]


def _field(cls_f, cls_t, name, t, nullable=False):
    kw = {"str_width": 8} if t == "VARCHAR" else {}
    return cls_f(name, getattr(cls_t, t), nullable=nullable, **kw)


def _schemas(case: str):
    keys = KEYS[case]
    left = [("id", "INT64", False)] + [(n, t, True) for n, t in keys]
    right = [(n, t, False) for n, t in keys] + VALUES
    out = []
    for cols in (left, right):
        out.append((JSchema(tuple(_field(JField, JDT, *c) for c in cols)),
                    Schema(tuple(_field(Field, DataType, *c) for c in cols))))
    return out


def _key_value(case: str, i: int):
    if case == "int64":
        return (i * 7 - 50,)
    if case == "varchar":
        return (f"c{i:03d}"[: 8 - (i % 3)],)
    return (i % 11 - 5, float(i // 11) + 0.5)


def _np_cols(case: str, rows, schema_cols):
    out = []
    for j, (_, t, _) in enumerate(schema_cols):
        vals = [r[j] for r in rows]
        if t == "VARCHAR" or any(v is None for v in vals):
            out.append(np.array(vals, object))
        else:
            out.append(np.array(vals, {"INT64": np.int64, "INT32": np.int32,
                                       "FLOAT64": np.float64}[t]))
    return out


def _script(rng, case: str, n_keys: int, full: bool):
    """(side, rows, ops) steps: build changelogs and probe chunks."""
    keys = KEYS[case]
    live: dict = {}
    dead: list = []
    steps = []
    next_key = [0]

    def value_row(key):
        s = None if rng.random() < 0.3 else f"s{int(rng.integers(0, 99))}"
        return key + (int(rng.integers(-1000, 1000)), s,
                      int(rng.integers(0, 50)))

    def build(n_ins, n_upd, n_del):
        rows, ops = [], []
        for _ in range(n_ins):
            if next_key[0] >= n_keys:
                break
            key = _key_value(case, next_key[0])
            next_key[0] += 1
            r = value_row(key)
            live[key] = r
            rows.append(r)
            ops.append("+")
        for key in list(rng.permutation(len(live)))[:n_upd]:
            key = list(live)[key]
            new = value_row(key)
            rows += [live[key], new]
            ops += ["U-", "U+"]
            live[key] = new
        for _ in range(min(n_del, len(live))):
            key = list(live)[int(rng.integers(0, len(live)))]
            rows.append(live.pop(key))
            ops.append("-")
            dead.append(key)
        steps.append(("right", rows, ops))

    def probe(n):
        rows = []
        for i in range(n):
            u = rng.random()
            if u < 0.4 and live:
                key = list(live)[int(rng.integers(0, len(live)))]
            elif u < 0.55 and dead:
                key = dead[int(rng.integers(0, len(dead)))]
            elif u < 0.85:
                key = _key_value(case, n_keys + int(rng.integers(0, 40)))
            else:
                key = tuple(None for _ in keys)
            rows.append((int(rng.integers(0, 1 << 40)),) + key)
        steps.append(("left", rows, ["+"] * n))

    if full:
        build(n_keys, 0, 0)
        for _ in range(2):
            probe(CAP - 4)
        return steps
    build(12, 0, 0)
    probe(CAP - 6)
    build(10, 6, 6)
    probe(CAP)
    return steps


def _same_out(jout, tout):
    valid, ops, leaves = jout
    np.testing.assert_array_equal(valid, tout.valid.numpy())
    np.testing.assert_array_equal(ops, tout.ops.numpy())
    tl = flatten(tuple(tout.columns))[0]
    assert len(leaves) == len(tl)
    for a, b in zip(leaves, tl):
        np.testing.assert_array_equal(a, b.numpy())


CASES = [(c, j, False) for c in KEYS for j in ("inner", "left_outer")] + [
    ("int64", "inner", True), ("varchar", "left_outer", True)]


def _key_args(case: str):
    n_key = len(KEYS[case])
    return list(range(n_key)), [1 + i for i in range(n_key)]


@functools.lru_cache(maxsize=None)
def _reference(case: str, full: bool):
    """The JAX side of one key case, run once for every join type
    ``CASES`` takes it with: the build chunks go through one executor
    (the right side does not depend on the join type), each probe chunk
    through every join type's executor from the same state, which the
    probe advances alike.  ``apply`` runs under ``jax.jit`` (``side``
    static), as the reference's own DAG traces it.  Returns the steps
    and, per step, the host state and each join type's output as numpy
    ``(valid, ops, leaves)``; then the state after ``maybe_rehash``."""
    (jl, _), (jr, _) = _schemas(case)
    pk, refs = _key_args(case)
    size = 16 if full else 64
    types = tuple(j for c, j, f in CASES if (c, f) == (case, full))
    execs = {t: JTemporal(jl, jr, [JInputRef(r) for r in refs], pk,
                          table_size=size, join_type=t) for t in types}
    apply = {t: jax.jit(e.apply, static_argnums=2) for t, e in execs.items()}
    first = types[0]
    left_cols = [("id", "INT64", False)] + [(n, ty, True)
                                            for n, ty in KEYS[case]]
    right_cols = [(n, ty, False) for n, ty in KEYS[case]] + VALUES
    steps = _script(np.random.default_rng(22), case,
                    size if full else 40, full)
    st = execs[first].init_state()
    record = []
    for side, rows, ops in steps:
        cols = left_cols if side == "left" else right_cols
        jc = JChunk.from_numpy(jl if side == "left" else jr,
                               _np_cols(case, rows, cols),
                               ops=np.array([OPS[o] for o in ops], np.int8),
                               capacity=CAP)
        outs = {}
        if side == "right":
            st, out = apply[first](st, jc, side)
            assert out is None
        else:
            new = None
            for t in types:
                new, out = apply[t](st, jc, side)
                outs[t] = (np.asarray(out.valid), np.asarray(out.ops),
                           [np.asarray(x) for x in
                            jax.tree_util.tree_leaves(tuple(out.columns))])
            st = new
        record.append((side, rows, ops, jax.device_get(st), outs))
    rehashed = jax.device_get(execs[first].maybe_rehash(st))
    return record, rehashed


@pytest.mark.parametrize("case,join_type,full", CASES)
def test_temporal_join_matches_reference(case, join_type, full):
    (jl, tl), (jr, tr) = _schemas(case)
    pk, refs = _key_args(case)
    size = 16 if full else 64
    j = JTemporal(jl, jr, [JInputRef(r) for r in refs], pk,
                  table_size=size, join_type=join_type)
    t = TemporalJoinExecutor(tl, tr, [InputRef(r) for r in refs], pk,
                             table_size=size, join_type=join_type)
    assert t.out_schema == Schema(tuple(
        Field(f.name, DataType[f.data_type.name], nullable=f.nullable,
              str_width=f.str_width) for f in j.out_schema))
    tst = t.init_state("cpu")
    left_cols = [("id", "INT64", False)] + [(n, ty, True)
                                            for n, ty in KEYS[case]]
    right_cols = [(n, ty, False) for n, ty in KEYS[case]] + VALUES
    record, rehashed = _reference(case, full)
    found = 0
    for i, (side, rows, ops, host, jouts) in enumerate(record):
        cols = left_cols if side == "left" else right_cols
        tc = Chunk.from_numpy(tl if side == "left" else tr,
                              _np_cols(case, rows, cols),
                              ops=np.array([OPS[o] for o in ops], np.int8),
                              capacity=CAP)
        tst, tout = t.apply(tst, tc, side)
        assert isinstance(tst, TjState)
        if side == "right":
            assert tout is None
        else:
            _same_out(jouts[join_type], tout)
            found += int(jouts[join_type][0].sum())
        assert state_mismatches(host, tst) == []
        if i == len(record) // 2:
            tst = state_from_numpy(host)
    over = int(tst.overflow)
    if full:
        # every probe of an absent key walks the whole table
        assert over > 0 and int(tst.right.table.occupied.sum()) == size
    else:
        assert over == 0 and found > 0
        assert int(tst.right.table.tombstone.sum()) > 0
    tst = t.maybe_rehash(tst)
    assert state_mismatches(rehashed, tst) == []


def test_probe_plain_counts_overflow_in_place():
    """The plain version adds the overflow to the counter it is given
    (the kernel's atomics do the same on the card) and reads a missed
    row's values from the last slot, as the reference's gather does."""
    (_, tl), (_, tr) = _schemas("int64")
    t = TemporalJoinExecutor(tl, tr, [InputRef(1)], [0], table_size=4)
    st = t.init_state("cpu")
    rows = [(k, 10 * k, "x", 1) for k in range(4)]
    c = Chunk.from_numpy(tr, _np_cols("int64", rows, [(n, ty, False) for n, ty
                                                      in KEYS["int64"]]
                                      + VALUES), capacity=8)
    st, _ = t.apply(st, c, "right")
    import torch

    counter = torch.zeros((), dtype=torch.int64)
    keys = [torch.tensor([0, 2, 99, 100], dtype=torch.int64)]
    cols, valid = temporal_probe_plain(
        st.right.table, st.right.values, keys, [None],
        torch.tensor([True, True, True, False]), counter, left_outer=True)
    assert int(counter) == 1  # 99 walks the full table; 100 is invalid
    assert valid.tolist() == [True, True, True, False]
    v = cols[1]
    assert v.null.tolist() == [False, False, True, True]
    last = int(st.right.values[1][3])
    assert v.data.tolist()[:2] == [0, 20] and v.data.tolist()[2:] == [last] * 2
