"""Port parity on the corner cases of the materialized ring's append
(K8-ring) and of the top-N pool's apply (K16).

K8-ring's kernel runs a grid of row tiles that take their bases by
decoupled look-back and copy each plane in words; K16's runs a cooperative
grid that compacts the free slots and ranks the inserts across blocks, and
ranks the contested inserts and the candidate slots over lists of their
own.  These cases are the ones such a redesign could get wrong.  Each is
built from a numpy seed (``chip_smoke.k8_ring_cases``,
``chip_smoke.k16_cases``, which the card runs too) and goes through the
reference and the port's plain version, which ``chip_smoke.py`` holds the
kernels against on the card:

- K8-ring: ``AppendOnlyMaterialize.apply`` against ``ring_append_plain``:
  every leaf of the ring (null planes included), the cursor and the lap
  count, after every chunk;
- K16: ``pool_apply`` against ``pool_apply_plain``: the pool's rows,
  ``valid`` and ``row_hash``, the overflow and the missing deletes, after
  every chunk of the script.

Tolerance: none (the copies are bytes, the ranks integers).
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import sys
from pathlib import Path

import jax
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
from risingwave_tpu.stream import top_n as jtop_n
from risingwave_tpu.stream.materialize import (
    AppendOnlyMaterialize as JRing,
    RingState as JRingState,
)
from risingwave_tpu_torch.common.tree import flatten, tree_map
from risingwave_tpu_torch.stream import top_n as ttop_n
from risingwave_tpu_torch.stream.materialize import ring_append_plain

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke  # noqa: E402  (the cases, shared with the card's phases)

# ---------------------------------------------------------------------------
# K8-ring: AppendOnlyMaterialize.apply


def _j_col(col):
    if isinstance(col, tuple) and isinstance(col[0], str):
        return JNCol(_j_col(col[1]), jnp.asarray(col[2]))
    if isinstance(col, tuple):
        return JStrCol(jnp.asarray(col[0]), jnp.asarray(col[1]))
    return jnp.asarray(col)


def _j_schema(fields):
    return JSchema(tuple(JField(n, getattr(JDT, k), str_width=w or 16,
                                nullable=nl) for n, k, w, nl in fields))


def _bits(a: np.ndarray) -> np.ndarray:
    """Floats as their bit patterns: the copy moves bytes."""
    if a.dtype.kind == "f":
        return a.view(np.int64 if a.itemsize == 8 else np.int32)
    return a


K8_CASES = {c["name"]: c for c in chip_smoke.k8_ring_cases()}


@pytest.mark.parametrize("name", sorted(K8_CASES))
def test_ring_case(name):
    case = K8_CASES[name]
    ring = case["ring"]
    jschema = _j_schema(case["fields"])
    jex = JRing(jschema, ring_size=ring)
    apply = jax.jit(jex.apply)
    jst = JRingState(tuple(_j_col(c) for c in case["init"]),
                     jnp.asarray(case["cursor"], jnp.int64),
                     jnp.asarray(case["overflow"], jnp.int64))
    values, cursor, overflow, chunks = chip_smoke.k8_torch_case(
        torch, case, torch.device("cpu"))
    n_visible = 0
    for k, ((cols, valid), tc) in enumerate(zip(case["chunks"], chunks)):
        cap = valid.shape[0]
        jc = JChunk(tuple(_j_col(c) for c in cols),
                    jnp.zeros(cap, jnp.int8), jnp.asarray(valid), jschema)
        jst, _ = apply(jst, jc)
        ring_append_plain(values, cursor, overflow, tc, ring)
        jleaves = jax.tree_util.tree_leaves(jax.device_get(jst.values))
        tleaves = flatten(values)[0]
        assert len(jleaves) == len(tleaves)
        for i, (a, b) in enumerate(zip(jleaves, tleaves)):
            np.testing.assert_array_equal(
                _bits(np.asarray(a)), _bits(b.numpy()),
                err_msg=f"{name} chunk {k} leaf {i}")
        assert int(jst.cursor) == int(cursor), (name, k)
        assert int(jst.overflow) == int(overflow), (name, k)
        n_visible += int(valid.sum())
    assert int(cursor) == case["cursor"] + n_visible
    if name == "lapped":
        assert int(overflow) > case["overflow"]


def test_ring_cases_cover_the_corners():
    """The cases hold what the kernel's design must get right: a wrap
    within a chunk, lost_before > 0, all-invalid and all-valid chunks,
    every word width of a string, null planes, int32, bool and float64
    leaves, and capacities off the 256-row tile."""
    cases = list(K8_CASES.values())
    wraps = [c for c in cases
             if c["cursor"] % c["ring"] + c["chunks"][0][1].sum() > c["ring"]]
    assert wraps
    assert any(c["cursor"] > c["ring"] for c in cases)
    valids = [v for c in cases for _, v in c["chunks"]]
    assert any(not v.any() for v in valids) and any(v.all() for v in valids)
    widths = {w for c in cases for _, k, w, _ in c["fields"]
              if k == "VARCHAR"}
    assert {3, 40, 64} <= widths
    assert any(nl for c in cases for *_, nl in c["fields"])
    kinds = {k for c in cases for _, k, _, _ in c["fields"]}
    assert {"INT32", "BOOLEAN", "FLOAT64"} <= kinds
    caps = {v.shape[0] for v in valids}
    assert any(cap % 256 and cap > 256 for cap in caps)


# ---------------------------------------------------------------------------
# K16: pool_apply


K16_CASES = {c["name"]: c for c in chip_smoke.k16_cases()}
_J_POOL_APPLY = jax.jit(jtop_n.pool_apply, static_argnums=4)


def _j_k16_schema():
    return JSchema(tuple(JField(n, getattr(JDT, t), str_width=w or 16)
                         for n, t, w in chip_smoke.K16_FIELDS))


def _j_pool(case):
    S = case["S"]
    rows = []
    for c in case["rows"]:
        if isinstance(c, tuple):
            rows.append(JStrCol(jnp.zeros((S, c[0].shape[1]), jnp.uint8),
                                jnp.zeros(S, jnp.int32)))
        else:
            rows.append(jnp.zeros(S, c.dtype))
    return tuple(rows), jnp.zeros(S, bool), jnp.zeros(S, jnp.uint64)


@pytest.mark.parametrize("name", sorted(K16_CASES))
def test_pool_case(name):
    case = K16_CASES[name]
    S = case["S"]
    jschema = _j_k16_schema()
    jrows, jvalid, jhash = _j_pool(case)
    pool, chunks = chip_smoke.k16_torch_case(torch, case,
                                             torch.device("cpu"))
    rows, valid, row_hash = pool[:3]
    totals = [0, 0]
    for k, ((idx, ops, v), tc) in enumerate(zip(case["chunks"], chunks)):
        cols = chip_smoke.k16_chunk_columns(case, idx)
        jc = JChunk(tuple(_j_col(c) for c in cols), jnp.asarray(ops),
                    jnp.asarray(v), jschema)
        jrows, jvalid, jhash, jo, jm = _J_POOL_APPLY(jrows, jvalid, jhash,
                                                     jc, S)
        rows, valid, row_hash, to, tm = ttop_n.pool_apply_plain(
            rows, valid, row_hash, tc, S)
        tag = f"{name} chunk {k}"
        for i, (a, b) in enumerate(zip(jax.tree_util.tree_leaves(jrows),
                                       flatten(rows)[0])):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=f"{tag} column leaf {i}")
        np.testing.assert_array_equal(np.asarray(jvalid), valid.numpy(),
                                      err_msg=f"{tag} valid")
        np.testing.assert_array_equal(np.asarray(jhash).view(np.int64),
                                      row_hash.numpy(),
                                      err_msg=f"{tag} row_hash")
        assert (int(jo), int(jm)) == (int(to), int(tm)), tag
        totals[0] += int(to)
        totals[1] += int(tm)
    # each case reaches the branch it was written for
    want = {"overflow": (True, False), "missing": (False, True),
            "reuse": (True, False), "wide": (True, False)}
    if name in want:
        assert (totals[0] > 0, totals[1] > 0) == want[name], totals


def test_pool_cases_reach_their_branches():
    """Scattered free slots before an append-only chunk, the annihilation
    of both kinds, duplicate pool rows cleared in slot order, a freed slot
    taken in the same call, and a chunk wider than 1024 rows and the free
    space, through the port's plain version alone."""
    cpu = torch.device("cpu")

    def run(name, upto=None):
        case = K16_CASES[name]
        pool, chunks = chip_smoke.k16_torch_case(torch, case, cpu)
        for c in chunks[:upto]:
            ttop_n.pool_apply(*pool[:3], c, case["S"], *pool[3:])
        return pool, case

    pool, case = run("scattered_free", 3)
    free = np.flatnonzero(~pool[1].numpy())
    assert free[0] < 128 and np.any(np.diff(free) > 1)
    pool, case = run("annihilation")
    held = pool[0][1].numpy()[pool[1].numpy()]
    b = case["rows"][1]
    assert b[40] not in held and b[50] not in held
    assert (held == b[41]).sum() == 2 and b[5] not in held
    pool, case = run("duplicates")
    b = case["rows"][1]
    copies = np.flatnonzero((pool[0][1].numpy() == b[7]) & pool[1].numpy())
    assert copies.size == 4 and 1 not in copies and 3 not in copies
    pool, case = run("reuse")
    b = case["rows"][1]
    assert pool[0][1][10] == b[70] and pool[0][1][20] == b[71]
    assert int(pool[3]) == 1
    pool, case = run("wide")
    assert K16_CASES["wide"]["cap"] > 1024
    assert int(pool[3]) > 0 and int(pool[1].sum()) == case["S"]
    pool, case = run("all_invalid")
    assert int(pool[1].sum()) == 16


def test_pool_wrapper_picks_the_plain_version_on_the_cpu():
    """``pool_apply`` on CPU tensors is the plain version, counters
    included."""
    case = K16_CASES["missing"]
    cpu = torch.device("cpu")
    a, chunks = chip_smoke.k16_torch_case(torch, case, cpu)
    b = tree_map(torch.clone, a)
    for c in chunks:
        ttop_n.pool_apply(*a[:3], c, case["S"], *a[3:])
        *_, n_over, n_miss = ttop_n.pool_apply_plain(*b[:3], c, case["S"])
        b[3].add_(n_over)
        b[4].add_(n_miss)
    for x, y in zip(flatten(a)[0], flatten(b)[0]):
        assert torch.equal(x, y)
    assert int(a[4]) == 12
