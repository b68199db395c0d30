"""Port parity: the state handover of the scale plane (K26's and K27's
plain versions).

One job holds every sliceable state kind: a dense hash join (``[size, B]``
buckets, per-key counts) and a fragment with the reference's
``_agg_pair`` aggregation (``tests/test_scale.py:145``: count, sum and max
over a 2^8 table) and a materialize.  Both packages' aggregations and
materializes take the same chunks (a donor; the join's sides are the
port's, carried into the reference's types), then against the
reference's:

- ``slice_job_states``: dict for dict, leaf for leaf;
- ``clear_job_vnodes`` on a recipient that holds stale entries in the
  moved vnodes: every state tensor and the cleared count;
- ``transplant_job``: every state tensor and the moved count;
- the refusals, word for word: a DISTINCT aggregation, rows in a spill
  ring, a pool join side, a transplant that overflows its table.

Tolerance: none.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from risingwave_tpu.cluster.scale import handover as jh
from risingwave_tpu.cluster.scale.vnode import vnodes_of_ints
from risingwave_tpu.common.chunk import Chunk as JChunk
from risingwave_tpu.common.types import DataType as JType
from risingwave_tpu.common.types import Field as JField
from risingwave_tpu.common.types import Schema as JSchema
from risingwave_tpu.expr.agg import AggCall as JAggCall
from risingwave_tpu.expr.node import InputRef as JRef
from risingwave_tpu.stream import dag as jdag
from risingwave_tpu.stream.fragment import Fragment as JFragment
from risingwave_tpu.stream.hash_agg import HashAggExecutor as JAgg
from risingwave_tpu.stream.hash_join import HashJoinExecutor as JJoin
from risingwave_tpu.state.hash_table import HashTable as JHashTable
from risingwave_tpu.stream.hash_agg import AggState as JAggState
from risingwave_tpu.stream.hash_join import JoinState as JJoinState
from risingwave_tpu.stream.hash_join import SideState as JSideState
from risingwave_tpu.stream.materialize import MaterializeExecutor as JMv
from risingwave_tpu_torch.cluster.scale import handover as th
from risingwave_tpu_torch.common.chunk import Chunk
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.common.tree import tree_map
from risingwave_tpu_torch.compat import state_mismatches
from risingwave_tpu_torch.expr.agg import AggCall
from risingwave_tpu_torch.expr.node import InputRef
from risingwave_tpu_torch.stream import dag as tdag
from risingwave_tpu_torch.stream.fragment import Fragment
from risingwave_tpu_torch.stream.hash_agg import HashAggExecutor
from risingwave_tpu_torch.stream.hash_join import HashJoinExecutor
from risingwave_tpu_torch.stream.materialize import MaterializeExecutor

_REF_TYPES = {"AggState": JAggState, "JoinState": JJoinState,
              "SideState": JSideState}
N = 24  # not a power of two: the vnode is an unsigned 64-bit modulo
CAP = 64
COLS = (("k", "INT64"), ("v", "INT64"))


def _schemas():
    return (JSchema(tuple(JField(n, getattr(JType, t), nullable=False)
                          for n, t in COLS)),
            Schema(tuple(Field(n, getattr(DataType, t), nullable=False)
                         for n, t in COLS)))


def _executors(storage="dense", distinct=False, agg_size=1 << 8):
    """(reference, port) executors: join, agg, mv."""
    js, ts = _schemas()
    calls = [("count", None, False), ("sum", 1, distinct), ("max", 1, False)]
    jagg = JAgg(js, [("k", JRef(0))],
                [JAggCall(k, None if a is None else JRef(a), distinct=d)
                 for k, a, d in calls],
                table_size=agg_size, emit_capacity=256)
    tagg = HashAggExecutor(ts, [("k", InputRef(0))],
                           [AggCall(k, None if a is None else InputRef(a),
                                    distinct=d) for k, a, d in calls],
                           table_size=agg_size, emit_capacity=256)
    kw = dict(table_size=1 << 8, bucket_cap=4, out_capacity=256,
              left_storage=storage, right_storage=storage)
    jjoin = JJoin(js, js, [JRef(0)], [JRef(0)], **kw)
    tjoin = HashJoinExecutor(ts, ts, [InputRef(0)], [InputRef(0)], **kw)
    jmv = JMv(js, pk_indices=[0], table_size=1 << 8)
    tmv = MaterializeExecutor(ts, pk_indices=[0], table_size=1 << 8)
    return (jjoin, jagg, jmv), (tjoin, tagg, tmv)


class _Reader:
    """A source placeholder: the jobs here are never run."""


def _jobs(jx, tx):
    jjob = jdag.DagJob(
        {"a": _Reader(), "b": _Reader()},
        [jdag.JoinNode(jx[0], ("source", "a"), ("source", "b")),
         jdag.FragNode(JFragment([jx[1], jx[2]]), ("node", 0))])
    tjob = tdag.DagJob(
        {"a": _Reader(), "b": _Reader()},
        [tdag.JoinNode(tx[0], ("source", "a"), ("source", "b")),
         tdag.FragNode(Fragment([tx[1], tx[2]]), ("node", 0))],
        device="cpu")
    return jjob, tjob


def _to_ref(tree):
    """A port state tree as the reference's types with jnp leaves (the
    field lists are the same)."""
    if isinstance(tree, torch.Tensor):
        return jnp.asarray(tree.numpy().copy())  # no alias of the port's
    name = type(tree).__name__
    if name == "HashTable":
        return JHashTable(tuple(_to_ref(c) for c in tree.key_cols),
                          _to_ref(tree.occupied), _to_ref(tree.tombstone),
                          tree.size)
    if hasattr(tree, "_fields"):
        return _REF_TYPES[name](*(_to_ref(v) for v in tree))
    if isinstance(tree, tuple):
        return tuple(_to_ref(v) for v in tree)
    return tree


def _jitted(jx):
    """The reference's agg apply and flush and mv apply, each under
    ``jax.jit`` as its fragment runs them: one compile each, where an
    eager call compiles every primitive on its own."""
    return jax.jit(jx[1].apply), jax.jit(jx[1].flush), jax.jit(jx[2].apply)


def _feed(jfns, tx, jst, tst, rounds):
    """The same chunks into both packages' states: ``rounds`` of (keys,
    values) into the agg (applied and flushed) and the mv of each (the
    reference's through ``jfns``, from ``_jitted``), and into the port
    join's left and right sides, whose state the reference then takes as
    is: the reference's dense join compiles for ~13 s, and
    ``tests/test_torch_join_dense.py`` holds the two joins' updates
    equal."""
    jagg_apply, jagg_flush, jmv_apply = jfns
    js, ts = _schemas()
    jst, tst = list(jst), list(tst)
    jfr, tfr = list(jst[1]), list(tst[1])
    for keys, vals in rounds:
        # one chunk shape (64 rows, the tail invalid): one compile each
        n = len(keys)
        k = np.zeros(CAP, np.int64)
        v = np.zeros(CAP, np.int64)
        k[:n], v[:n] = keys, vals
        ops = np.zeros(CAP, np.int8)
        valid = np.arange(CAP) < n
        jc = JChunk((jnp.asarray(k), jnp.asarray(v)), jnp.asarray(ops),
                    jnp.asarray(valid), js)
        tc = Chunk((torch.from_numpy(k), torch.from_numpy(v)),
                   torch.from_numpy(ops), torch.from_numpy(valid), ts)
        for side in ("left", "right"):
            tst[0], _ = tx[0].apply_begin(tst[0], tc, side)
        jfr[0], _ = jagg_apply(jfr[0], jc)
        jfr[0], _ = jagg_flush(jfr[0], jnp.int64(1))
        tfr[0], _ = tx[1].apply(tfr[0], tc)
        tfr[0], _ = tx[1].flush(tfr[0], torch.tensor(1))
        jfr[1], _ = jmv_apply(jfr[1], jc)
        tfr[1], _ = tx[2].apply(tfr[1], tc)
    jst[1], tst[1] = tuple(jfr), tuple(tfr)
    jst[0] = _to_ref(tst[0])
    return tuple(jst), tuple(tst)


def _same(a, b, where=""):
    """A reference slice (numpy leaves) equals a port slice (torch
    leaves): the same structure, every leaf equal in shape, dtype and
    value."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), where
        for k in a:
            _same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, (int, str)):
        assert a == b, where
    else:
        x, y = np.asarray(a), b.numpy()
        assert x.shape == y.shape and x.dtype == y.dtype, \
            (where, x.shape, x.dtype, y.shape, y.dtype)
        assert np.array_equal(x, y), where


def _moved_set():
    keys = np.arange(60, dtype=np.int64)
    vn = np.asarray(vnodes_of_ints(keys, N))
    vns = sorted(set(int(x) for x in vn))
    return vns[: len(vns) // 2], keys, vn


@pytest.fixture(scope="module")
def handover():
    """Donor and recipient trees of both packages, and each step's
    results."""
    jx, tx = _executors()
    jjob, tjob = _jobs(jx, tx)
    moved, keys, vn = _moved_set()
    donor_rounds = [(list(range(50)), [10 * k for k in range(50)]),
                    (list(range(25)) + list(range(50, 55)), [3] * 30)]
    jfns = _jitted(jx)
    jd, td = _feed(jfns, tx, jjob.states, tjob.states, donor_rounds)
    # the recipient holds stale entries for some moved keys (and keys
    # it keeps)
    stale = [int(k) for k, v in zip(keys, vn) if int(v) in moved][:3]
    jr, tr = _feed(jfns, tx, jjob._init_states(), tjob._init_states(),
                   [(stale + [56, 57], [999999] * 5)])
    out = {"moved": moved, "jx": jx, "tx": tx, "jjob": jjob, "tjob": tjob,
           "jd": jax.device_get(jd), "td": td}
    out["jslice"] = jh.slice_job_states(jjob, out["jd"], moved, N)
    out["tslice"] = th.slice_job_states(tjob, td, moved, N)
    out["jclear"] = jh.clear_job_vnodes(jjob, jr, moved, N)
    tst, tn = th.clear_job_vnodes(tjob, tr, moved, N)
    # the port clears and transplants in place: keep a copy of each step
    out["tclear"] = (tree_map(torch.clone, tst), tn)
    out["jplant"] = jh.transplant_job(jjob, out["jclear"][0],
                                      out["jslice"])
    out["tplant"] = th.transplant_job(tjob, tst, out["tslice"])
    return out


def test_donor_states_equal(handover):
    assert state_mismatches(handover["jd"], handover["td"]) == []


def test_slice_job_states_matches_reference(handover):
    js, ts = handover["jslice"], handover["tslice"]
    assert set(js) == set(ts) == {(0,), (1, 0), (1, 1)}
    _same(js, ts)
    assert js[(0,)]["left"]["n"] > 0 and js[(1, 0)]["n"] > 0
    assert js[(1, 1)]["n"] == js[(1, 0)]["n"]


def test_clear_job_vnodes_matches_reference(handover):
    (jst, jn), (tst, tn) = handover["jclear"], handover["tclear"]
    # at least 3 stale keys, each an agg group, an mv row and an entry on
    # both join sides
    assert tn == jn >= 12
    assert state_mismatches(jax.device_get(jst), tst) == []


def test_transplant_job_matches_reference(handover):
    (jst, jn), (tst, tn) = handover["jplant"], handover["tplant"]
    assert tn == jn == sum(sl["n"] for sl in handover["jslice"].values())
    assert state_mismatches(jax.device_get(jst), tst) == []


def _words(fn_j, fn_t, exc=RuntimeError):
    with pytest.raises(exc) as ej:
        fn_j()
    with pytest.raises(exc) as et:
        fn_t()
    assert str(et.value) == str(ej.value)
    return str(et.value)


def test_refusals_match_reference(handover):
    moved = handover["moved"]
    # DISTINCT: dedup tables (in the state from the start) do not slice
    jx, tx = _executors(distinct=True)
    jjob, tjob = _jobs(jx, tx)
    assert "DISTINCT" in _words(
        lambda: jh.slice_job_states(jjob, jax.device_get(jjob.states),
                                    moved, N),
        lambda: th.slice_job_states(tjob, tjob.states, moved, N))
    # rows in the spill ring
    jjob, tjob = handover["jjob"], handover["tjob"]
    jd, td = handover["jd"], handover["td"]
    jd2 = (jd[0], (jd[1][0]._replace(spill_count=np.int32(3)), jd[1][1]))
    td2 = (td[0], (td[1][0]._replace(
        spill_count=torch.tensor(3, dtype=torch.int32)), td[1][1]))
    assert "drain first" in _words(
        lambda: jh.slice_job_states(jjob, jd2, moved, N),
        lambda: th.slice_job_states(tjob, td2, moved, N))
    # a pool join side
    jx, tx = _executors(storage="pool")
    jjob, tjob = _jobs(jx, tx)
    assert "pool-storage" in _words(
        lambda: jh.slice_job_states(jjob, jax.device_get(jjob.states),
                                    moved, N),
        lambda: th.slice_job_states(tjob, tjob.states, moved, N))
    assert "pool-storage" in _words(
        lambda: jh.clear_job_vnodes(jjob, jjob.states, moved, N),
        lambda: th.clear_job_vnodes(tjob, tjob.states, moved, N))
    # a recipient table too small for the moved entries
    jx, tx = _executors(agg_size=1 << 4)
    jjob, tjob = _jobs(jx, tx)
    big = list(range(24))
    sl_j = {(1, 0): jh.slice_partition_states(
        [handover["jx"][1]], (handover["jd"][1][0],), big, N)[0]}
    sl_t = {(1, 0): th.slice_partition_states(
        [handover["tx"][1]], (handover["td"][1][0],), big, N)[0]}
    assert sl_t[(1, 0)]["n"] > 16
    assert "overflowed" in _words(
        lambda: jh.transplant_job(jjob, jjob.states, sl_j),
        lambda: th.transplant_job(tjob, tjob.states, sl_t))
