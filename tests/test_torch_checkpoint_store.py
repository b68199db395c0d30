"""Port parity: ``CheckpointStore`` against the reference's, and the
uploader's failure contract.

The reference's q7 engine (``bench.py``'s SQL, 1M events/s: one hot
window, so a barrier dirties few blocks; chunk 256, tables 2^10) runs
a barrier at a time; after each barrier its state,
fetched to the host, and the same state converted to the port's types
are saved under the same epoch number into both stores (in-memory
objects, blocks of 64 elements, ``full_interval`` 4, ``keep_epochs`` 2).
One epoch adds 1 to every integer table first, which must force a full
(more than half of the blocks dirty).  Both stores must keep the same
manifest epochs with the same full/delta kinds (the forced fulls at the
interval and at >50% dirty included), GC must keep each chain's base
full, every payload array must equal the reference's byte for byte with
leaves matched by path (``compat.leaf_paths``), every crc trailer must
be the crc32c of its stored bytes (the port's crc32c equals the
reference's), and ``load`` at every retained epoch
must give equal states.  A flipped byte must raise
``CheckpointCorruption``; a failing object store must make the port's
uploader loud, and ``recover()`` must rewind to the last durable epoch.
Tolerance: none.
"""

import torch_threads  # noqa: F401  (first: sets torch threads)
import io
import json

import jax
import numpy as np
import pytest

from bench import QUERIES, SOURCES
from risingwave_tpu.sql import Engine as JEngine
from risingwave_tpu.sql.planner import PlannerConfig as JConfig
from risingwave_tpu.storage.checkpoint_store import (
    CheckpointStore as JStore,
)
from risingwave_tpu.storage.hummock.object_store import (
    InMemObjectStore as JMem,
)
from risingwave_tpu_torch.common.tree import flatten
from risingwave_tpu_torch.compat import leaf_paths, state_from_numpy
from risingwave_tpu_torch.sql import Engine
from risingwave_tpu_torch.sql.planner import PlannerConfig
from risingwave_tpu_torch.storage.checkpoint_store import CheckpointStore
from risingwave_tpu_torch.storage.hummock.object_store import (
    InMemObjectStore,
    LocalFsObjectStore,
    StoreFaults,
)
from risingwave_tpu_torch.storage.integrity import (
    CheckpointCorruption,
    crc32c,
)

SIZES = dict(chunk_capacity=256, agg_table_size=1 << 10,
             agg_emit_capacity=128, mv_table_size=1 << 10)
STORE = dict(keep_epochs=2, full_interval=4, block_elems=64)


def _start(engine):
    engine.execute(SOURCES.format(rate="1000000"))
    engine.execute(QUERIES["q7"])
    return engine


def _npz(store, key):
    with np.load(io.BytesIO(store.store.get(key))) as z:
        return {k: np.array(z[k]) for k in z.files}


def _same_bytes(a, b) -> bool:
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def _assert_same_leaves(ref_tree, port_tree):
    rp, pp = leaf_paths(ref_tree), leaf_paths(port_tree)
    assert [p for p, _ in rp] == [p for p, _ in pp]
    for (path, r), (_, p) in zip(rp, pp):
        assert _same_bytes(np.asarray(r), p.numpy()), path


def test_store_matches_reference_epoch_by_epoch():
    jeng = _start(JEngine(JConfig(**SIZES)))
    jstore = JStore("ref", object_store=JMem(), **STORE)
    tstore = CheckpointStore("port", object_store=InMemObjectStore(),
                             **STORE)
    epochs = list(range(1, 12))
    saved = {}
    for e in epochs:
        jeng.tick(barriers=1, chunks_per_barrier=4)
        ref = jax.device_get(jeng.jobs[0].states)
        if e == 6:
            # rewrite every integer table: more than half dirty
            ref = jax.tree.map(
                lambda x: x + 1 if x.ndim and x.dtype != np.bool_ else x,
                ref)
        port = state_from_numpy(ref)
        src = {"offset": e}
        jstore.save("q7", e, ref, src)
        tstore.save("q7", e, port, src)
        saved[e] = ref
        jm = json.loads(jstore.store.get("MANIFEST.json"))["jobs"]["q7"]
        tm = json.loads(tstore.store.get("MANIFEST.json"))["jobs"]["q7"]
        assert tm["epochs"] == jm["epochs"]
        assert tm["kind"] == jm["kind"]
        assert tm["committed"] == jm["committed"] == e
        # payloads: the same objects, array for array
        rz, tz = _npz(jstore, f"q7/epoch_{e}.npz"), \
            _npz(tstore, f"q7/epoch_{e}.npz")
        assert sorted(rz) == sorted(tz)
        for k in rz:
            assert _same_bytes(rz[k], tz[k]), (e, k)
        for key in (f"q7/epoch_{e}.npz", f"q7/epoch_{e}.meta"):
            rec = tm["crc"][str(e)][key.rsplit(".", 1)[1]]
            assert rec == crc32c(tstore.store.get(key))
        if jm["kind"][str(e)] == "full":
            # leaf_{i} are the leaves in the reference's order and paths
            paths = [p for p, _ in leaf_paths(ref)]
            assert len(paths) == len(tz) == 23
    kinds = [k for _, k in sorted(
        (int(e), k) for e, k in tm["kind"].items())]
    assert tstore.epochs("q7") == jstore.epochs("q7")
    # the whole history of kinds: full first, a full when 3 deltas
    # followed the last full (epochs 5 and 11), and fulls at more than
    # half dirty (epoch 6 adds 1 everywhere, epoch 7 takes it back)
    history = []
    tstore2 = CheckpointStore("port2", object_store=InMemObjectStore(),
                              **STORE)
    for e in epochs:
        tstore2.save("q7", e, state_from_numpy(saved[e]), {})
        history.append(tstore2.checkpoint_kind("q7", e)[0])
    assert "".join(history) == "fdddfffdddf"
    # GC keeps the chain: the oldest retained epoch is a full
    retained = tstore.epochs("q7")
    assert tstore.checkpoint_kind("q7", retained[0]) == "full"
    assert len(retained) >= 2 and kinds[0] == "full"
    for e in retained:
        (je, jst, jsrc), (te, tst, tsrc) = jstore.load("q7", e), \
            tstore.load("q7", e)
        assert je == te == e and jsrc == tsrc == {"offset": e}
        _assert_same_leaves(jax.device_get(jst), tst)
        _assert_same_leaves(saved[e], tst)


@pytest.mark.parametrize("n", [0, 1, 1000, 8192 * 8, 8192 * 9 + 13,
                               1 << 20])
def test_crc32c_equals_reference(n):
    from risingwave_tpu.storage.codec import crc32c as j_crc32c

    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    assert crc32c(data) == j_crc32c(data)


def test_flipped_byte_raises_and_latest_load_rewinds():
    store = CheckpointStore("x", object_store=InMemObjectStore(), **STORE)
    jeng = _start(JEngine(JConfig(**SIZES)))
    for e in (1, 2, 3):
        jeng.tick(barriers=1, chunks_per_barrier=4)
        store.save("q7", e, state_from_numpy(
            jax.device_get(jeng.jobs[0].states)), {"offset": e})
    assert [store.checkpoint_kind("q7", e) for e in store.epochs("q7")] \
        == ["full", "delta", "delta"]
    key = "q7/epoch_3.npz"
    raw = bytearray(store.store.get(key))
    raw[len(raw) // 2] ^= 0x40
    store.store.put(key, bytes(raw))
    assert store.verify_job("q7")["corrupt"] == [(3, key)]
    with pytest.raises(CheckpointCorruption):
        store.load("q7", 3)
    # the latest-epoch load quarantines epoch 3 and rewinds to 2
    epoch, states, src = store.load("q7")
    assert epoch == 2 and src == {"offset": 2}
    assert store.epochs("q7") == [1, 2]
    assert store.store.list("quarantine/")


def test_failing_object_store_is_loud_and_recover_rewinds(tmp_path):
    eng = _start(Engine(PlannerConfig(**SIZES), data_dir=str(tmp_path),
                        device="cpu"))
    faults = StoreFaults()
    eng.checkpoint_store.store = LocalFsObjectStore(str(tmp_path),
                                                    faults=faults)
    job = eng.jobs[0]
    eng.tick(barriers=2, chunks_per_barrier=2)
    durable = job.committed_epoch
    assert durable > 0 and job.sealed_epoch == durable
    offset = job.source.offset
    # a dead store: the retry budget (4 attempts) runs out
    faults.fail("put", substr="MANIFEST", mode="before", times=4)
    with pytest.raises(RuntimeError, match="upload failed"):
        eng.tick(barriers=1, chunks_per_barrier=2)
    assert job.sealed_epoch > durable
    assert eng.checkpoint_store.committed_epoch("bench_mv") == durable
    assert job._uploader.retries_total >= 3
    assert not eng.checkpoint_store.store.exists(
        f"bench_mv/epoch_{job.sealed_epoch}.npz")
    want = flatten(eng.checkpoint_store.load("bench_mv")[1])[0]
    eng.recover()
    assert job.committed_epoch == durable
    assert job.source.offset == offset
    got = flatten(job.states)[0]
    assert all(bool((a == b).all()) for a, b in zip(want, got))
    # the next save re-bases FULL and the pipeline runs on
    eng.tick(barriers=1, chunks_per_barrier=2)
    assert eng.checkpoint_store.checkpoint_kind(
        "bench_mv", job.committed_epoch) == "full"
