"""Epoch-versioned checkpoint persistence with a manifest (incremental).

Port of ``CheckpointStore`` from
``risingwave_tpu/storage/checkpoint_store.py``: ``prepare`` / ``commit``
/ ``save`` (:190, :289, :348), ``invalidate``, ``vacuum_orphans``,
``committed_epoch``, ``epochs``, ``checkpoint_bytes``,
``checkpoint_kind``, ``load`` with full + delta replay (:422-513),
``quarantine_epoch``, ``verify_job`` and ``repair_lineage``.  The MV
export to SSTs (``export_mv_sst``) waits for the port's Hummock layer.

What is stored is the reference's, object for object:

- ``<job>/epoch_<e>.npz``: a full snapshot (``leaf_{i}``, each leaf in
  its shape) or a delta of the blocks whose digest changed since the
  job's last committed epoch, coalesced into runs (``r_{i}_{start}``,
  flat slices of leaf ``i`` from element ``start``);
- ``<job>/epoch_<e>.meta``: the pickled tree spec (``common.tree``; the
  reference pickles a JAX treedef here), the sources' cursors, the
  epoch and its kind;
- ``MANIFEST.json``: per job the retained epochs, their kinds, their
  crc32c trailers and the committed epoch.

An epoch is a delta unless the job has no digests yet (a first save, a
new plan or a rewind), ``full_interval`` checkpoints passed since the
last full, more than half of the blocks are dirty, or the epoch is
already in the manifest; GC keeps ``keep_epochs`` epochs and never
breaks a delta chain (everything back to the base full of the oldest
kept epoch stays).  Leaves are torch tensors; their payload arrays
equal the reference's byte for byte (a ``TagTable``'s tags are stored
as int64, the reference's as uint64: the same bytes).

On the card the fetch is the port's own: the digest vector comes to the
host in one copy; for a delta, one K11 gather launch
(``storage.digest.dirty_gather``) packs every dirty block of every leaf
into a device staging buffer and one asynchronous copy brings it to
pinned host memory, from which the host cuts the runs; a full copies
each leaf into pinned memory.  The pinned and staging buffers are kept
per job and reused, so a prepared payload's arrays view them until the
job's next ``prepare`` (the uploader commits each epoch before it
prepares the next).  Device work runs on the caller's current stream
and ends in its ``synchronize``.  crc32c runs natively when the store
is told ``native_crc`` (the engine does so on the card).
"""

from __future__ import annotations

import collections
import contextlib
import io
import json
import os
import pickle
import threading

import numpy as np
import torch

from risingwave_tpu_torch.common.tree import flatten, unflatten
from risingwave_tpu_torch.storage.digest import (
    DEFAULT_BLOCK_ELEMS,
    block_counts,
    digest_leaves,
    dirty_gather,
    gather_plan,
    shadow_digest,
)
from risingwave_tpu_torch.storage.integrity import (
    CheckpointCorruption,
    crc32c,
    quarantine,
    record_integrity_error,
    verify_checkpoint_store,
)

_NP_DTYPES = {torch.bool: np.bool_, torch.uint8: np.uint8,
              torch.int8: np.int8, torch.int16: np.int16,
              torch.int32: np.int32, torch.int64: np.int64,
              torch.float32: np.float32, torch.float64: np.float64,
              torch.uint64: np.uint64}


def _aligned(n: int) -> int:
    return (n + 15) // 16 * 16


class _Staging:
    """One job's reused fetch buffers: pinned host bytes and int64s, a
    device byte staging buffer and a device int64 buffer."""

    def __init__(self, device: torch.device):
        self.device = device
        self._bufs: dict[str, torch.Tensor] = {}

    def get(self, name: str, n: int, dtype, pinned: bool) -> torch.Tensor:
        buf = self._bufs.get(name)
        if buf is None or buf.numel() < n:
            n = max(n, 1) * 5 // 4 + 64
            buf = torch.empty(n, dtype=dtype, pin_memory=True) if pinned \
                else torch.empty(n, dtype=dtype, device=self.device)
            self._bufs[name] = buf
        return buf


class CheckpointStore:
    """All durable I/O goes through an ``ObjectStore``
    (``storage/hummock/object_store.py``)."""

    _MANIFEST = "MANIFEST.json"

    def __init__(self, root: str, keep_epochs: int = 2,
                 full_interval: int = 16,
                 block_elems: int = DEFAULT_BLOCK_ELEMS,
                 object_store=None, metrics=None, native_crc: bool = False):
        from risingwave_tpu_torch.storage.hummock.object_store import (
            LocalFsObjectStore,
        )
        self.root = root
        self.keep_epochs = keep_epochs
        self.metrics = metrics
        #: checkpoints between forced fulls (chain-length bound)
        self.full_interval = full_interval
        self.block_elems = block_elems
        self.native_crc = native_crc
        self.store = object_store if object_store is not None \
            else LocalFsObjectStore(root)
        self._sigs: dict[str, tuple] = {}
        self._last_digests: dict[str, tuple[int, np.ndarray]] = {}
        self._since_full: dict[str, int] = {}
        self._staging: dict[str, _Staging] = {}
        self._lock = threading.RLock()
        #: the newest commits, oldest first: (job, epoch, kind, npz bytes,
        #: dirty blocks, blocks) — observability only
        self.commits: collections.deque = collections.deque(maxlen=256)

    def _crc(self, data) -> int:
        return crc32c(data, self.native_crc)

    def _manifest_txn(self):
        """Manifest read-modify-write under this store's lock and, for a
        filesystem store, an OS-level flock on the directory."""
        root = getattr(self.store, "root", None)

        @contextlib.contextmanager
        def txn():
            with self._lock:
                if root is None:
                    yield
                    return
                import fcntl

                os.makedirs(root, exist_ok=True)
                with open(os.path.join(root, "MANIFEST.lock"), "a+b") as f:
                    fcntl.flock(f, fcntl.LOCK_EX)
                    try:
                        yield
                    finally:
                        fcntl.flock(f, fcntl.LOCK_UN)

        return txn()

    # -- manifest -------------------------------------------------------
    def _load_manifest(self) -> dict:
        if not self.store.exists(self._MANIFEST):
            return {"jobs": {}}
        return json.loads(self.store.get(self._MANIFEST))

    def _store_manifest(self, m: dict) -> None:
        self.store.put(self._MANIFEST, json.dumps(m, indent=1).encode())

    # -- the fetch ------------------------------------------------------
    def _staging_of(self, job_name: str, device) -> _Staging:
        st = self._staging.get(job_name)
        if st is None or st.device != device:
            st = self._staging[job_name] = _Staging(device)
        return st

    def _digests(self, job_name: str, flat, nblocks, digests):
        """The digest vector on the host (numpy uint64)."""
        if digests is None:
            sig = tuple((str(x.dtype), x.numel()) for x in flat)
            with self._lock:
                if self._sigs.get(job_name, sig) != sig:
                    # a new plan under an old name re-bases with a full
                    self._last_digests.pop(job_name, None)
                    self._since_full.pop(job_name, None)
                self._sigs[job_name] = sig
            if flat and flat[0].device.type == "cuda":
                digests = torch.empty(sum(nblocks), dtype=torch.int64,
                                      device=flat[0].device)
                dummy = torch.zeros((), dtype=torch.int64,
                                    device=flat[0].device)
                shadow_digest(flat, None, digests, dummy, nblocks,
                              self.block_elems, update=False)
            else:
                digests = digest_leaves(flat, nblocks, self.block_elems)
        if isinstance(digests, np.ndarray):
            return digests.view(np.uint64).copy()
        if digests.device.type == "cuda":
            st = self._staging_of(job_name, digests.device)
            h = st.get("digests", digests.numel(), torch.int64, True)
            h[:digests.numel()].copy_(digests, non_blocking=True)
            torch.cuda.current_stream(digests.device).synchronize()
            return h[:digests.numel()].numpy().view(np.uint64).copy()
        return digests.numpy().view(np.uint64).copy()

    def _fetch_full(self, job_name, flat, shapes) -> dict:
        payload = {}
        if flat and flat[0].device.type == "cuda":
            dev = flat[0].device
            st = self._staging_of(job_name, dev)
            sizes = [_aligned(x.numel() * x.element_size()) for x in flat]
            host = st.get("host", sum(sizes), torch.uint8, True)
            offs = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
            for x, o in zip(flat, offs):
                nb = x.numel() * x.element_size()
                host[o:o + nb].copy_(x.view(torch.uint8), non_blocking=True)
            torch.cuda.current_stream(dev).synchronize()
            for i, (x, o, s) in enumerate(zip(flat, offs, shapes)):
                nb = x.numel() * x.element_size()
                payload[f"leaf_{i}"] = host[o:o + nb].numpy().view(
                    _NP_DTYPES[x.dtype]).reshape(s)
            return payload
        for i, (x, s) in enumerate(zip(flat, shapes)):
            payload[f"leaf_{i}"] = x.detach().cpu().clone().numpy() \
                .reshape(s)
        return payload

    def _fetch_delta(self, job_name, flat, nblocks, dirty, rows) -> dict:
        block = self.block_elems
        sizes = [x.numel() for x in flat]
        esizes = [x.element_size() for x in flat]
        entries, runs, total = gather_plan(dirty, nblocks, sizes, esizes,
                                           block, rows)
        payload = {}
        if not runs:
            return payload
        if flat[0].device.type != "cuda":
            for li, s, e, _ in runs:
                payload[f"r_{li}_{s}"] = flat[li][s:e].cpu().clone().numpy()
            return payload
        dev = flat[0].device
        st = self._staging_of(job_name, dev)
        m = entries.shape[0]
        eh = st.get("entries_host", 2 * m, torch.int64, True)
        eh[:2 * m].numpy()[:] = entries.reshape(-1)
        ed = st.get("entries_dev", 2 * m, torch.int64, False)
        ed[:2 * m].copy_(eh[:2 * m], non_blocking=True)
        staging = st.get("staging", total, torch.uint8, False)
        dirty_gather(flat, ed[:2 * m].view(m, 2), staging, nblocks, block,
                     rows)
        host = st.get("host", total, torch.uint8, True)
        host[:total].copy_(staging[:total], non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
        hv = host.numpy()
        for li, s, e, off in runs:
            x = flat[li]
            nbytes = (e - s) * x.element_size()
            payload[f"r_{li}_{s}"] = hv[off:off + nbytes].view(
                _NP_DTYPES[x.dtype])
        return payload

    # -- checkpoint save: prepare (fetch) / commit (write) --------------
    def prepare(self, job_name: str, epoch: int, leaves, shapes, treedef,
                source_state: dict, digests=None, lanes=None) -> dict:
        """Stage one epoch's payload on the host.  ``leaves`` are
        tensors of any shape (read as flat element streams);
        ``digests`` (the shadow's int64 digest vector) skips the digest
        pass; ``lanes`` (per leaf ``(rows, row_elems)`` or None, a
        per-shard shadow's) is that vector's block grid: a lane leaf's
        dirty runs are cut row by row and never cross a row (the
        reference's :246-270).  The store's own digest pass is flat.
        After this returns the caller may mutate the leaves."""
        block = self.block_elems
        flat = [x.reshape(-1) for x in leaves]
        if digests is None or lanes is None:
            lanes = [None] * len(shapes)
        nblocks = block_counts(shapes, lanes, block)
        digests = self._digests(job_name, flat, nblocks, digests)
        with self._lock:
            prev = self._last_digests.get(job_name)
            since_full = self._since_full.get(job_name, 0)
            # a re-save of an epoch already in the manifest must be FULL
            resave = epoch in self._load_manifest()["jobs"].get(
                job_name, {}).get("epochs", [])
        dirty = None
        if prev is not None and prev[1].shape == digests.shape:
            dirty = digests != prev[1]
        kind = "delta"
        if (dirty is None or since_full >= self.full_interval - 1
                or int(dirty.sum()) * 2 > digests.shape[0] or resave):
            kind = "full"
        if kind == "full":
            payload = self._fetch_full(job_name, flat, shapes)
        else:
            payload = self._fetch_delta(job_name, flat, nblocks, dirty,
                                        [ln[0] if ln else 1 for ln in lanes])
        n_dirty = digests.shape[0] if dirty is None else int(dirty.sum())
        return {"job": job_name, "epoch": epoch, "kind": kind,
                "payload": payload, "treedef": treedef,
                "source_state": source_state, "digests": digests,
                "dirty_blocks": (n_dirty, digests.shape[0])}

    def commit(self, prep: dict) -> None:
        """Write a prepared epoch: objects, manifest bump, GC, digest
        cache — the durable commit point."""
        job_name, epoch, kind = prep["job"], prep["epoch"], prep["kind"]
        key = f"{job_name}/epoch_{epoch}"
        buf = io.BytesIO()
        np.savez(buf, **prep["payload"])
        npz_bytes = buf.getvalue()
        meta_bytes = pickle.dumps({
            "treedef": prep["treedef"],
            "source_state": prep["source_state"],
            "epoch": epoch, "kind": kind,
        })
        with self._manifest_txn():
            self.store.put(key + ".npz", npz_bytes)
            self.store.put(key + ".meta", meta_bytes)
            m = self._load_manifest()
            job = m["jobs"].setdefault(job_name, {"epochs": []})
            job.setdefault("crc", {})[str(epoch)] = {
                "npz": self._crc(npz_bytes), "meta": self._crc(meta_bytes),
            }
            if epoch not in job["epochs"]:
                job["epochs"].append(epoch)
            job.setdefault("kind", {})[str(epoch)] = kind
            job["committed"] = epoch
            # GC beyond keep_epochs, never breaking a delta chain
            kinds = job["kind"]
            epochs_l = job["epochs"]
            if len(epochs_l) > self.keep_epochs:
                idx = len(epochs_l) - self.keep_epochs
                while idx > 0 and \
                        kinds.get(str(epochs_l[idx]), "full") != "full":
                    idx -= 1
                for old in epochs_l[:idx]:
                    kinds.pop(str(old), None)
                    job.get("crc", {}).pop(str(old), None)
                    for suffix in (".npz", ".meta"):
                        self.store.delete(f"{job_name}/epoch_{old}{suffix}")
                job["epochs"] = epochs_l[idx:]
            self._store_manifest(m)
            # only after the manifest commit
            self._last_digests[job_name] = (epoch, prep["digests"])
            self._since_full[job_name] = 0 if kind == "full" \
                else self._since_full.get(job_name, 0) + 1
            self.commits.append((job_name, epoch, kind, len(npz_bytes))
                                + tuple(prep.get("dirty_blocks", (0, 0))))

    def save(self, job_name: str, epoch: int, states, source_state: dict,
             digests=None, lanes=None) -> None:
        """Persist one epoch synchronously (prepare + commit)."""
        leaves, spec = flatten(states)
        self.commit(self.prepare(job_name, epoch, leaves, spec.shapes, spec,
                                 source_state, digests=digests, lanes=lanes))

    def invalidate(self, job_name: str) -> None:
        """Drop the job's digest cache (the next save is full) and
        vacuum orphan epoch files (called on recovery rewinds)."""
        with self._lock:
            self._last_digests.pop(job_name, None)
            self._since_full.pop(job_name, None)
        self.vacuum_orphans(job_name)

    def vacuum_orphans(self, job_name: str) -> int:
        """Delete ``epoch_N.{npz,meta}`` objects the manifest does not
        reference (a crash between the object write and the manifest
        commit)."""
        removed = 0
        with self._lock:
            m = self._load_manifest()
            known = {str(e) for e in m["jobs"].get(
                job_name, {}).get("epochs", [])}
            for key in self.store.list(job_name + "/"):
                name = key.rsplit("/", 1)[-1]
                if not name.startswith("epoch_"):
                    continue
                stem = name[len("epoch_"):]
                for suffix in (".npz", ".meta"):
                    if stem.endswith(suffix):
                        stem = stem[:-len(suffix)]
                        break
                else:
                    continue
                if stem.isdigit() and stem not in known:
                    self.store.delete(key)
                    removed += 1
        return removed

    def committed_epoch(self, job_name: str) -> int | None:
        job = self._load_manifest()["jobs"].get(job_name)
        return None if job is None else job.get("committed")

    def epochs(self, job_name: str) -> list[int]:
        """Retained epochs, oldest first."""
        job = self._load_manifest()["jobs"].get(job_name)
        return list(job.get("epochs", [])) if job else []

    def checkpoint_bytes(self, job_name: str, epoch: int) -> int:
        key = f"{job_name}/epoch_{epoch}.npz"
        return self.store.size(key) if self.store.exists(key) else 0

    def checkpoint_kind(self, job_name: str, epoch: int) -> str | None:
        job = self._load_manifest()["jobs"].get(job_name)
        if job is None:
            return None
        return job.get("kind", {}).get(str(epoch), "full")

    def load(self, job_name: str, epoch: int | None = None):
        """(epoch, states with CPU tensors, source_state); the latest
        committed epoch when ``epoch`` is None, which self-heals: a
        corrupt object quarantines its lineage tail and the load
        rewinds to the last epoch whose chain verifies.  An explicit
        epoch must be exact: corruption raises
        ``CheckpointCorruption``."""
        with self._lock:
            if epoch is not None:
                return self._load_locked(job_name, epoch)
            while True:
                target = self.committed_epoch(job_name)
                if target is None:
                    return None
                try:
                    return self._load_locked(job_name, target)
                except CheckpointCorruption as e:
                    record_integrity_error(self.metrics, e)
                    dropped = self.quarantine_epoch(
                        job_name, getattr(e, "epoch", target),
                        reason=str(e))
                    if not dropped:
                        raise
                    if self.metrics is not None:
                        self.metrics.inc("integrity_repairs_total",
                                         kind="checkpoint_rewind")

    def _get_verified(self, job: dict, job_name: str, epoch: int,
                      suffix: str) -> bytes:
        key = f"{job_name}/epoch_{epoch}.{suffix}"
        data = self.store.get(key)
        rec = job.get("crc", {}).get(str(epoch))
        if rec is not None and self._crc(data) != int(rec[suffix]):
            err = CheckpointCorruption(
                f"{key}: checkpoint object checksum mismatch", key=key)
            err.epoch = epoch
            raise err
        return data

    def _load_locked(self, job_name: str, epoch: int):
        m = self._load_manifest()
        job = m["jobs"].get(job_name, {})
        kinds = job.get("kind", {})
        retained = [e for e in job.get("epochs", []) if e <= epoch]
        if not retained or retained[-1] != epoch:
            retained = retained + [epoch]
        chain: list[int] = []
        for e in reversed(retained):
            chain.append(e)
            if kinds.get(str(e), "full") == "full":
                break
        chain.reverse()
        base = chain[0]
        meta = pickle.loads(self._get_verified(job, job_name, base, "meta"))
        with np.load(io.BytesIO(
                self._get_verified(job, job_name, base, "npz"))) as z:
            leaves = [np.array(z[f"leaf_{i}"]) for i in range(len(z.files))]
        for e in chain[1:]:
            meta = pickle.loads(self._get_verified(job, job_name, e, "meta"))
            with np.load(io.BytesIO(
                    self._get_verified(job, job_name, e, "npz"))) as z:
                for key in z.files:
                    _, li, s_el = key.split("_")
                    li, s_el = int(li), int(s_el)
                    data = z[key]
                    flat = leaves[li].reshape(-1)
                    flat[s_el:s_el + data.shape[0]] = data
        states = unflatten(meta["treedef"], leaves)
        return epoch, states, meta["source_state"]

    # -- integrity: quarantine + lineage repair --------------------------
    def quarantine_epoch(self, job_name: str, epoch: int,
                         reason: str = "checksum mismatch") -> list[int]:
        """Quarantine one corrupt epoch and drop it, with every later
        delta chained through it, from the manifest; returns the dropped
        epochs."""
        with self._manifest_txn():
            m = self._load_manifest()
            job = m["jobs"].get(job_name)
            if job is None or epoch not in job.get("epochs", []):
                return []
            epochs = job["epochs"]
            kinds = job.setdefault("kind", {})
            i = epochs.index(epoch)
            j = i + 1
            while j < len(epochs) \
                    and kinds.get(str(epochs[j]), "full") != "full":
                j += 1
            dropped = epochs[i:j]
            for e in dropped:
                quarantine(self.store, f"{job_name}/epoch_{e}.npz",
                           reason=reason, by="checkpoint_store",
                           metrics=self.metrics)
                kinds.pop(str(e), None)
                job.get("crc", {}).pop(str(e), None)
            job["epochs"] = epochs[:i] + epochs[j:]
            job["committed"] = max(job["epochs"]) if job["epochs"] else 0
            self._store_manifest(m)
            self._last_digests.pop(job_name, None)
            self._since_full.pop(job_name, None)
        return dropped

    def verify_job(self, job_name: str) -> dict:
        """Every retained epoch object of one job against its crc."""
        with self._lock:
            rep = verify_checkpoint_store(self.store, self._MANIFEST,
                                          jobs=[job_name],
                                          native=self.native_crc)
        return {"verified": rep["verified"],
                "corrupt": [(e, k) for _, e, k in rep["corrupt"]]}

    def repair_lineage(self, job_name: str) -> dict:
        """Verify and self-heal one lineage: corrupt epochs are
        quarantined and the chain truncates to verified state."""
        rep = self.verify_job(job_name)
        dropped: list[int] = []
        for e, key in rep["corrupt"]:
            record_integrity_error(
                self.metrics,
                CheckpointCorruption(f"{key}: scrub mismatch", key=key))
            dropped += self.quarantine_epoch(
                job_name, e, reason="scrub checksum mismatch")
        if dropped and self.metrics is not None:
            self.metrics.inc("integrity_repairs_total",
                             kind="checkpoint_rewind")
        return {"verified": rep["verified"],
                "corrupt": [k for _, k in rep["corrupt"]],
                "dropped_epochs": sorted(set(dropped))}
