"""Pipelined asynchronous checkpoint persistence.

Port of ``UploadTask`` and ``CheckpointUploader`` from
``risingwave_tpu/stream/checkpoint.py`` (:50, :80): one daemon thread
per job.  A snapshot barrier SEALS an epoch (the shadow update is
launched, the task queued) and returns at once; the uploader thread
then

1. fetches the epoch's payload to the host (``CheckpointStore.prepare``)
   and marks the task FETCHED: the next shadow update overwrites the
   shadow and its digest vector in place, so it waits for this point
   (``wait_fetched``) and no further;
2. writes the npz/meta objects and commits the manifest
   (``CheckpointStore.commit``), then ACKS the epoch.

On the card the fetch runs on the uploader's own CUDA stream, with its
device set explicitly: the stream first waits on the event the shadow
update recorded (``UploadTask.ready``), so the fetch reads the sealed
shadow, and ``prepare`` ends in that stream's ``synchronize``, after
which the shadow and the store's staging buffers are free again.  The
barrier loop itself never waits on the device: it blocks only in
``wait_window`` (more than ``upload_window`` epochs unacked) and in
``wait_fetched``.

A failed store write retries through ``RetryPolicy``; once the budget
is spent the partial objects are vacuumed and the error is re-raised
on the barrier loop at the next ``enqueue`` / ``wait_window`` /
``drain`` (a job cannot keep sealing epochs that never become
durable).  A task's spill-tier trees (``UploadTask.spill``) are saved
first, each under its own store key.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any

import torch

from risingwave_tpu_torch.common.faults import RetryPolicy
from risingwave_tpu_torch.common.trace import GLOBAL_TRACE


@dataclass
class UploadTask:
    """One sealed epoch queued for durable persistence."""

    epoch: int
    #: flat shadow leaves AT SEAL TIME (overwritten by the next update)
    leaves: list
    #: the shadow's int64 digest vector (device tensor)
    digests: Any
    shapes: list
    treedef: Any
    source_state: dict
    #: CUDA event recorded after the shadow update (None on the CPU)
    ready: Any = None
    #: [(store key, tree)] spill-tier saves, persisted before the epoch
    spill: list = field(default_factory=list)
    fetched: threading.Event = field(default_factory=threading.Event)
    error: Exception | None = None
    #: (trace_id, span_id) captured at seal time
    trace_ctx: tuple | None = None
    #: the shadow's per-leaf (rows, row_elems) lane grid (None = flat)
    lanes: Any = None


class CheckpointUploader:
    """Background uploader for one job's checkpoint chain."""

    def __init__(self, store, job_name: str, metrics=None,
                 retry: RetryPolicy | None = None):
        self.store = store
        self.job_name = job_name
        self.metrics = metrics
        self.retry = retry if retry is not None else RetryPolicy(
            max_attempts=4, base_delay_s=0.05, max_delay_s=1.0,
            metrics=metrics, op="upload")
        self._q: deque[UploadTask] = deque()
        self._cv = threading.Condition()
        self._pending: list[UploadTask] = []
        self._acked: deque[int] = deque()
        self._thread: threading.Thread | None = None
        self._streams: dict = {}
        self.error: Exception | None = None
        self.uploads_total = 0
        self.upload_seconds_total = 0.0
        self.stall_seconds_total = 0.0

    @property
    def retries_total(self) -> int:
        return self.retry.retries

    # -- producer side (the barrier loop) --------------------------------
    def enqueue(self, task: UploadTask) -> None:
        with self._cv:
            self._raise_if_failed()
            self._q.append(task)
            self._pending.append(task)
            self._cv.notify_all()
            # under the lock: an idle thread leaves only with the queue
            # empty, and clears _thread before it does
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name=f"ckpt-upload-{self.job_name}",
                    daemon=True)
                self._thread.start()

    def pending(self) -> int:
        with self._cv:
            return len(self._pending)

    def take_acked(self) -> list[int]:
        """Drain acked epochs (ascending: uploads are FIFO)."""
        with self._cv:
            out = list(self._acked)
            self._acked.clear()
            return out

    def wait_fetched(self, timeout: float = 600.0) -> None:
        """Block until every queued task's fetch completed (the shadow
        is about to be overwritten)."""
        with self._cv:
            tasks = list(self._pending)
        deadline = time.monotonic() + timeout
        for t in tasks:
            if not t.fetched.wait(max(0.0, deadline - time.monotonic())):
                raise TimeoutError(
                    f"{self.job_name}: upload fetch of epoch {t.epoch} "
                    f"did not complete within {timeout}s")
        self._raise_if_failed()

    def wait_window(self, window: int, timeout: float = 600.0) -> float:
        """Block while more than ``window`` sealed epochs are unacked;
        returns the seconds stalled."""
        with self._cv:
            self._raise_if_failed()
            if len(self._pending) <= window:
                return 0.0
            t0 = time.monotonic()
            deadline = t0 + timeout
            while len(self._pending) > window:
                if self.error is not None:
                    self._raise_if_failed()
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{self.job_name}: checkpoint uploader still "
                        f"{len(self._pending)} epochs behind after "
                        f"{timeout}s")
                self._cv.wait(min(left, 0.5))
            stalled = time.monotonic() - t0
            self.stall_seconds_total += stalled
            return stalled

    def drain(self, raise_error: bool = True, timeout: float = 600.0,
              ) -> None:
        """Block until the queue is empty."""
        with self._cv:
            deadline = time.monotonic() + timeout
            while self._pending:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"{self.job_name}: upload queue did not drain "
                        f"within {timeout}s")
                self._cv.wait(min(left, 0.5))
            if raise_error:
                self._raise_if_failed()

    def clear_error(self) -> None:
        """Recovery acknowledged the failure; the next save re-bases."""
        with self._cv:
            self.error = None

    def _raise_if_failed(self) -> None:
        if self.error is not None:
            raise RuntimeError(
                f"{self.job_name}: checkpoint upload failed — durable "
                "progress is stuck; recover() to rewind to the last "
                "committed epoch") from self.error

    # -- the uploader thread ---------------------------------------------
    #: idle uploader threads exit after this long with an empty queue
    _IDLE_EXIT_S = 10.0

    def _fetch_context(self, task: UploadTask):
        """The uploader's own stream on the task's card, after the
        sealing update (a no-op context on the CPU)."""
        if not task.leaves or task.leaves[0].device.type != "cuda":
            return contextlib.nullcontext()
        dev = task.leaves[0].device
        torch.cuda.set_device(dev)
        stream = self._streams.get(dev)
        if stream is None:
            stream = self._streams[dev] = torch.cuda.Stream(dev)
        if task.ready is not None:
            stream.wait_event(task.ready)
        return torch.cuda.stream(stream)

    def _run(self) -> None:
        idle_since = time.monotonic()
        while True:
            with self._cv:
                while not self._q:
                    if time.monotonic() - idle_since > self._IDLE_EXIT_S:
                        self._thread = None
                        return
                    self._cv.wait(0.5)
                task = self._q.popleft()
            idle_since = time.monotonic()
            t0 = time.perf_counter()
            try:
                # the tiers first: a crash between them and the job's
                # commit leaves a tier one epoch ahead, which the rewind
                # resolves (``rewind_spill_tier``)
                for key, tree in task.spill:
                    self.retry.run(
                        lambda k=key, t=tree: self.store.save(
                            k, task.epoch, t, {}),
                        retry_on=(OSError,), label="spill_save")
                with GLOBAL_TRACE.span("ckpt_prepare", ctx=task.trace_ctx,
                                       job=self.job_name, epoch=task.epoch):
                    with self._fetch_context(task):
                        prep = self.store.prepare(
                            self.job_name, task.epoch, task.leaves,
                            task.shapes, task.treedef, task.source_state,
                            digests=task.digests, lanes=task.lanes)
                task.fetched.set()
                with GLOBAL_TRACE.span("ckpt_commit", ctx=task.trace_ctx,
                                       job=self.job_name, epoch=task.epoch):
                    self.retry.run(lambda: self.store.commit(prep),
                                   retry_on=(OSError,), label="commit")
                dt = time.perf_counter() - t0
                with self._cv:
                    self._acked.append(task.epoch)
                    self._pending.remove(task)
                    self.uploads_total += 1
                    self.upload_seconds_total += dt
                    self._cv.notify_all()
                if self.metrics is not None:
                    self.metrics.observe("checkpoint_upload_seconds", dt,
                                         job=self.job_name)
            except Exception as e:  # noqa: BLE001 — surfaced on the loop
                try:
                    self.store.vacuum_orphans(self.job_name)
                except Exception:  # noqa: BLE001 — best-effort reap
                    pass
                task.error = e
                task.fetched.set()
                with self._cv:
                    self.error = e
                    self._pending.remove(task)
                    self._cv.notify_all()
