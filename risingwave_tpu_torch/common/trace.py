"""Trace-lite: the span recorder the checkpoint uploader records into.

A copy of the span part of ``risingwave_tpu/common/trace.py``
(``SpanRecorder``, its spans and ``GLOBAL_TRACE``), unchanged: the
module imports no JAX, and the port keeps its own copy instead of
importing the reference package.  The cross-process assembly (dump
merging, round trees, Chrome trace export) is not copied.

A span is a finished interval recorded into a bounded per-process ring
(``dump``).  ``sample_n == 0`` disables tracing: ``span()`` then returns
a shared no-op.  A span parents under an explicit ``ctx`` (the
uploader passes the context captured when the epoch was sealed), else
the thread's active span, else it is dropped unless ``trace_id`` roots
a new trace.  Timing is the host's wall clock: a span around a launch
measures the host call, never forcing a device sync.
"""

from __future__ import annotations

import itertools
import threading
import time


class _NullSpan:
    """Tracing disabled / unsampled: a shared, allocation-free no-op.
    Also what ``span()`` hands out mid-tree when the recorder is off,
    so call sites never branch."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> "_NullSpan":
        return self

    @property
    def ctx(self):
        return None


NULL_SPAN = _NullSpan()


class _Span:
    """One in-flight span; records itself into the ring on exit."""

    __slots__ = ("_rec", "trace_id", "span_id", "parent_id", "name",
                 "attrs", "_t0", "_ts", "_pushed")

    def __init__(self, rec, trace_id, span_id, parent_id, name, attrs):
        self._rec = rec
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.attrs = attrs
        self._t0 = 0.0
        self._ts = 0.0
        self._pushed = False

    @property
    def ctx(self) -> tuple:
        """The (trace_id, span_id) pair to hand to children — RPC
        frames, cross-thread closures, UploadTask fields."""
        return (self.trace_id, self.span_id)

    def set(self, **attrs) -> "_Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "_Span":
        self._ts = time.time()
        self._t0 = time.perf_counter()
        stack = self._rec._stack()
        stack.append((self.trace_id, self.span_id))
        self._pushed = True
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter() - self._t0
        if self._pushed:
            stack = self._rec._stack()
            if stack and stack[-1] == (self.trace_id, self.span_id):
                stack.pop()
            self._pushed = False
        if exc_type is not None:
            self.attrs["error"] = exc_type.__name__
        self._rec._record(self, dur)
        return False


class SpanRecorder:
    """Per-process bounded span ring + thread-local trace context."""

    def __init__(self, role: str = "proc", sample_n: int = 1,
                 capacity: int = 4096):
        self.role = role
        self.sample_n = sample_n
        self.capacity = capacity
        self._lock = threading.Lock()
        self._ring: list = []
        self._head = 0
        self._ids = itertools.count(1)
        self._sample_ctr = itertools.count()
        self._tls = threading.local()

    def configure(self, role: str | None = None,
                  sample_n: int | None = None,
                  capacity: int | None = None) -> "SpanRecorder":
        if role is not None:
            self.role = role
        if sample_n is not None:
            self.sample_n = sample_n
        if capacity is not None and capacity != self.capacity:
            with self._lock:
                self.capacity = capacity
                self._ring = self._snapshot_locked()[-capacity:]
                self._head = 0
        return self

    @property
    def enabled(self) -> bool:
        return self.sample_n > 0

    # -- context ---------------------------------------------------------
    def _stack(self) -> list:
        s = getattr(self._tls, "stack", None)
        if s is None:
            s = self._tls.stack = []
        return s

    def current(self) -> tuple | None:
        """The active (trace_id, span_id) on THIS thread, or None."""
        s = getattr(self._tls, "stack", None)
        return s[-1] if s else None

    def activate(self, ctx) -> "_CtxGuard | _NullSpan":
        """Adopt a remote context (an RPC frame's ``trace`` key) for
        the current thread.  No span is recorded — children attach."""
        if not self.enabled or not ctx:
            return NULL_SPAN
        return _CtxGuard(self, (ctx[0], ctx[1]))

    # -- span creation ---------------------------------------------------
    def span(self, name: str, ctx: tuple | None = None,
             trace_id: str | None = None, **attrs):
        """Open a control-plane span.  Parent resolution: explicit
        ``ctx`` (cross-thread/cross-process) > the thread's active
        span > root (``trace_id`` names a fresh trace)."""
        if self.sample_n <= 0:
            return NULL_SPAN
        if ctx is not None:
            tid, parent = ctx[0], ctx[1]
        else:
            cur = self.current()
            if cur is not None:
                tid, parent = cur
            elif trace_id is not None:
                tid, parent = trace_id, None
            else:
                return NULL_SPAN  # no trace active: nothing to attach to
        if trace_id is not None:
            tid = trace_id
        span_id = f"{self.role}:{next(self._ids)}"
        return _Span(self, tid, span_id, parent, name, attrs)

    def sampled_span(self, name: str, trace_id: str | None = None,
                     ctx: tuple | None = None, **attrs):
        """Data-plane span recorded 1-in-``sample_n`` (serving reads,
        compaction/scrub cycles).  Off or unsampled = the null span.
        ``ctx`` parents the sampled span into an existing trace (a
        serving replica tags reads with the last committed round's
        root ctx); otherwise it roots a ``sampled-<role>`` trace."""
        n = self.sample_n
        if n <= 0:
            return NULL_SPAN
        if next(self._sample_ctr) % n:
            return NULL_SPAN
        if ctx is not None:
            return self.span(name, ctx=ctx, **attrs)
        tid = trace_id if trace_id is not None \
            else f"sampled-{self.role}"
        return self.span(name, trace_id=tid, **attrs)

    # -- the ring --------------------------------------------------------
    def _record(self, span: _Span, dur: float) -> None:
        entry = {
            "trace_id": span.trace_id,
            "span_id": span.span_id,
            "parent_id": span.parent_id,
            "role": self.role,
            "name": span.name,
            "ts": span._ts,
            "dur": dur,
            "attrs": span.attrs,
            "thread": threading.current_thread().name,
        }
        with self._lock:
            if len(self._ring) < self.capacity:
                self._ring.append(entry)
            else:
                self._ring[self._head] = entry
                self._head = (self._head + 1) % self.capacity
        return None

    def _snapshot_locked(self) -> list:
        return self._ring[self._head:] + self._ring[:self._head]

    def dump(self, trace_id: str | None = None) -> list[dict]:
        """Snapshot the ring, oldest first (the ``rpc_trace_dump``
        payload — plain dicts, JSON-clean)."""
        with self._lock:
            spans = self._snapshot_locked()
        if trace_id is not None:
            spans = [s for s in spans if s["trace_id"] == trace_id]
        return spans

    def clear(self) -> None:
        with self._lock:
            self._ring = []
            self._head = 0


class _CtxGuard:
    __slots__ = ("_rec", "_ctx", "_pushed")

    def __init__(self, rec: SpanRecorder, ctx: tuple):
        self._rec = rec
        self._ctx = ctx
        self._pushed = False

    def __enter__(self):
        self._rec._stack().append(self._ctx)
        self._pushed = True
        return self

    def __exit__(self, *exc):
        if self._pushed:
            stack = self._rec._stack()
            if stack and stack[-1] == self._ctx:
                stack.pop()
            self._pushed = False
        return False


#: process-wide recorder; library code just imports and records
GLOBAL_TRACE = SpanRecorder()
