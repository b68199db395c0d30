"""Lightweight metrics registry (counters / gauges / histograms).

A copy of the registry part of ``risingwave_tpu/common/metrics.py``
(``MetricsRegistry`` and its series types), unchanged: the module imports
no JAX, and the port keeps its own copy instead of importing the
reference package.  The cluster-scrape merge is not copied.

Reference counterpart (SURVEY.md §5.5): guarded Prometheus metrics
(src/common/metrics/src/guarded_metrics.rs) with per-subsystem
registries (``StreamingMetrics`` etc.).  Here: an in-process registry
with labeled series and a Prometheus-text exporter, feeding the
``rw_catalog``-style introspection the engine exposes.
"""

from __future__ import annotations

import bisect
import threading
import time
from collections import defaultdict


class _Series:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0


class _HistSeries:
    __slots__ = ("buckets", "counts", "total", "sum")

    def __init__(self, buckets):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)
        self.total = 0
        self.sum = 0.0

    def observe(self, v: float):
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.total += 1
        self.sum += v


_DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)

#: wide-range duration grid for coarse control-plane phases (barrier
#: commits, replays): the default grid tops out at 10s, pushing any
#: slower observation into +Inf — useless for a bounded p99 gate on a
#: 1-core box where a compile-heavy round legitimately takes minutes
WIDE_SECONDS_BUCKETS = (
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
    300.0, 600.0,
)


def _fmt_le(b: float) -> str:
    """Prometheus exposition-format bound: ``0.005``, ``1``, ``2.5``
    — decimal notation, no trailing ``.0``, never an exponent repr."""
    s = f"{b:.10f}".rstrip("0").rstrip(".")
    return s if s else "0"


class MetricsRegistry:
    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[tuple, _Series] = defaultdict(_Series)
        self._gauges: dict[tuple, _Series] = defaultdict(_Series)
        self._hists: dict[tuple, _HistSeries] = {}

    # ------------------------------------------------------------------
    def counter(self, name: str, **labels) -> None:
        raise TypeError("use inc()")

    def inc(self, name: str, amount: float = 1.0, **labels) -> None:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._counters[key].value += amount

    def set_gauge(self, name: str, value: float, **labels) -> None:
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._gauges[key].value = value

    def observe(self, name: str, value: float, buckets=None,
                **labels) -> None:
        """``buckets`` picks the grid at series CREATION (first
        observe wins; later values are ignored — one series, one
        grid)."""
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            if key not in self._hists:
                self._hists[key] = _HistSeries(
                    tuple(buckets) if buckets else _DEFAULT_BUCKETS)
            self._hists[key].observe(value)

    def timer(self, name: str, **labels):
        """Context manager observing elapsed seconds into a histogram
        (the guarded-metrics ``start_timer`` analog) — used by the
        storage service for compaction/vacuum durations."""

        class _Timer:
            def __enter__(s):
                s.t0 = time.perf_counter()
                return s

            def __exit__(s, *exc):
                self.observe(name, time.perf_counter() - s.t0, **labels)

        return _Timer()

    def remove_series(self, name: str, **labels) -> None:
        """Drop one labeled series (counter/gauge/histogram).  The
        control plane retires a dead worker's per-worker gauges so the
        scrape surface reflects the live membership, not tombstones."""
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._counters.pop(key, None)
            self._gauges.pop(key, None)
            self._hists.pop(key, None)

    def remove_where(self, name: str | None = None, **labels) -> None:
        """Bulk companion of ``remove_series``: drop EVERY series
        whose label set contains the given key/values (optionally
        restricted to one metric name).  ``DROP MATERIALIZED VIEW``
        retires a job's whole scrape footprint this way — the
        job-labeled families carry extra labels (``node``/``side``/
        ``phase``) the caller cannot enumerate."""
        want = tuple(labels.items())

        def match(key) -> bool:
            n, lbls = key
            if name is not None and n != name:
                return False
            d = dict(lbls)
            return all(d.get(k) == v for k, v in want)

        with self._lock:
            for store in (self._counters, self._gauges, self._hists):
                for k in [k for k in store if match(k)]:
                    del store[k]

    # ------------------------------------------------------------------
    def get(self, name: str, **labels) -> float:
        key = (name, tuple(sorted(labels.items())))
        if key in self._counters:
            return self._counters[key].value
        if key in self._gauges:
            return self._gauges[key].value
        raise KeyError(name)

    def quantile(self, name: str, q: float, **labels) -> float:
        """Approximate quantile from histogram buckets.

        Always returns a bucket UPPER BOUND: the least bucket boundary
        ``b`` such that at least ``q`` of the observations are ``<= b``
        (``+inf`` when the quantile falls in the overflow bucket, and
        ``0.0`` for an empty histogram).  Consumers that form ratios of
        two quantiles — the ``barrier_spike_ratio`` gauge divides
        p99 by p50 — therefore compare like with like: both sides are
        boundaries of the same fixed bucket grid, never interpolated.
        """
        key = (name, tuple(sorted(labels.items())))
        h = self._hists[key]
        if h.total == 0:
            return 0.0
        target = q * h.total
        seen = 0
        for i, c in enumerate(h.counts):
            seen += c
            if seen >= target:
                return h.buckets[i] if i < len(h.buckets) else float("inf")
        return float("inf")

    def hist_counts(self, name: str, **labels) -> list[int]:
        """Bucket-count snapshot of one histogram series (empty list
        when the series does not exist yet).  Pair with
        ``quantile_delta`` for warmup-excluding tail gates."""
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            h = self._hists.get(key)
            return list(h.counts) if h else []

    def quantile_delta(self, name: str, q: float, baseline,
                       **labels) -> float:
        """``quantile`` over only the observations made since
        ``baseline`` (a ``hist_counts`` snapshot) — how SLO gates
        exclude compile-heavy warmup rounds from a tail ceiling.
        Returns 0.0 when nothing was observed since the snapshot."""
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            h = self._hists.get(key)
            if h is None:
                return 0.0
            base = list(baseline) + [0] * (len(h.counts) - len(baseline))
            counts = [c - b for c, b in zip(h.counts, base)]
        total = sum(counts)
        if total <= 0:
            return 0.0
        target = q * total
        seen = 0
        for i, c in enumerate(counts):
            seen += c
            if seen >= target:
                return h.buckets[i] if i < len(h.buckets) \
                    else float("inf")
        return float("inf")

    def render_prometheus(self) -> str:
        """Prometheus text exposition (the scrape surface): samples
        grouped per metric under one ``# TYPE`` line, ``le`` bucket
        labels in exposition-format convention (``0.005``, ``1``,
        ``+Inf`` — never ``1.0`` or an exponent repr)."""
        out = []

        def fmt_labels(labels):
            if not labels:
                return ""
            inner = ",".join(f'{k}="{v}"' for k, v in labels)
            return "{" + inner + "}"

        seen: set[str] = set()

        def type_line(name, kind):
            if name not in seen:
                seen.add(name)
                out.append(f"# TYPE {name} {kind}")

        with self._lock:
            for (name, labels), s in sorted(self._counters.items()):
                type_line(name, "counter")
                out.append(f"{name}{fmt_labels(labels)} {s.value}")
            for (name, labels), s in sorted(self._gauges.items()):
                type_line(name, "gauge")
                out.append(f"{name}{fmt_labels(labels)} {s.value}")
            for (name, labels), h in sorted(self._hists.items()):
                type_line(name, "histogram")
                acc = 0
                for i, b in enumerate(h.buckets):
                    acc += h.counts[i]
                    lb = dict(labels)
                    lb["le"] = _fmt_le(b)
                    out.append(
                        f"{name}_bucket{fmt_labels(sorted(lb.items()))} {acc}"
                    )
                lb = dict(labels)
                lb["le"] = "+Inf"
                out.append(
                    f"{name}_bucket{fmt_labels(sorted(lb.items()))} "
                    f"{h.total}"
                )
                out.append(f"{name}_count{fmt_labels(labels)} {h.total}")
                out.append(f"{name}_sum{fmt_labels(labels)} {h.sum}")
        return "\n".join(out) + "\n"
