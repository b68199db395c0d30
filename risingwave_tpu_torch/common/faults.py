"""Retries with capped exponential backoff.

A copy of ``RetryPolicy`` and ``splitmix64`` from
``risingwave_tpu/common/faults.py``, unchanged: the checkpoint uploader
retries failed store writes through it.  The module imports no JAX; the
port keeps its own copy instead of importing the reference package.
The fault fabric and the chaos schedules are not copied.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field


def splitmix64(x: int) -> int:
    """Pure 64-bit mix (the digest scheme's position mixer): the
    fabric's only source of "randomness" — a function, not a stream."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = x
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


@dataclass
class RetryPolicy:
    """Retry transient failures with capped exponential backoff.

    Jitter is DETERMINISTIC — ``splitmix64(seed, attempt)`` scales the
    delay within ``[1 - jitter_frac, 1]`` — so a seeded chaos run
    replays its exact retry timeline.  Retries are only safe for
    idempotent or epoch-guarded calls; the caller picks the exception
    set (``ConnectionError``/``OSError`` by default: the peer never
    answered — ``RpcError`` means the peer REFUSED, which no retry
    fixes, so it is never retried here).
    """

    max_attempts: int = 5
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    jitter_frac: float = 0.25
    seed: int = 0
    #: metrics label + registry (counters: rpc_retries_total,
    #: rpc_retry_gave_up_total)
    metrics: object = None
    op: str = "rpc"
    #: cumulative counters (introspection without a registry)
    retries: int = 0
    gave_up: int = 0
    sleeper: object = field(default=time.sleep, repr=False)

    def delay(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        d = min(self.base_delay_s * (2 ** (attempt - 1)),
                self.max_delay_s)
        if self.jitter_frac > 0.0:
            h = splitmix64((self.seed << 20) ^ attempt)
            frac = (h & 0xFFFFFFFF) / 0xFFFFFFFF
            d *= 1.0 - self.jitter_frac * frac
        return d

    def run(self, fn, retry_on: tuple = (ConnectionError, OSError),
            label: str = ""):
        """Call ``fn()``; on a retryable exception back off and retry
        up to ``max_attempts`` total calls, then re-raise."""
        attempt = 0
        while True:
            try:
                return fn()
            except retry_on as e:
                attempt += 1
                if attempt >= self.max_attempts:
                    self.gave_up += 1
                    if self.metrics is not None:
                        self.metrics.inc("rpc_retry_gave_up_total",
                                         op=label or self.op)
                    raise
                self.retries += 1
                if self.metrics is not None:
                    self.metrics.inc("rpc_retries_total",
                                     op=label or self.op)
                self.sleeper(self.delay(attempt))
