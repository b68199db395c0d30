"""Layered configuration system.

A copy of ``risingwave_tpu/common/config.py``, unchanged except that its imports
name this package: the module imports no JAX, and the port keeps its
own copy instead of importing the reference package.

Reference counterpart (SURVEY.md §5.6): the reference layers
1. per-node TOML config (``RwConfig``, src/common/src/config/mod.rs:81)
2. cluster-wide runtime-mutable system params
   (src/common/src/system_param/mod.rs:84)
3. per-session ``SET`` variables (src/common/src/session_config/)
4. WITH options on sources/sinks (handled by the SQL layer).

Here: dataclass sections mirroring (1), a ``SystemParams`` registry with
mutability flags mirroring (2) (``ALTER SYSTEM SET`` in the engine), and
``SessionConfig`` for (3).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class StreamingConfig:
    """ref config streaming section (src/common/src/config/streaming.rs)."""

    chunk_size: int = 4096           # ref default 256; TPU chunks are larger
    in_flight_barrier_nums: int = 1  # host loop is synchronous this round
    exchange_vnode_count: int = 256


@dataclass
class StorageConfig:
    """ref config storage section."""

    data_directory: str | None = None   # None = in-memory checkpoints only
    checkpoint_keep_epochs: int = 2
    sst_block_size_bytes: int = 64 * 1024


@dataclass
class StateConfig:
    """capacity knobs for device state tables (planner defaults)."""

    agg_table_size: int = 1 << 16
    agg_emit_capacity: int = 4096
    join_table_size: int = 1 << 14
    join_bucket_cap: int = 64
    join_out_capacity: int = 1 << 15
    topn_pool_size: int = 4096
    topn_emit_capacity: int = 1024
    mv_table_size: int = 1 << 16
    mv_ring_size: int = 1 << 20


@dataclass
class ClusterConfig:
    """Control-plane knobs (ref meta config: heartbeat/barrier
    sections of src/common/src/config/mod.rs)."""

    meta_host: str = "127.0.0.1"
    meta_rpc_port: int = 4600
    #: worker → meta liveness cadence
    heartbeat_interval_s: float = 0.5
    #: silence after which meta declares a worker dead and fails over
    heartbeat_timeout_s: float = 3.0
    #: how long a serving read waits for a reassigned owner before
    #: erroring (covers adopt + recover + first compile on a survivor)
    serve_retry_timeout_s: float = 60.0
    #: meta → worker control RPC deadline (barrier rounds include
    #: first-compile latency on fresh workers)
    rpc_timeout_s: float = 180.0
    #: serving replica → meta lease cadence (each heartbeat acks the
    #: held manifest vid and receives the next epoch-pin grant)
    serving_heartbeat_interval_s: float = 0.5
    #: serving replica block-cache capacity (decoded SST blocks)
    serving_cache_blocks: int = 1024
    #: serving replica result-cache budget (bytes of cached rows):
    #: completed reads keyed by (normalized sql, manifest vid) — an
    #: epoch advance re-keys every entry, so hits can never be stale
    serving_result_cache_bytes: int = 32 << 20
    #: pushdown plane: per-vid negative-cache capacity (pks proven
    #: absent at the pinned version; cleared wholesale on every vid
    #: advance, so a stale negative can never mask a fresh row).
    #: 0 disables.
    serving_negative_cache_keys: int = 65536
    #: pushdown plane: hottest normalized-sql keys replayed against
    #: the new vid on each lease grant (result-cache warmup).
    #: 0 disables.
    serving_warmup_keys: int = 8
    #: scale plane: vnode ring size (the consistent-hash keyspace
    #: jobs partition over; ref VirtualNode::COUNT)
    n_vnodes: int = 64
    #: scale plane: place ELIGIBLE jobs as vnode partitions over the
    #: active worker set (``ctl cluster scale N`` then moves only
    #: vnodes + the state behind them).  Off = whole-job placement.
    scale_partitioning: bool = False
    #: Exchange-lite sliced ingest (default ON): the ingest leader
    #: hash-partitions each DML batch ONCE and ships each worker only
    #: its owned slice; the VnodeGate becomes a correctness assert.
    #: Off = the PR-7 replicate-everything fan-out (the A/B baseline
    #: and field escape hatch).
    shuffle_ingest: bool = True
    #: integrity scrubber (meta-owned): seconds between background
    #: scrub cycles over pinned-version SSTs + checkpoint lineages
    #: (0 disables the background thread; ``ctl cluster scrub`` still
    #: drives cycles on demand)
    scrub_interval_s: float = 30.0
    #: unified control-RPC retry budget (common/faults.RetryPolicy):
    #: total attempts per idempotent/epoch-guarded call before the
    #: failure surfaces (1 = no retries, the pre-chaos behavior)
    rpc_retry_max_attempts: int = 4
    #: first backoff delay; doubles per retry (deterministic jitter)
    rpc_retry_base_delay_s: float = 0.05
    #: backoff cap
    rpc_retry_max_delay_s: float = 0.5
    #: trace-lite sampling (common/trace.py): 0 disables tracing
    #: entirely (span() hands out a shared null singleton — zero
    #: allocations on the chunk path); N >= 1 records every
    #: control-plane span (round/barrier/phase/upload) and 1-in-N
    #: data-plane spans (serving reads, compact/scrub cycles)
    trace_sample_n: int = 1
    #: per-process span flight-recorder capacity (bounded ring;
    #: oldest spans fall off — a dump is always the recent window)
    trace_buffer_spans: int = 4096


@dataclass
class RwConfig:
    """Top-level node config (ref RwConfig, config/mod.rs:81)."""

    streaming: StreamingConfig = field(default_factory=StreamingConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)
    state: StateConfig = field(default_factory=StateConfig)
    cluster: ClusterConfig = field(default_factory=ClusterConfig)

    @staticmethod
    def from_dict(d: dict) -> "RwConfig":
        cfg = RwConfig()
        for section_name, section in d.items():
            target = getattr(cfg, section_name)
            for k, v in section.items():
                if not hasattr(target, k):
                    raise KeyError(f"unknown config {section_name}.{k}")
                setattr(target, k, v)
        return cfg


# ---------------------------------------------------------------------------
# system params: cluster-wide, runtime mutable, persisted with checkpoints
# (ref system_param/mod.rs:84 — declared with defaults + mutability)

_SYSTEM_PARAM_DEFS = {
    # name: (default, mutable)
    "barrier_interval_ms": (1000, True),   # ref :84
    "checkpoint_frequency": (1, True),     # ref :85
    "chunks_per_barrier": (1, True),       # TPU batch knob (no ref analog)
    "max_concurrent_creating_streaming_jobs": (1, True),
    #: checkpoints between state-maintenance passes (rehash + counter
    #: checks); >1 amortizes the per-barrier device syncs
    "maintenance_interval_checkpoints": (1, True),
    #: checkpoints between in-memory snapshots; >1 amortizes the
    #: incremental shadow-snapshot dispatch (recovery falls back up to
    #: N-1 extra epochs)
    "snapshot_interval_checkpoints": (1, True),
    #: max sealed-but-not-yet-durable epochs in the async checkpoint
    #: uploader before the barrier loop write-stalls (the checkpoint
    #: analog of the storage L0-depth stall)
    "checkpoint_upload_window": (4, True),
    "pause_on_next_bootstrap": (False, True),
}




def _coerce(default, value):
    """Type-safe coercion for param writes (bool('false') is True...)."""
    if isinstance(default, bool):
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            low = value.strip().lower()
            if low in ("true", "t", "on", "1"):
                return True
            if low in ("false", "f", "off", "0"):
                return False
            raise ValueError(f"not a boolean: {value!r}")
        return bool(value)
    if isinstance(default, int):
        if isinstance(value, float) and value != int(value):
            raise ValueError(f"not an integer: {value!r}")
        return int(value)
    if isinstance(default, float):
        return float(value)
    return type(default)(value)


class SystemParams:
    def __init__(self, overrides: dict | None = None):
        self._values = {k: v for k, (v, _) in _SYSTEM_PARAM_DEFS.items()}
        for k, v in (overrides or {}).items():
            self.set(k, v)

    def get(self, name: str):
        if name not in self._values:
            raise KeyError(f"unknown system param {name!r}")
        return self._values[name]

    def set(self, name: str, value) -> None:
        if name not in _SYSTEM_PARAM_DEFS:
            raise KeyError(f"unknown system param {name!r}")
        default, mutable = _SYSTEM_PARAM_DEFS[name]
        if not mutable:
            raise ValueError(f"system param {name!r} is immutable")
        self._values[name] = _coerce(default, value)

    def to_dict(self) -> dict:
        return dict(self._values)


# ---------------------------------------------------------------------------
# session config (ref session_config/mod.rs — SET-able per session)

_SESSION_DEFS = {
    "query_epoch": (0, "read at a specific committed epoch (0 = latest)"),
    "streaming_parallelism": (
        1, "1 = linear; 0 = adaptive (all devices); N = N shards"
    ),
    "timezone": ("UTC", "display timezone"),
    "batch_row_limit": (1_000_000, "serving scan cap"),
}


class SessionConfig:
    def __init__(self):
        self._values = {k: v for k, (v, _) in _SESSION_DEFS.items()}

    def get(self, name: str):
        if name not in self._values:
            raise KeyError(f"unknown session variable {name!r}")
        return self._values[name]

    def set(self, name: str, value) -> None:
        if name not in _SESSION_DEFS:
            raise KeyError(f"unknown session variable {name!r}")
        default, _ = _SESSION_DEFS[name]
        self._values[name] = _coerce(default, value)

    def show_all(self) -> list[tuple[str, str, str]]:
        return [
            (k, str(self._values[k]), _SESSION_DEFS[k][1])
            for k in sorted(self._values)
        ]
