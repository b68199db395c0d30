"""Durable metadata store: DDL log + DML write-ahead log.

A copy of ``risingwave_tpu/meta/store.py``, unchanged: the module
imports no JAX, and the port keeps its own copy instead of importing
the reference package.  The port's engine uses the DDL log
(``append_ddl``, ``ddl_log``, ``has_catalog``); the DML and cluster
logs come along unused until the port has DML tables and a cluster.

Reference counterpart: the meta node's SQL metastore (sea-orm entities
over SQLite/PG, src/meta/model/) + ``DdlController`` recovery
(src/meta/src/rpc/ddl_controller.rs:1096): a fresh process reloads the
catalog and rebuilds every streaming job from persisted metadata, then
resumes from the last committed epoch.

TPU-first simplification: metadata volume is tiny and totally ordered
by the single control loop, so the store is two append-only JSONL logs
under ``data_dir``:

- ``catalog.jsonl`` — every applied DDL statement's raw SQL, in
  order (CREATE/DROP/ALTER/SET).  Replaying the log against a fresh
  Engine reconstructs the catalog AND the streaming jobs, because DDL
  is the single source of plan shape.
- ``dml/<table>.jsonl`` — committed INSERT batches per DML table (the
  reference's DML goes through the upstream table's durable state;
  here the table history IS that state, so it must survive restarts
  for source cursors to replay against).

Atomicity: lines are appended with a trailing newline and fsync'd;
a torn final line (crash mid-append) is detected and dropped at read
time.
"""

from __future__ import annotations

import json
import logging
import os

log = logging.getLogger(__name__)


class MetaStoreCorruption(RuntimeError):
    """A NON-tail log line failed to decode: the log is damaged beyond
    the crash-mid-append case and silently truncating it would drop
    acknowledged DDL/DML — recovery must stop loudly instead."""


class MetaStore:
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)
        self._ddl_path = os.path.join(root, "catalog.jsonl")
        self._dml_dir = os.path.join(root, "dml")
        os.makedirs(self._dml_dir, exist_ok=True)

    # -- append ---------------------------------------------------------
    def _append(self, path: str, obj: dict) -> None:
        # flush + fsync BEFORE returning: an append is acknowledged
        # (DDL applied, INSERT accepted) only once it is durable — a
        # worker SIGKILLed right after this call replays the line; one
        # killed mid-write leaves a torn tail ``_lines`` drops
        line = json.dumps(obj, separators=(",", ":")) + "\n"
        with open(path, "a") as f:
            f.write(line)
            f.flush()
            os.fsync(f.fileno())

    def append_ddl(self, sql: str) -> None:
        self._append(self._ddl_path, {"sql": sql})

    def append_dml(self, table: str, rows: list) -> None:
        self._append(
            os.path.join(self._dml_dir, f"{table}.jsonl"),
            {"rows": [list(r) for r in rows]},
        )

    def append_dml_sql(self, sql: str) -> None:
        """Cluster mode: the meta durably logs forwarded DML statements
        (the per-table row logs stay the single-node representation)."""
        self._append(os.path.join(self.root, "dml_sql.jsonl"),
                     {"sql": sql})

    def dml_sql_log(self) -> list[str]:
        return [e["sql"] for e in self._lines(
            os.path.join(self.root, "dml_sql.jsonl")
        )]

    def append_cluster_commit(self, round_: int, epoch: int,
                              seals: dict) -> None:
        """Cluster mode: one line per COMMITTED global round — the
        round number, the manifest epoch stamp, and every job's sealed
        epoch value.  A restarted meta replays the tail entry to
        recover its round position and per-job seal log (the manifest
        alone records epoch VALUES, not round indices).  Appended
        AFTER the manifest delta commits: a crash in between leaves
        the manifest one round ahead, which recovery re-commits
        idempotently (empty delta, same epoch stamp)."""
        self._append(os.path.join(self.root, "cluster_log.jsonl"),
                     {"round": int(round_), "epoch": int(epoch),
                      "seals": {k: int(v) for k, v in seals.items()}})

    def append_scale_event(self, event: dict) -> None:
        """Scale plane: one line per layout change — the vnode map,
        the active worker set, and every partitioned job's checkpoint
        lineages.  A restarted meta replays the TAIL event and
        re-adopts each lineage from the shared store."""
        self._append(os.path.join(self.root, "scale_log.jsonl"), event)

    def last_scale_event(self) -> dict | None:
        entries = self._lines(os.path.join(self.root,
                                           "scale_log.jsonl"))
        return entries[-1] if entries else None

    def last_cluster_commit(self) -> dict | None:
        """The newest committed-round record (None = nothing durable).
        Only the tail matters for recovery; earlier lines are history
        the log keeps for operators (lines are tiny)."""
        entries = self._lines(os.path.join(self.root,
                                           "cluster_log.jsonl"))
        return entries[-1] if entries else None

    # -- read -----------------------------------------------------------
    @staticmethod
    def _lines(path: str) -> list[dict]:
        """Replay one JSONL log.  A torn TAIL line (crash mid-append:
        missing newline and/or truncated JSON) is dropped with a
        warning — it was never acknowledged.  A damaged line anywhere
        ELSE raises ``MetaStoreCorruption``: silently truncating there
        would drop acknowledged history after it."""
        if not os.path.exists(path):
            return []
        with open(path) as f:
            lines = f.readlines()
        out = []
        for i, line in enumerate(lines):
            last = i == len(lines) - 1
            torn = not line.endswith("\n")
            if torn and not last:
                raise MetaStoreCorruption(
                    f"{path}:{i + 1}: embedded unterminated line"
                )
            try:
                obj = json.loads(line)
            except json.JSONDecodeError as e:
                if last:
                    log.warning(
                        "%s: dropping torn trailing line %d "
                        "(crash mid-append): %s", path, i + 1, e,
                    )
                    break
                raise MetaStoreCorruption(
                    f"{path}:{i + 1}: undecodable line mid-log"
                ) from e
            if torn:
                # parses but the newline never landed: the fsync that
                # acknowledges the append covers the newline, so this
                # write was still in flight — not acknowledged, drop it
                log.warning(
                    "%s: dropping unterminated trailing line %d "
                    "(crash mid-append)", path, i + 1,
                )
                break
            out.append(obj)
        return out

    def ddl_log(self) -> list[str]:
        return [e["sql"] for e in self._lines(self._ddl_path)]

    def dml_rows(self, table: str) -> list[tuple]:
        rows: list[tuple] = []
        for e in self._lines(os.path.join(self._dml_dir,
                                          f"{table}.jsonl")):
            rows.extend(tuple(r) for r in e["rows"])
        return rows

    def truncate_dml(self, table: str) -> None:
        """DROP TABLE discards the table's history; a later same-named
        CREATE TABLE must not resurrect pre-drop rows at replay."""
        p = os.path.join(self._dml_dir, f"{table}.jsonl")
        if os.path.exists(p):
            os.remove(p)

    def has_catalog(self) -> bool:
        return os.path.exists(self._ddl_path)
