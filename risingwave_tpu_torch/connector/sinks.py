"""Sink connectors: deliver MV changelogs to external systems.

A copy of ``risingwave_tpu/connector/sinks.py``, unchanged: the module
imports no JAX, and the port keeps its own copy instead of importing
the reference package.

Reference counterpart: ``src/connector/src/sink/`` — the ``Sink``/
``SinkWriter`` traits (sink/mod.rs:773, writer.rs:33) with per-epoch
commit barriers.  The in-repo sinks: blackhole (benchmarking) and
jsonl/csv files with epoch commit records.
"""

from __future__ import annotations

import json
import os
from typing import Sequence

_OPS = {0: "insert", 1: "delete", 2: "update_delete", 3: "update_insert"}


class Sink:
    """Write changelog batches; commit at checkpoint epochs."""

    def write_batch(self, column_names: Sequence[str], ops, rows) -> None:
        raise NotImplementedError

    def commit(self, epoch: int) -> None:
        """Barrier commit (ref SinkWriter::barrier(checkpoint=true))."""

    def close(self) -> None:
        pass


class BlackholeSink(Sink):
    """Counts rows, delivers nowhere (ref blackhole; benchmarking)."""

    def __init__(self, **_options):
        self.rows_written = 0
        self.commits = 0

    def write_batch(self, column_names, ops, rows) -> None:
        self.rows_written += len(rows)

    def commit(self, epoch: int) -> None:
        self.commits += 1


class FileSink(Sink):
    """Append-mode jsonl/csv file sink with epoch commit markers.

    Each row becomes one line; checkpoint commits fsync and append a
    commit record so a reader can take only closed epochs (the
    poor-man's exactly-once of the reference's file sinks).
    """

    def __init__(self, path: str, format: str = "jsonl", **_options):
        self.path = path
        self.format = format
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")

    def write_batch(self, column_names, ops, rows) -> None:
        for op, row in zip(ops, rows):
            if self.format == "csv":
                vals = ",".join(str(v) for v in row)
                self._f.write(f"{_OPS[int(op)]},{vals}\n")
            else:
                rec = {"op": _OPS[int(op)]}
                rec.update(zip(column_names, (
                    v.item() if hasattr(v, "item") else v for v in row
                )))
                self._f.write(json.dumps(rec) + "\n")

    def commit(self, epoch: int) -> None:
        if self.format == "csv":
            self._f.write(f"__commit__,{epoch}\n")
        else:
            self._f.write(json.dumps({"op": "commit", "epoch": epoch}) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    def close(self) -> None:
        self._f.close()


SINK_REGISTRY = {
    "blackhole": BlackholeSink,
    "file": FileSink,
}


def create_sink(options: dict) -> Sink:
    connector = options.get("connector")
    if connector not in SINK_REGISTRY:
        raise ValueError(
            f"unsupported sink connector {connector!r} "
            f"(available: {sorted(SINK_REGISTRY)})"
        )
    kwargs = {k: v for k, v in options.items() if k != "connector"}
    return SINK_REGISTRY[connector](**kwargs)
