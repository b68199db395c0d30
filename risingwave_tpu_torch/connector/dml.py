"""DML: user tables fed by INSERT, DELETE and UPDATE statements.

Port of ``risingwave_tpu/connector/dml.py``: ``mark_deletes`` (:33),
``row_is_delete`` (:39), ``TableDmlManager`` (:43; ``_check_widths``
:195, ``insert`` :225, ``refresh_schema``) and ``TableSourceReader``
(:254; ``next_chunk`` :310, ``state`` / ``restore``).

A ``TableDmlManager`` per table keeps the table's whole history (rows
in statement order); every downstream job reads it through its own
``TableSourceReader``, a non-destructive ``offset`` cursor over the
shared list, so a reader created later replays earlier rows and
recovery rewinds the cursor.  A DELETE row is the full old row with
``DELETE_MARK`` appended past the schema width; the reader decodes it
to ``OP_DELETE`` at this single point.  An idle reader returns a
shape-static empty chunk.

The cluster exchange's parts of the reference (exchange-lite: the vnode
log, the reader's ``vnode_filter`` and consumption fence) are not
ported; ``insert_at`` and ``insert_sparse`` raise
``NotImplementedError``.  The scale plane's partitions
(``cluster/scale``) run in replicate mode: each reads the whole table and
its ``VnodeGateExecutor`` filters.

``live_row`` is the reference engine's ``_update`` fold (the live old
row under a full pk, ``engine.py:600``) kept incrementally: the history
is append-only, so folding each row once gives the fold over the whole
history at every call.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Sequence

import numpy as np
import torch

from risingwave_tpu_torch.common.chunk import OP_DELETE, OP_INSERT, Chunk
from risingwave_tpu_torch.common.types import Schema

#: marker-tail retraction encoding: a DELETE row is the full old row
#: with this sentinel appended past the schema width (the reference's)
DELETE_MARK = "__rwt_delete__"

#: the reference's exchange-lite (the vnode log, ``insert_at`` /
#: ``insert_sparse``, the reader's ``vnode_filter``) is not ported: a
#: partition of the scale plane reads its whole table and its gate filters
_CLUSTER = ("exchange-lite's table replication (sliced delivery and the "
            "reader's vnode_filter) is not ported yet: every partition "
            "reads the whole table")


def mark_deletes(rows, width: int) -> list[tuple]:
    """Append the delete marker to full-width rows (idempotent)."""
    return [tuple(r) if len(r) > width else tuple(r) + (DELETE_MARK,)
            for r in rows]


def row_is_delete(row, width: int) -> bool:
    return len(row) > width and row[width] == DELETE_MARK


class TableDmlManager:
    """The history of one table and the readers of its jobs."""

    def __init__(self, schema: Schema, auto_width_cols=()):
        self.schema = schema
        self._readers: list[TableSourceReader] = []
        #: every row in statement order (deletes marked), shared with
        #: the readers
        self._history: list = []
        self.rows_inserted = 0
        #: VARCHAR columns declared without a width: their device width
        #: follows the observed maximum (``refresh_schema``)
        self.auto_width_cols = set(auto_width_cols)
        self._max_lens = {i: 0 for i in self.auto_width_cols}
        #: ``live_row``'s incremental fold: pk columns -> (rows folded,
        #: {pk values: {full row: count}})
        self._folds: dict = {}

    def new_reader(self, chunk_capacity: int, device="cpu"
                   ) -> "TableSourceReader":
        """A reader at offset 0 over the shared history (it replays
        everything inserted so far)."""
        r = TableSourceReader(self.schema, chunk_capacity, self._history,
                              device)
        self._readers.append(r)
        return r

    def history_slice(self, lo: int, hi: int | None = None) -> list:
        """Rows [lo, hi) of the history."""
        return [list(r) for r in (self._history[lo:] if hi is None
                                  else self._history[lo:hi])]

    def insert_at(self, seq: int, rows) -> int:
        raise NotImplementedError(_CLUSTER)

    def insert_sparse(self, seq: int, end: int, items, vnodes=()) -> int:
        raise NotImplementedError(_CLUSTER)

    def _check_widths(self, rows: Sequence[tuple]) -> None:
        """Refuse a batch whose string would be truncated by a running
        job's compiled width, then fold its lengths into the auto
        widths (a refused batch does not widen them)."""
        str_cols = [i for i, f in enumerate(self.schema)
                    if f.data_type.is_string]
        batch_max = {i: 0 for i in str_cols}
        for row in rows:
            for i in str_cols:
                v = row[i]
                if isinstance(v, str):
                    n = len(v.encode("utf-8"))
                    if n > batch_max[i]:
                        batch_max[i] = n
        for i in str_cols:
            for r in self._readers:
                f = r.schema[i]
                if batch_max[i] > f.str_width:
                    raise ValueError(
                        f"value for {f.name!r} exceeds the width "
                        f"({f.str_width}B) a running job compiled "
                        "against; declare VARCHAR(n) wide enough "
                        "before creating views on this table")
        for i in self._max_lens:
            self._max_lens[i] = max(self._max_lens[i], batch_max[i])

    def insert(self, rows: Sequence[tuple], delete: bool = False) -> int:
        rows = list(rows)
        if delete:
            rows = mark_deletes(rows, len(self.schema))
        self._check_widths(rows)
        self._history.extend(rows)  # the readers see this shared list
        self.rows_inserted += len(rows)
        return len(rows)

    def refresh_schema(self) -> Schema:
        """Re-derive the auto VARCHAR widths from the observed data
        (a multiple of 8, never below the field's current width, so
        running readers stay valid)."""
        fields = list(self.schema)
        for i in self.auto_width_cols:
            need = self._max_lens[i]
            if need > fields[i].str_width:
                fields[i] = replace(fields[i], str_width=-(-need // 8) * 8)
        self.schema = Schema(tuple(fields))
        return self.schema

    def live_rows(self, pk: Sequence[int], key: tuple) -> list[tuple]:
        """The full rows under the pk values ``key`` whose inserts
        outnumber their marked deletes in the history (the reference's
        multiset fold in ``Engine._update``)."""
        pk = tuple(pk)
        width = len(self.schema)
        done, counts = self._folds.get(pk, (0, {}))
        for row in self._history[done:]:
            t = tuple(row)
            base = t[:width]
            by_key = counts.setdefault(tuple(base[i] for i in pk), {})
            by_key[base] = by_key.get(base, 0) + (
                -1 if row_is_delete(t, width) else 1)
        self._folds[pk] = (len(self._history), counts)
        return [b for b, n in counts.get(tuple(key), {}).items() if n > 0]


class TableSourceReader:
    """A cursor over the table's shared history; empty chunks when
    idle.  Rows are never popped: only ``offset`` advances, so recovery
    rewinds it and replays rows consumed after the last commit."""

    def __init__(self, schema: Schema, chunk_capacity: int, history: list,
                 device="cpu"):
        self.schema = schema
        self.cap = chunk_capacity
        self.device = torch.device(device)
        #: shared with ``TableDmlManager._history`` (no copy)
        self._rows = history
        #: consumed-row cursor into the history (checkpointed)
        self.offset = 0

    def pending(self) -> int:
        # a restored offset may exceed a history not yet reloaded
        return max(0, len(self._rows) - self.offset)

    def next_chunk(self) -> Chunk:
        end = min(len(self._rows), self.offset + self.cap)
        batch = self._rows[self.offset:end]
        self.offset = max(self.offset, end)
        if not batch:
            # the shape-static empty chunk
            arrays = [np.zeros((0,), np.int64) for _ in self.schema]
            return Chunk.from_numpy(self.schema, arrays, capacity=self.cap,
                                    device=self.device)
        arrays = [np.asarray([row[i] for row in batch])
                  for i in range(len(self.schema))]
        # marker-tail rows become OP_DELETE changelog entries here
        width = len(self.schema)
        ops = np.asarray([OP_DELETE if row_is_delete(row, width)
                          else OP_INSERT for row in batch], np.int8)
        return Chunk.from_numpy(self.schema, arrays, ops=ops,
                                capacity=self.cap, device=self.device)

    def state(self) -> dict:
        return {"offset": self.offset}

    def restore(self, state: dict) -> None:
        self.offset = int(state.get("offset", 0))
