"""In-memory catalog of sources and materialized views.

Port of ``risingwave_tpu/meta/catalog.py`` (the fields the ported
source, MV and sink paths use; the index, export and TTL fields are not
ported).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from risingwave_tpu_torch.common.types import Schema


@dataclass
class CatalogEntry:
    name: str
    kind: str                  # "source" | "mview" | "sink"
    schema: Schema
    #: source: factory (split_id, num_splits) -> reader
    reader_factory: Callable | None = None
    #: source: watermark (col_idx, delay_us)
    watermark: tuple[int, int] | None = None
    #: source: True when the stream never retracts
    append_only: bool = True
    #: mview: the running job + its materialize executor handle (a sink:
    #: its SinkExecutor)
    job: Any = None
    mv_executor: Any = None
    mv_state_index: Any = None  # index path to the MV state in job.states
    #: mview: pk column positions in ``schema``; a table: its PRIMARY KEY
    stream_key: Any = None
    definition: str = ""
    #: a table: its ``connector.dml.TableDmlManager`` (INSERT-fed)
    dml: Any = None
    #: mview/sink on a DagJob: the node ids this entry contributed
    #: (removed together on DROP)
    dag_nodes: Any = None
    #: source names this entry attached to a shared DagJob (detached on
    #: DROP, so that a dropped MV's private readers stop being pulled)
    dag_sources: Any = None


class Catalog:
    def __init__(self):
        self._entries: dict[str, CatalogEntry] = {}

    def create(self, entry: CatalogEntry, if_not_exists: bool = False) -> bool:
        if entry.name in self._entries:
            if if_not_exists:
                return False
            raise ValueError(f"{entry.name!r} already exists")
        self._entries[entry.name] = entry
        return True

    def drop(self, name: str, if_exists: bool = False) -> None:
        if name not in self._entries:
            if if_exists:
                return
            raise KeyError(name)
        del self._entries[name]

    def get(self, name: str) -> CatalogEntry:
        if name not in self._entries:
            raise KeyError(f"relation {name!r} does not exist")
        return self._entries[name]

    def list(self, kind: str | None = None) -> list[CatalogEntry]:
        return [e for e in self._entries.values()
                if kind is None or e.kind == kind]

    def __contains__(self, name: str) -> bool:
        return name in self._entries
