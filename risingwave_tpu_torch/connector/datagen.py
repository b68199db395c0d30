"""The ``datagen`` connector: deterministic rows of declared columns.

Port of the reference's ``_DatagenReader`` (``risingwave_tpu/sql/
engine.py:4114``) and of the schema a ``CREATE SOURCE`` declares
(``Engine._declared_schema``, :804).  Row k of the stream (k counts
from 0 per split, interleaved like the reference's) holds k in every
integer column, ``(k % 1000) / 10`` in every float column and
``"<column>_<k % 1000>"`` in every string column; each chunk is
``capacity`` inserts, built on the host and moved to ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from risingwave_tpu_torch.common.chunk import Chunk, StrCol, encode_strings
from risingwave_tpu_torch.common.types import (
    DataType,
    Field,
    Schema,
    parse_sql_type,
)


def declared_schema(stmt):
    """(schema, watermark (column, delay us) or None, auto-width columns)
    of a CREATE SOURCE or CREATE TABLE with declared columns: a VARCHAR
    declared without a width starts at the default width, and a table
    re-derives it from its data before each plan."""
    fields = []
    auto = []
    for i, c in enumerate(stmt.columns):
        t, width, scale = parse_sql_type(c.type_name)
        kw = {}
        if width is not None:
            kw["str_width"] = width
        elif t.is_string:
            auto.append(i)
        if scale is not None:
            kw["decimal_scale"] = scale
        fields.append(Field(c.name, t, nullable=c.nullable, **kw))
    schema = Schema(tuple(fields))
    wm = None
    if stmt.watermark is not None:
        wm = (schema.index_of(stmt.watermark.column),
              stmt.watermark.delay.micros)
    return schema, wm, auto


class DatagenReader:
    """A split of the datagen stream; ``offset`` is the checkpointable
    cursor (rows generated by this split)."""

    def __init__(self, schema: Schema, cap: int, split_id: int = 0,
                 num_splits: int = 1, device="cpu"):
        self.schema = schema
        self.cap = cap
        self.split_id = split_id
        self.num_splits = num_splits
        self.offset = 0
        self.device = torch.device(device)

    def next_chunk(self) -> Chunk:
        base = self.offset * self.num_splits + self.split_id * self.cap
        k = base + np.arange(self.cap, dtype=np.int64)
        cols = []
        for f in self.schema:
            t = f.data_type
            if t.is_string:
                data, lens = encode_strings(
                    [f"{f.name}_{int(v) % 1000}" for v in k], f.str_width)
                cols.append(StrCol(torch.from_numpy(data).to(self.device),
                                   torch.from_numpy(lens).to(self.device)))
            elif t in (DataType.FLOAT32, DataType.FLOAT64):
                cols.append(torch.from_numpy(
                    (k % 1000).astype(np.float64) / 10.0).to(
                        device=self.device, dtype=t.physical_dtype))
            else:
                cols.append(torch.from_numpy(k).to(
                    device=self.device, dtype=t.physical_dtype))
        self.offset += self.cap
        return Chunk(tuple(cols),
                     torch.zeros(self.cap, dtype=torch.int8,
                                 device=self.device),
                     torch.ones(self.cap, dtype=torch.bool,
                                device=self.device),
                     self.schema)

    def state(self) -> dict:
        return {"offset": self.offset, "split_id": self.split_id}
