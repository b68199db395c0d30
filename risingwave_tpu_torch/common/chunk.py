"""Fixed-capacity columnar stream chunks.

Port of ``risingwave_tpu/common/chunk.py``.  A ``Chunk`` has a static
capacity (the leading tensor dimension) and a boolean ``valid`` mask:
filtering and selective emission rewrite the mask instead of compacting,
so every kernel sees fixed shapes.

- ``columns``: one ``[cap]`` tensor per column, a ``StrCol`` for
  strings, an ``NCol`` for nullable columns;
- ``ops``: ``int8 [cap]`` changelog op per row;
- ``valid``: ``bool [cap]`` visibility.

All tensors of a chunk live on one device; the host conversions
(``from_numpy``, ``to_host``, ``to_rows``) are the test and serving
surface.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from risingwave_tpu_torch.common.types import DataType, Field, Schema

# Changelog ops (same codes as the reference package)
OP_INSERT = 0
OP_DELETE = 1
OP_UPDATE_DELETE = 2
OP_UPDATE_INSERT = 3


class StrCol(NamedTuple):
    """A fixed-width string column: utf-8 bytes + logical lengths."""

    data: torch.Tensor  # [cap, width] uint8, zero-padded
    lens: torch.Tensor  # [cap] int32


class NCol(NamedTuple):
    """A nullable column: payload + per-row null mask (True = NULL)."""

    data: Any            # [cap] tensor or StrCol
    null: torch.Tensor   # bool [cap]


def split_col(col):
    """(payload, null-mask-or-None) view of any column value."""
    if isinstance(col, NCol):
        return col.data, col.null
    return col, None


def make_col(data, null):
    if null is None:
        return data
    return NCol(data, null)


def col_device(col) -> torch.device:
    if isinstance(col, NCol):
        col = col.data
    return (col.data if isinstance(col, StrCol) else col).device


def conform_col(col, nullable: bool, cap: int):
    """Make a column's representation match its static nullability."""
    if nullable and not isinstance(col, NCol):
        return NCol(col, torch.zeros(cap, dtype=torch.bool,
                                     device=col_device(col)))
    if not nullable and isinstance(col, NCol):
        return col.data
    return col


class Chunk:
    """A fixed-capacity changelog batch of rows (SoA layout)."""

    __slots__ = ("columns", "ops", "valid", "schema")

    def __init__(self, columns: Sequence[Any], ops: torch.Tensor,
                 valid: torch.Tensor, schema: Schema):
        self.columns = tuple(columns)
        self.ops = ops
        self.valid = valid
        self.schema = schema

    @property
    def capacity(self) -> int:
        return self.valid.shape[0]

    @property
    def device(self) -> torch.device:
        return self.valid.device

    def cardinality(self) -> torch.Tensor:
        return self.valid.sum(dtype=torch.int64)

    def signs(self) -> torch.Tensor:
        """Per-row +1/-1/0 changelog sign (0 for invisible rows), int32."""
        insert_like = (self.ops == OP_INSERT) | (self.ops == OP_UPDATE_INSERT)
        one = torch.ones((), dtype=torch.int32, device=self.device)
        s = torch.where(insert_like, one, -one)
        return torch.where(self.valid, s, torch.zeros_like(s))

    def column(self, i: int):
        return self.columns[i]

    def column_by_name(self, name: str):
        return self.columns[self.schema.index_of(name)]

    def with_valid(self, valid: torch.Tensor) -> "Chunk":
        return Chunk(self.columns, self.ops, valid, self.schema)

    def mask(self, keep: torch.Tensor) -> "Chunk":
        return self.with_valid(self.valid & keep)

    def with_columns(self, columns: Sequence[Any], schema: Schema) -> "Chunk":
        return Chunk(columns, self.ops, self.valid, schema)

    # -- host-side conversion ------------------------------------------
    @staticmethod
    def from_numpy(schema: Schema, arrays: Sequence[np.ndarray],
                   ops: np.ndarray | None = None,
                   capacity: int | None = None,
                   device: torch.device | str = "cpu") -> "Chunk":
        """Build a chunk from host arrays, padding to ``capacity``."""
        if len(arrays) != len(schema.fields):
            raise ValueError(
                f"{len(arrays)} arrays for {len(schema.fields)}-field schema"
            )
        n = len(arrays[0]) if arrays else (len(ops) if ops is not None else 0)
        cap = capacity or max(n, 1)
        if n > cap:
            raise ValueError(f"{n} rows > capacity {cap}")
        if ops is None:
            ops = np.full(n, OP_INSERT, np.int8)
        cols = [_encode_column(f, np.asarray(a), cap, device)
                for f, a in zip(schema.fields, arrays)]
        ops_full = np.zeros(cap, np.int8)
        ops_full[:n] = ops
        valid = np.zeros(cap, np.bool_)
        valid[:n] = True
        return Chunk(cols, torch.from_numpy(ops_full).to(device),
                     torch.from_numpy(valid).to(device), schema)

    def to_host(self) -> tuple[np.ndarray, list[np.ndarray], np.ndarray]:
        """(ops, columns as host values, valid) compacted to visible rows."""
        valid = self.valid.cpu().numpy()
        ops = self.ops.cpu().numpy()[valid]
        out_cols = [_decode_column(f, c, valid)
                    for f, c in zip(self.schema.fields, self.columns)]
        return ops, out_cols, valid

    def to_rows(self) -> list[tuple]:
        """Visible rows as (op, values...) tuples."""
        ops, cols, _ = self.to_host()
        return [(int(ops[i]), *(c[i] for c in cols)) for i in range(len(ops))]

    def __repr__(self) -> str:
        return f"Chunk(cap={self.capacity}, schema={list(self.schema.fields)})"


def encode_strings(values: Sequence, width: int) -> tuple[np.ndarray, np.ndarray]:
    """Encode python strings/bytes to fixed-width (bytes, lens) arrays."""
    n = len(values)
    data = np.zeros((n, width), np.uint8)
    lens = np.zeros(n, np.int32)
    for i, v in enumerate(values):
        b = v if isinstance(v, (bytes, bytearray)) else str(v).encode("utf-8")
        b = b[:width]
        data[i, : len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    return data, lens


def decode_strings(data: np.ndarray, lens: np.ndarray) -> np.ndarray:
    out = np.empty(len(lens), object)
    for i in range(len(lens)):
        out[i] = bytes(data[i, : lens[i]]).decode("utf-8", "replace")
    return out


def apply_null_mask(out: np.ndarray, nulls: np.ndarray | None) -> np.ndarray:
    """Replace masked entries of a decoded host column with None."""
    if nulls is None or not nulls.any():
        return out
    out = np.asarray(list(out), object)
    out[nulls] = None
    return out


def _encode_column(f: Field, arr: np.ndarray, cap: int, device):
    t = f.data_type
    null_mask = None
    if arr.dtype == object:
        nulls = np.asarray([v is None for v in arr], np.bool_)
        if nulls.any():
            if not f.nullable:
                raise ValueError(f"NULL value for NOT NULL column {f.name!r}")
            null_mask = np.zeros(cap, np.bool_)
            null_mask[: len(arr)] = nulls
            fill = "" if t.is_string else 0
            repl = [fill if v is None else v for v in arr]
            arr = np.asarray(repl, object) if t.is_string else np.asarray(repl)
        elif not t.is_string:
            arr = np.asarray(list(arr))
    if t.is_string:
        data, lens = encode_strings(list(arr), f.str_width)
        full = np.zeros((cap, f.str_width), np.uint8)
        full[: len(arr)] = data
        lfull = np.zeros(cap, np.int32)
        lfull[: len(arr)] = lens
        col = StrCol(torch.from_numpy(full).to(device),
                     torch.from_numpy(lfull).to(device))
    else:
        from risingwave_tpu_torch.common.types import NUMPY_DTYPE
        dtype = np.dtype(NUMPY_DTYPE[t.physical_dtype])
        if t == DataType.DECIMAL:
            arr = np.round(arr.astype(np.float64) * 10**f.decimal_scale
                           ).astype(np.int64)
        full = np.zeros(cap, dtype)
        full[: len(arr)] = arr.astype(dtype)
        col = torch.from_numpy(full).to(device)
    if null_mask is not None or f.nullable:
        mask = null_mask if null_mask is not None else np.zeros(cap, np.bool_)
        return NCol(col, torch.from_numpy(mask).to(device))
    return col


def _decode_column(f: Field, col, valid: np.ndarray) -> np.ndarray:
    t = f.data_type
    col, null = split_col(col)
    if isinstance(col, StrCol):
        out = decode_strings(col.data.cpu().numpy()[valid],
                             col.lens.cpu().numpy()[valid])
    else:
        arr = col.cpu().numpy()[valid]
        if t == DataType.DECIMAL:
            out = arr.astype(np.float64) / 10**f.decimal_scale
        elif t == DataType.BOOLEAN:
            out = arr.astype(bool)
        else:
            out = arr
    if null is not None:
        out = apply_null_mask(out, null.cpu().numpy()[valid])
    return out
