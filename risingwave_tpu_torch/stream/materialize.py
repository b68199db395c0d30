"""Materialize executors: maintain an MV's table from its changelog.

Port of ``risingwave_tpu/stream/materialize.py``:

- ``MaterializeExecutor`` (:82-195): a ``HashTable`` on the pk plus
  dense value tensors.  A chunk applies as one probe (kernel B) and one
  upsert (kernel D, ``mv_upsert``) in which the last op in row order
  wins per pk.
- ``AppendOnlyMaterialize`` (:201-266): a ring of rows + a cursor for
  pk-less append-only MVs.  On the card a chunk appends in one launch of
  kernel K8-ring (``csrc/compact.cu``, ``rw_ring_append``): a grid of
  row tiles, each taking its base by decoupled look-back.

MV state is updated IN PLACE (table, value stores, ring): a chunk never
copies a table-sized tensor.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import numpy as np
import torch

from risingwave_tpu_torch import kernels
from risingwave_tpu_torch.common.chunk import (
    Chunk,
    NCol,
    OP_DELETE,
    OP_INSERT,
    OP_UPDATE_DELETE,
    OP_UPDATE_INSERT,
    StrCol,
    apply_null_mask,
    decode_strings,
    split_col,
)
from risingwave_tpu_torch.common.compact import mask_indices
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.state.hash_table import HashTable, permute_dense
from risingwave_tpu_torch.stream.executor import Executor


def empty_value_col(f: Field, size: int, device):
    if f.data_type.is_string:
        col = StrCol(torch.zeros((size, f.str_width), dtype=torch.uint8,
                                 device=device),
                     torch.zeros(size, dtype=torch.int32, device=device))
    else:
        col = torch.zeros(size, dtype=f.data_type.physical_dtype,
                          device=device)
    if f.nullable:
        return NCol(col, torch.zeros(size, dtype=torch.bool, device=device))
    return col


def value_leaves(col) -> list[tuple[torch.Tensor, torch.Tensor | None]]:
    """A column value as fixed-width (data, null-or-None) leaves."""
    data, null = split_col(col)
    if isinstance(data, StrCol):
        return [(data.data, null), (data.lens, null)]
    return [(data, null)]


class MvState(NamedTuple):
    table: HashTable
    values: tuple            # dense [size] stores, one per output column
    overflow: torch.Tensor   # int64 scalar


# ---------------------------------------------------------------------------
# kernel D: mv_upsert


class _MvArgs(ctypes.Structure):
    """Mirror of ``struct MvArgs`` in ``csrc/mv_upsert.cu``."""

    _fields_ = [
        ("values", kernels.RwCols),
        ("slots", ctypes.c_void_p), ("valid", ctypes.c_void_p),
        ("ops", ctypes.c_void_p), ("last_del", ctypes.c_void_p),
        ("last_ins", ctypes.c_void_p), ("occupied", ctypes.c_void_p),
        ("tombstone", ctypes.c_void_p),
        ("cap", ctypes.c_int), ("size", ctypes.c_int),
    ]


def _set_rows_(store, pos: torch.Tensor, col, rows: torch.Tensor) -> None:
    """In place: ``store[pos] = col[rows]`` for every leaf."""
    for (sd, sn), (d, n) in zip(value_leaves(store), value_leaves(col)):
        sd[pos] = d[rows]
        if sn is not None:
            sn[pos] = n[rows]


def mv_upsert_plain(table: HashTable, values: tuple, chunk: Chunk,
                    slots: torch.Tensor) -> None:
    """Plain PyTorch version of kernel D, in place: per pk slot the
    last op in row order wins (a scatter-max of the row index per side);
    a winning delete tombstones the slot, the winning insert row sets
    it and writes its values."""
    size = table.size
    cap = slots.shape[0]
    dev = slots.device
    ops = chunk.ops
    del_rows = chunk.valid & ((ops == OP_DELETE) | (ops == OP_UPDATE_DELETE))
    ins_rows = chunk.valid & ((ops == OP_INSERT) | (ops == OP_UPDATE_INSERT))
    row_idx = torch.arange(cap, dtype=torch.int32, device=dev)
    sentinel = torch.full_like(slots, size)

    def last(rows):
        out = torch.full((size + 1,), -1, dtype=torch.int32, device=dev)
        out.scatter_reduce_(
            0, torch.where(rows, slots, sentinel).to(torch.int64),
            torch.where(rows, row_idx, torch.full_like(row_idx, -1)),
            reduce="amax")
        return out[:size]

    last_del, last_ins = last(del_rows), last(ins_rows)
    safe = torch.clamp(slots, max=size - 1).to(torch.int64)
    del_wins = del_rows & (last_del[safe] > last_ins[safe])
    table.clear_slots(slots, del_wins)
    is_last = ins_rows & (last_ins[safe] == row_idx) & (
        last_ins[safe] > last_del[safe]) & (slots < size)
    pos = slots[is_last].to(torch.int64)
    table.occupied[pos] = True
    table.tombstone[pos] = False
    for store, col in zip(values, chunk.columns):
        _set_rows_(store, pos, col, is_last)


def mv_upsert_cuda(table: HashTable, values: tuple, chunk: Chunk,
                   slots: torch.Tensor, scratch) -> None:
    """Kernel D (``csrc/mv_upsert.cu``): three launches, in place.

    ``scratch`` is the executor's (last_del, last_ins) int32 [size]
    pair, all -1 between calls."""
    args = _MvArgs()
    cols = args.values
    keep = []
    k = 0
    for store, col in zip(values, chunk.columns):
        for (sd, sn), (d, n) in zip(value_leaves(store), value_leaves(col)):
            if k >= kernels.MAX_COLS:
                raise ValueError(f"more than {kernels.MAX_COLS} value leaves")
            d = d.contiguous()
            nu8 = None if n is None else n.contiguous().view(torch.uint8)
            snu8 = None if sn is None else sn.view(torch.uint8)
            keep += [t for t in (sd, d, nu8, snu8) if t is not None]
            cols.width[k] = d.element_size() * (d.shape[1] if d.dim() > 1
                                                else 1)
            cols.in_data[k], cols.st_data[k] = d.data_ptr(), sd.data_ptr()
            cols.in_null[k] = kernels.ptr(nu8)
            cols.st_null[k] = kernels.ptr(snu8)
            k += 1
    cols.n = k
    slots = slots.contiguous()
    valid_u8 = chunk.valid.contiguous().view(torch.uint8)
    ops = chunk.ops.contiguous()
    last_del, last_ins = scratch
    occ_u8 = table.occupied.view(torch.uint8)
    tomb_u8 = table.tombstone.view(torch.uint8)
    kernels.require_cuda("mv_upsert", slots, valid_u8, ops, last_del,
                         last_ins, occ_u8, tomb_u8, *keep)
    args.slots, args.valid, args.ops = (slots.data_ptr(), valid_u8.data_ptr(),
                                        ops.data_ptr())
    args.last_del, args.last_ins = last_del.data_ptr(), last_ins.data_ptr()
    args.occupied, args.tombstone = occ_u8.data_ptr(), tomb_u8.data_ptr()
    args.cap, args.size = slots.shape[0], table.size
    fn = kernels.entry("mv_upsert", "rw_mv_upsert", [_MvArgs, ctypes.c_void_p])
    kernels.count_launch("mv_upsert")
    kernels.check(fn(args, kernels.stream_ptr(slots.device)), "mv_upsert")


def mv_upsert(table: HashTable, values: tuple, chunk: Chunk,
              slots: torch.Tensor, scratch) -> None:
    """In-place pk upsert; CUDA tensors launch kernel D."""
    if slots.device.type == "cuda":
        mv_upsert_cuda(table, values, chunk, slots, scratch)
    else:
        mv_upsert_plain(table, values, chunk, slots)


# ---------------------------------------------------------------------------


class MaterializeExecutor(Executor):
    """Upsert the changelog into a pk-keyed device table."""

    emits_on_apply = False
    emits_on_flush = False

    def __init__(self, in_schema: Schema, pk_indices: Sequence[int],
                 table_size: int = 1 << 16):
        super().__init__(in_schema)
        self.pk_indices = tuple(pk_indices)
        self.table_size = table_size
        #: kernel D's (last_del, last_ins) scratch per device
        self._scratch: dict = {}

    def init_state(self, device) -> MvState:
        protos = [empty_value_col(self.in_schema[i], 1, device)
                  for i in self.pk_indices]
        return MvState(
            HashTable.create(protos, self.table_size, device),
            tuple(empty_value_col(f, self.table_size, device)
                  for f in self.in_schema),
            torch.zeros((), dtype=torch.int64, device=device),
        )

    def _scratch_for(self, device):
        s = self._scratch.get(device)
        if s is None:
            s = tuple(torch.full((self.table_size,), -1, dtype=torch.int32,
                                 device=device) for _ in range(2))
            self._scratch[device] = s
        return s

    def apply(self, state: MvState, chunk: Chunk):
        pk_cols = [chunk.column(i) for i in self.pk_indices]
        table, slots, _, overflow = state.table.lookup_or_insert(
            pk_cols, chunk.valid)
        n_over = (overflow & chunk.valid).sum(dtype=torch.int64)
        mv_upsert(table, state.values, chunk, slots,
                  self._scratch_for(slots.device))
        # pass the changelog through (cascaded MVs consume it)
        return MvState(table, state.values, state.overflow + n_over), chunk

    def maybe_rehash(self, state: MvState) -> MvState:
        """Rebuild the pk table once tombstones exceed a quarter of it
        (maintenance-time; reads the tombstone count back)."""
        if int(state.table.tombstone_count()) <= self.table_size // 4:
            return state
        fresh, moved = state.table.rehashed()
        values = tuple(permute_dense(v, moved) for v in state.values)
        return MvState(fresh, values, state.overflow)

    def to_host(self, state: MvState) -> list[tuple]:
        """The MV's rows in slot order (serving read)."""
        occ = state.table.occupied.cpu().numpy()
        cols = []
        for f, store in zip(self.in_schema, state.values):
            cols.append(_host_values(f, store, occ))
        return [tuple(c[i] for c in cols) for i in range(int(occ.sum()))]


def _host_values(f: Field, store, sel) -> np.ndarray:
    store, null = split_col(store)
    if isinstance(store, StrCol):
        out = decode_strings(store.data.cpu().numpy()[sel],
                             store.lens.cpu().numpy()[sel])
    else:
        out = store.cpu().numpy()[sel]
        if f.data_type == DataType.DECIMAL:
            out = out.astype(np.float64) / 10**f.decimal_scale
    if null is not None:
        out = apply_null_mask(out, null.cpu().numpy()[sel])
    return out


# ---------------------------------------------------------------------------
# kernel K8-ring: ring_append


def ring_append_plain(values: tuple, cursor: torch.Tensor,
                      overflow: torch.Tensor, chunk: Chunk,
                      ring_size: int) -> None:
    """Plain PyTorch version of kernel K8-ring, in place: the visible
    rows, compacted in order, go to ring positions ``(cursor + rank) %
    ring_size``; the cursor advances by their count and the rows a lap
    evicts are added to ``overflow``.

    Every one of the ``cap`` positions after the cursor is written, those
    past the visible rows with their own current values, so the write is
    one duplicate-free ``index_copy_`` and the host never reads the row
    count."""
    cap = chunk.capacity
    dev = chunk.device
    idx = mask_indices(chunk.valid, cap, cap).to(torch.int64)
    n = chunk.cardinality()
    k = torch.arange(cap, dtype=torch.int64, device=dev)
    pos = (cursor + k) % ring_size
    fresh = k < n
    src = torch.clamp(idx, max=cap - 1)
    for store, col in zip(values, chunk.columns):
        for (sd, sn), (d, nl) in zip(value_leaves(store), value_leaves(col)):
            keep = fresh.view(-1, *([1] * (d.dim() - 1)))
            sd.index_copy_(0, pos, torch.where(keep, d[src], sd[pos]))
            if sn is not None:
                sn.index_copy_(0, pos, torch.where(fresh, nl[src], sn[pos]))
    lost_before = torch.clamp(cursor - ring_size, min=0)
    lost_after = torch.clamp(cursor + n - ring_size, min=0)
    overflow.add_(lost_after - lost_before)
    cursor.add_(n)


#: rows a tile of K8-ring (``RA_TILE`` in ``csrc/compact.cu``)
_RING_TILE = 256
#: the status words carry the epoch in their top 30 bits
_RING_EPOCHS = 1 << 30
#: (device, stream) -> K8-ring's look-back scratch
#: (``kernels.lookback_scratch``): status words int64 [tiles] and its two
#: tickets int32 [2]
_RING_SCRATCH: dict = {}


class _RingArgs(ctypes.Structure):
    """Mirror of ``struct RingArgs`` in ``csrc/compact.cu``."""

    _fields_ = [
        ("cols", kernels.RwCols), ("valid", ctypes.c_void_p),
        ("cursor", ctypes.c_void_p), ("overflow", ctypes.c_void_p),
        ("status", ctypes.c_void_p), ("ctl", ctypes.c_void_p),
        ("epoch", ctypes.c_ulonglong), ("ring_size", ctypes.c_longlong),
        ("cap", ctypes.c_int), ("n_tiles", ctypes.c_int),
    ]


def _ring_tensors(tiles: int, dev: torch.device) -> tuple:
    return (torch.zeros(tiles, dtype=torch.int64, device=dev),
            torch.zeros(2, dtype=torch.int32, device=dev))


def ring_append_cuda(values: tuple, cursor: torch.Tensor,
                     overflow: torch.Tensor, chunk: Chunk,
                     ring_size: int) -> None:
    """Kernel K8-ring (``csrc/compact.cu``): one launch, in place."""
    args = _RingArgs()
    cols = args.cols
    keep = []
    k = 0
    for store, col in zip(values, chunk.columns):
        leaves = zip(value_leaves(store), value_leaves(col))
        for j, ((sd, sn), (d, n)) in enumerate(leaves):
            if k >= kernels.MAX_COLS:
                raise ValueError(f"more than {kernels.MAX_COLS} value leaves")
            d = d.contiguous()
            # a string's null plane moves once, with its bytes
            nu8 = None if n is None or j else n.contiguous().view(torch.uint8)
            snu8 = None if sn is None or j else sn.view(torch.uint8)
            keep += [t for t in (sd, d, nu8, snu8) if t is not None]
            cols.width[k] = d.element_size() * (d.shape[1] if d.dim() > 1
                                                else 1)
            cols.in_data[k], cols.st_data[k] = d.data_ptr(), sd.data_ptr()
            cols.in_null[k] = kernels.ptr(nu8)
            cols.st_null[k] = kernels.ptr(snu8)
            k += 1
    cols.n = k
    valid_u8 = chunk.valid.contiguous().view(torch.uint8)
    kernels.require_cuda("ring_append", valid_u8, cursor, overflow, *keep)
    tiles = max(1, -(-chunk.capacity // _RING_TILE))
    (status, ctl), epoch = kernels.lookback_scratch(
        _RING_SCRATCH, valid_u8.device, tiles, _RING_EPOCHS, _ring_tensors)
    args.valid = valid_u8.data_ptr()
    args.cursor, args.overflow = cursor.data_ptr(), overflow.data_ptr()
    args.status, args.ctl, args.epoch = (status.data_ptr(), ctl.data_ptr(),
                                         epoch)
    args.ring_size, args.cap, args.n_tiles = (ring_size, chunk.capacity,
                                              tiles)
    fn = kernels.entry("ring_append", "rw_ring_append",
                       [_RingArgs, ctypes.c_void_p])
    kernels.count_launch("ring_append")
    kernels.check(fn(args, kernels.stream_ptr(valid_u8.device)),
                  "ring_append")


def ring_append(values: tuple, cursor: torch.Tensor, overflow: torch.Tensor,
                chunk: Chunk, ring_size: int) -> None:
    """In-place ring append; CUDA tensors launch kernel K8-ring."""
    impl = ring_append_cuda if chunk.device.type == "cuda" \
        else ring_append_plain
    impl(values, cursor, overflow, chunk, ring_size)


class RingState(NamedTuple):
    values: tuple            # [ring_size] column stores
    cursor: torch.Tensor     # int64 — total rows written
    overflow: torch.Tensor   # int64 — rows evicted before being read


class AppendOnlyMaterialize(Executor):
    """Ring-buffer MV for append-only changelogs (no pk conflicts)."""

    emits_on_apply = False
    emits_on_flush = False

    def __init__(self, in_schema: Schema, ring_size: int = 1 << 20):
        super().__init__(in_schema)
        if ring_size & (ring_size - 1):
            raise ValueError("ring_size must be a power of two")
        self.ring_size = ring_size

    def cuda_refusal(self) -> str | None:
        """Why K8-ring cannot append this MV's rows on the card, or None
        (a string is two value leaves: its bytes and its lengths)."""
        n = sum(2 if f.data_type.is_string else 1 for f in self.in_schema)
        if n > kernels.MAX_COLS:
            return (f"an append-only MV row of {n} value leaves (K8-ring "
                    f"takes {kernels.MAX_COLS})")
        return None

    def init_state(self, device) -> RingState:
        return RingState(
            tuple(empty_value_col(f, self.ring_size, device)
                  for f in self.in_schema),
            torch.zeros((), dtype=torch.int64, device=device),
            torch.zeros((), dtype=torch.int64, device=device),
        )

    def apply(self, state: RingState, chunk: Chunk):
        """Append the visible rows at the cursor, in place (values,
        cursor and overflow counter)."""
        if chunk.capacity > self.ring_size:
            raise ValueError("chunk capacity exceeds the ring size")
        ring_append(state.values, state.cursor, state.overflow, chunk,
                    self.ring_size)
        return state, chunk

    def to_host(self, state: RingState, limit: int | None = None) -> list[tuple]:
        total = int(state.cursor)
        n = min(total, self.ring_size if limit is None else limit)
        start = max(total - n, 0)
        sel = (np.arange(start, start + n) % self.ring_size).astype(np.int64)
        cols = [_host_values(f, store, sel)
                for f, store in zip(self.in_schema, state.values)]
        return [tuple(c[i] for c in cols) for i in range(n)]
