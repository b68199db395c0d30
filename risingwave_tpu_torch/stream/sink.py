"""SinkExecutor: buffer the changelog on the device, deliver at barriers.

Port of ``risingwave_tpu/stream/sink.py``: ``SinkState`` and
``SinkExecutor`` (``__init__`` :45, ``init_state`` :52, ``apply`` :63,
``deliver`` :83).

``apply`` appends the chunk's changelog (ops and rows) to a device ring
and never reads anything back: the cursor stays a device scalar.  On the
card it is kernel K22b (``csrc/sink_ring.cu``, ``sink_append_cuda``):
the visible rows, compacted in row order, go to ring positions
``(cursor + rank) % ring_size`` with their ops, and the cursor advances
by their count; ``sink_append_plain`` is its plain version.  Invalid
rows write nothing (the reference's ``mode="drop"``).  The ring is
updated IN PLACE.

``deliver`` is the host hook the runtime calls at a snapshot barrier: it
gathers positions ``[read_cursor, cursor)`` on the device, brings them
to the host in one copy (never the whole ring), decodes strings, NULLs
and DECIMAL as the reference does, hands the rows to the connector
``Sink`` and commits the epoch.  ``read_cursor`` is checkpointed state
(a host attribute would reset on restart and re-deliver the retained
ring).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from risingwave_tpu_torch import kernels
from risingwave_tpu_torch.common.chunk import (
    Chunk,
    StrCol,
    apply_null_mask,
    decode_strings,
    split_col,
)
from risingwave_tpu_torch.common.compact import mask_indices
from risingwave_tpu_torch.common.types import DataType, Schema
from risingwave_tpu_torch.stream.executor import Executor
from risingwave_tpu_torch.stream.materialize import (
    empty_value_col,
    value_leaves,
)


class SinkState(NamedTuple):
    values: tuple             # [ring] column stores
    ops: torch.Tensor         # int8 [ring]
    cursor: torch.Tensor      # int64: rows written (total)
    overflow: torch.Tensor    # int64: stays 0, as in the reference
    #: rows already delivered to the connector: PART OF THE CHECKPOINT
    read_cursor: torch.Tensor  # int64


# ---------------------------------------------------------------------------
# K22b: sink_append


def _planes(values: tuple, ops_store: torch.Tensor, chunk: Chunk) -> list:
    """(store, input) pairs of every fixed-width plane a row writes: each
    value leaf, its null plane, and the op last."""
    out = []
    for store, col in zip(values, chunk.columns):
        for (sd, sn), (d, n) in zip(value_leaves(store), value_leaves(col)):
            out.append((sd, d))
            if sn is not None:
                out.append((sn, n))
    out.append((ops_store, chunk.ops))
    return out


def sink_append_plain(values: tuple, ops_store: torch.Tensor,
                      cursor: torch.Tensor, chunk: Chunk,
                      ring_size: int) -> None:
    """Plain PyTorch version of kernel K22b, in place: the visible rows,
    compacted in order, and their ops go to ring positions ``(cursor +
    rank) % ring_size``; the cursor advances by their count.

    The first ``min(cap, ring_size)`` positions after the cursor are
    written, those past the visible rows with their own current values,
    so the write is one duplicate-free ``index_copy_`` a plane and the
    host never reads the row count.  (A chunk of more visible rows than
    the ring laps within itself; ``deliver`` then raises.)"""
    cap = chunk.capacity
    k_n = min(cap, ring_size)
    dev = chunk.device
    idx = mask_indices(chunk.valid, k_n, cap).to(torch.int64)
    n = chunk.cardinality()
    k = torch.arange(k_n, dtype=torch.int64, device=dev)
    pos = (cursor + k) % ring_size
    fresh = k < n
    src = torch.clamp(idx, max=cap - 1)
    for sd, d in _planes(values, ops_store, chunk):
        keep = fresh.view(-1, *([1] * (d.dim() - 1)))
        sd.index_copy_(0, pos, torch.where(keep, d[src], sd[pos]))
    cursor.add_(n)


class _SinkPlanes(ctypes.Structure):
    """Mirror of ``struct SinkPlanes`` in ``csrc/sink_ring.cu``."""

    _fields_ = [
        ("n", ctypes.c_int),
        ("words", ctypes.c_int * 33),
        ("word_bytes", ctypes.c_int * 33),
        ("start", ctypes.c_longlong * 34),
        ("src", ctypes.c_void_p * 33),
        ("dst", ctypes.c_void_p * 33),
    ]


#: most planes one launch takes: MAX_COLS value leaves, their null
#: planes and the op
MAX_PLANES = 2 * kernels.MAX_COLS + 1
#: ring positions per block of the rank passes (MI_TILE in rw_compact.cuh)
_MI_TILE = 1024


def _word_bytes(row_bytes: int, *ptrs: int) -> int:
    """The widest word (16, 8, 4, 2 or 1 bytes) that divides the row and
    every pointer's alignment."""
    for w in (16, 8, 4, 2):
        if row_bytes % w == 0 and all(p % w == 0 for p in ptrs):
            return w
    return 1


def sink_append_cuda(values: tuple, ops_store: torch.Tensor,
                     cursor: torch.Tensor, chunk: Chunk,
                     ring_size: int) -> None:
    """Kernel K22b (``csrc/sink_ring.cu``): K7's two rank passes, then one
    grid launch copying every plane of the visible rows in 16/8-byte
    words (it also advances the cursor); in place, no host read."""
    planes = _planes(values, ops_store, chunk)
    if len(planes) > MAX_PLANES:
        raise ValueError(f"a sink row of more than {kernels.MAX_COLS} "
                         "value leaves")
    cap = chunk.capacity
    desc = _SinkPlanes()
    keep = []
    start = 0
    for i, (sd, d) in enumerate(planes):
        d = d.contiguous()
        if d.dtype == torch.bool:
            d, sd = d.view(torch.uint8), sd.view(torch.uint8)
        row = d.element_size() * (d.shape[1] if d.dim() > 1 else 1)
        w = _word_bytes(row, d.data_ptr(), sd.data_ptr())
        keep += [sd, d]
        desc.words[i] = row // w
        desc.word_bytes[i] = w
        desc.start[i] = start
        desc.src[i], desc.dst[i] = d.data_ptr(), sd.data_ptr()
        start += cap * (row // w)
    desc.n = len(planes)
    desc.start[len(planes)] = start
    valid_u8 = chunk.valid.contiguous().view(torch.uint8)
    dev = valid_u8.device
    counts = torch.empty(-(-cap // _MI_TILE), dtype=torch.int32, device=dev)
    idx = torch.empty(cap, dtype=torch.int32, device=dev)
    meta = torch.empty(2, dtype=torch.int64, device=dev)
    kernels.require_cuda("sink_ring", valid_u8, cursor, counts, idx, meta,
                         *keep)
    fn = kernels.entry("sink_ring", "rw_sink_append", [
        _SinkPlanes, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p])
    kernels.count_launch("sink_ring")
    kernels.check(fn(desc, valid_u8.data_ptr(), cap, cursor.data_ptr(),
                     ring_size, counts.data_ptr(), idx.data_ptr(),
                     meta.data_ptr(), kernels.stream_ptr(dev)),
                  "sink_ring")


def sink_append(values: tuple, ops_store: torch.Tensor, cursor: torch.Tensor,
                chunk: Chunk, ring_size: int) -> None:
    """In-place changelog append; CUDA tensors launch kernel K22b."""
    impl = sink_append_cuda if chunk.device.type == "cuda" \
        else sink_append_plain
    impl(values, ops_store, cursor, chunk, ring_size)


# ---------------------------------------------------------------------------


class SinkExecutor(Executor):
    emits_on_apply = False
    emits_on_flush = False

    def __init__(self, in_schema: Schema, sink, ring_size: int = 1 << 16):
        super().__init__(in_schema)
        if ring_size & (ring_size - 1):
            raise ValueError("ring_size must be a power of two")
        self.sink = sink
        self.ring_size = ring_size

    def cuda_refusal(self) -> str | None:
        """Why K22b cannot append this sink's rows on the card, or None
        (a string is two value leaves: its bytes and its lengths)."""
        n = sum(2 if f.data_type.is_string else 1 for f in self.in_schema)
        if n > kernels.MAX_COLS:
            return (f"a sink row of {n} value leaves (K22b takes "
                    f"{kernels.MAX_COLS})")
        return None

    def init_state(self, device) -> SinkState:
        def zero():
            return torch.zeros((), dtype=torch.int64, device=device)

        return SinkState(
            tuple(empty_value_col(f, self.ring_size, device)
                  for f in self.in_schema),
            torch.zeros(self.ring_size, dtype=torch.int8, device=device),
            zero(), zero(), zero())

    def apply(self, state: SinkState, chunk: Chunk):
        """Append the visible rows and their ops at the cursor, in place
        (ring, ops and cursor)."""
        sink_append(state.values, state.ops, state.cursor, chunk,
                    self.ring_size)
        return state, None

    # -- host barrier hook ----------------------------------------------
    def deliver(self, state: SinkState, epoch: int,
                commit: bool = True) -> SinkState:
        """Drain the new rows to the connector and commit the epoch (with
        ``commit=False`` the epoch's commit marker is left to the
        caller)."""
        total, read = torch.stack([state.cursor,
                                   state.read_cursor]).tolist()
        n = total - read
        if n > self.ring_size:
            # ring lapped: the oldest rows are lost — surface loudly
            raise RuntimeError(
                f"sink ring lapped ({n - self.ring_size} rows lost) — "
                "increase ring_size or checkpoint more often")
        if n > 0:
            ops, cols = self._gather_host(state, read, n)
            rows = list(zip(*cols))
            self.sink.write_batch(self.in_schema.names(), ops, rows)
            state.read_cursor.fill_(total)
        if commit:
            self.sink.commit(epoch)
        return state

    def _gather_host(self, state: SinkState, read: int, n: int):
        """(ops, decoded columns) of ring positions ``[read, read + n)``:
        gathered on the device, one device-to-host copy of their bytes."""
        dev = state.ops.device
        sel = torch.arange(read, read + n, dtype=torch.int64,
                           device=dev) % self.ring_size
        leaves = [state.ops]
        for store in state.values:
            data, null = split_col(store)
            leaves += [data.data, data.lens] if isinstance(data, StrCol) \
                else [data]
            if null is not None:
                leaves.append(null)
        picked = [x[sel] for x in leaves]
        flat = [(x.view(torch.uint8) if x.dtype == torch.bool else x)
                .contiguous().view(torch.uint8).reshape(-1) for x in picked]
        buf = torch.cat(flat).cpu().numpy()
        host = []
        off = 0
        for x in picked:
            nb = x.numel() * x.element_size()
            dt = np.bool_ if x.dtype == torch.bool else \
                torch.empty((), dtype=x.dtype).numpy().dtype
            host.append(buf[off:off + nb].view(dt).reshape(tuple(x.shape)))
            off += nb
        it = iter(host[1:])
        cols = []
        for f, store in zip(self.in_schema, state.values):
            data, null = split_col(store)
            if isinstance(data, StrCol):
                bytes_, lens = next(it), next(it)
                out = decode_strings(bytes_, lens)
            else:
                out = next(it)
                if f.data_type == DataType.DECIMAL:
                    out = out.astype(np.float64) / 10**f.decimal_scale
            if null is not None:
                out = apply_null_mask(out, next(it))
            cols.append(out)
        return host[0], cols
