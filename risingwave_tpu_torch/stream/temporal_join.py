"""Temporal join: a stream probes a table's current state at process time.

Port of ``risingwave_tpu/stream/temporal_join.py``: ``TjState`` and
``TemporalJoinExecutor`` (inner and left outer), ``stream JOIN t FOR
SYSTEM_TIME AS OF PROCTIME() ON key = t.pk``.  Later changes to the
build table do not retract earlier outputs, so the output is
append-only whenever the probe side is.

The build side is a ``MaterializeExecutor`` (K3's ``lookup_or_insert``
and K8's ``mv_upsert``, in place); its ``maybe_rehash`` runs at
maintenance.  The planner requires the keys to cover the build side's
primary key, so a probe row matches at most one build row and the
output chunk has the probe chunk's capacity.  A probe chunk is kernel
K22a (``csrc/temporal_probe.cu``, ``temporal_probe_cuda``): each row's
pk lookup, the gather of every build value leaf at the found slot, the
output's valid and NULL planes, and the probe-bound overflow count,
added in place to ``TjState.overflow``; ``temporal_probe_plain`` is its
plain version (the port's ``lookup_counted`` plus gathers).  The probe's
first slots come from K1 (``hash64``).

Where the reference builds a new state, the port updates the counters in
place: a right-side chunk copies the build table's overflow into
``TjState.overflow`` (the reference's ``TjState(right, right.overflow,
...)``), a left-side chunk adds its overflow to it.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from risingwave_tpu_torch import kernels
from risingwave_tpu_torch.common.chunk import Chunk, NCol, StrCol, split_col
from risingwave_tpu_torch.common.hash import (
    hash64_columns_cuda,
    key_leaves,
    leaf_width,
)
from risingwave_tpu_torch.common.types import Schema
from risingwave_tpu_torch.state.hash_table import HashTable, gather_key
from risingwave_tpu_torch.stream.materialize import (
    MaterializeExecutor,
    MvState,
)


class TjState(NamedTuple):
    right: MvState
    overflow: torch.Tensor       # int64: build-table and probe-bound loss
    inconsistency: torch.Tensor  # int64


# ---------------------------------------------------------------------------
# K22a: temporal_probe


def _gathered(store, safe: torch.Tensor, miss, left_outer: bool):
    """One build column gathered at ``safe``; a left outer join's NULL
    plane is ``miss | null``."""
    col = gather_key(store, safe)
    if not left_outer:
        return col
    data, null = split_col(col)
    return NCol(data, miss if null is None else (null | miss))


def temporal_probe_plain(table: HashTable, values: tuple, keys: list,
                         key_nulls: list, valid: torch.Tensor,
                         overflow: torch.Tensor, left_outer: bool):
    """Plain PyTorch version of K22a: ``(right columns, out valid)``;
    the probe-bound overflow is added to ``overflow`` in place.  The
    lookup is ``lookup_counted``'s plain probe on any device."""
    live = valid
    for n in key_nulls:
        if n is not None:
            live = live & ~n
    _, slots, found, _, n_over = table._probe_plain(keys, live, insert=False)
    safe = torch.clamp(slots, max=table.size - 1).to(torch.int64)
    found = found & live
    miss = ~found
    cols = [_gathered(store, safe, miss, left_outer) for store in values]
    overflow.add_(n_over)
    return cols, (valid if left_outer else valid & found)


class _TjArgs(ctypes.Structure):
    """Mirror of ``struct TemporalProbeArgs`` in
    ``csrc/temporal_probe.cu``."""

    _fields_ = [
        ("keys", kernels.RwCols), ("vals", kernels.RwCols),
        ("key_null", ctypes.c_void_p * kernels.MAX_COLS),
        ("start", ctypes.c_void_p), ("valid", ctypes.c_void_p),
        ("occupied", ctypes.c_void_p), ("tombstone", ctypes.c_void_p),
        ("out_valid", ctypes.c_void_p), ("overflow", ctypes.c_void_p),
        ("cap", ctypes.c_int), ("size", ctypes.c_int),
        ("max_iters", ctypes.c_int), ("left_outer", ctypes.c_int),
    ]


def _empty_out(store, cap: int, left_outer: bool, dev):
    """An uninitialised output column shaped like a build column (a left
    outer join's always carries a NULL plane)."""
    data, null = split_col(store)
    if isinstance(data, StrCol):
        out = StrCol(torch.empty((cap,) + data.data.shape[1:],
                                 dtype=torch.uint8, device=dev),
                     torch.empty(cap, dtype=torch.int32, device=dev))
    else:
        out = torch.empty(cap, dtype=data.dtype, device=dev)
    if null is not None or left_outer:
        return NCol(out, torch.empty(cap, dtype=torch.bool, device=dev))
    return out


def temporal_probe_cuda(table: HashTable, values: tuple, keys: list,
                        key_nulls: list, valid: torch.Tensor,
                        overflow: torch.Tensor, left_outer: bool,
                        start: torch.Tensor | None = None):
    """K22a (``csrc/temporal_probe.cu``): one launch after K1's hash
    (``start``, the first slots, when the caller has them); the overflow
    is added to ``overflow`` on the card."""
    cap = valid.shape[0]
    dev = valid.device
    if start is None:
        _, start = hash64_columns_cuda(keys, table.size)
    in_leaves = key_leaves(keys)
    st_leaves = key_leaves(table.key_cols)
    if len(in_leaves) != len(st_leaves):
        raise ValueError("key column count differs from the table's")
    a = _TjArgs()
    keep = []
    for k, ((d, _, kind), (sd, snl, _)) in enumerate(zip(in_leaves,
                                                         st_leaves)):
        d = d.contiguous()
        if d.dtype != sd.dtype or d.shape[1:] != sd.shape[1:]:
            raise ValueError(f"key column {k}: {d.dtype} probe column "
                             f"against a {sd.dtype} key store")
        a.keys.width[k], a.keys.kind[k] = leaf_width(d), kind
        a.keys.in_data[k], a.keys.st_data[k] = d.data_ptr(), sd.data_ptr()
        keep += [d, sd]
        if snl is not None:
            # a nullable pk: the probe payloads compare as non-NULL
            zero = torch.zeros(cap, dtype=torch.uint8, device=dev)
            snu8 = snl.view(torch.uint8)
            a.keys.in_null[k], a.keys.st_null[k] = (zero.data_ptr(),
                                                    snu8.data_ptr())
            keep += [zero, snu8]
    a.keys.n = len(in_leaves)
    leaf = 0
    for col, n in zip(keys, key_nulls):
        if n is not None:  # on the key's first leaf
            nu8 = n.contiguous().view(torch.uint8)
            a.key_null[leaf] = nu8.data_ptr()
            keep.append(nu8)
        leaf += 2 if isinstance(col, StrCol) else 1
    outs = [_empty_out(store, cap, left_outer, dev) for store in values]
    k = 0
    for store, out in zip(values, outs):
        sdata, snull = split_col(store)
        odata, onull = split_col(out)
        pairs = ([(sdata.data, odata.data), (sdata.lens, odata.lens)]
                 if isinstance(sdata, StrCol) else [(sdata, odata)])
        for j, (s, o) in enumerate(pairs):
            if k >= kernels.MAX_COLS:
                raise ValueError(f"more than {kernels.MAX_COLS} value "
                                 "leaves (K22a)")
            a.vals.width[k] = leaf_width(s)
            a.vals.in_data[k], a.vals.st_data[k] = s.data_ptr(), o.data_ptr()
            keep += [s, o]
            if j == 0 and onull is not None:
                ou8 = onull.view(torch.uint8)
                a.vals.st_null[k] = ou8.data_ptr()
                keep.append(ou8)
                if snull is not None:
                    su8 = snull.view(torch.uint8)
                    a.vals.in_null[k] = su8.data_ptr()
                    keep.append(su8)
            k += 1
    a.vals.n = k
    valid_u8 = valid.contiguous().view(torch.uint8)
    out_valid = torch.empty(cap, dtype=torch.bool, device=dev)
    occ_u8 = table.occupied.view(torch.uint8)
    tomb_u8 = table.tombstone.view(torch.uint8)
    kernels.require_cuda("temporal_probe", start, valid_u8, occ_u8, tomb_u8,
                         out_valid, overflow, *keep)
    if overflow.dtype != torch.int64 or overflow.dim() != 0:
        raise ValueError("temporal_probe: overflow must be an int64 scalar")
    a.start, a.valid = start.data_ptr(), valid_u8.data_ptr()
    a.occupied, a.tombstone = occ_u8.data_ptr(), tomb_u8.data_ptr()
    a.out_valid, a.overflow = out_valid.data_ptr(), overflow.data_ptr()
    a.cap, a.size = cap, table.size
    a.max_iters = min(table.size + 2, 1024)
    a.left_outer = int(left_outer)
    fn = kernels.entry("temporal_probe", "rw_temporal_probe",
                       [_TjArgs, ctypes.c_void_p])
    kernels.count_launch("temporal_probe")
    kernels.check(fn(a, kernels.stream_ptr(dev)), "temporal_probe")
    return outs, out_valid


def temporal_probe(table: HashTable, values: tuple, keys: list,
                   key_nulls: list, valid: torch.Tensor,
                   overflow: torch.Tensor, left_outer: bool):
    """K22a: ``(right columns, out valid)`` of a probe; CUDA tensors
    launch the kernel, CPU tensors take the plain version."""
    impl = temporal_probe_cuda if valid.device.type == "cuda" \
        else temporal_probe_plain
    return impl(table, values, keys, key_nulls, valid, overflow, left_outer)


# ---------------------------------------------------------------------------


class TemporalJoinExecutor:
    """Two-input executor driven by ``apply(state, chunk, side)``:
    ``"right"`` upserts the build table and emits nothing, ``"left"``
    probes it and emits the joined chunk."""

    def __init__(self, left_schema: Schema, right_schema: Schema,
                 left_keys: Sequence, right_pk: Sequence[int],
                 table_size: int = 1 << 12, join_type: str = "inner"):
        if join_type not in ("inner", "left_outer"):
            raise ValueError("temporal join supports inner/left_outer")
        self.left_schema = left_schema
        self.left_keys = tuple(left_keys)
        self.join_type = join_type
        self.right_mat = MaterializeExecutor(right_schema, tuple(right_pk),
                                             table_size)
        pad = join_type == "left_outer"
        fields = list(left_schema) + [
            f.with_nullable() if pad and not f.nullable else f
            for f in right_schema]
        self._out_schema = Schema(tuple(fields))

    @property
    def out_schema(self) -> Schema:
        return self._out_schema

    def cuda_refusal(self) -> str | None:
        """Why K22a (and the build side's K3/K8) cannot run this join on
        the card, or None."""
        right = self.right_mat.in_schema
        # a string is two leaves: its bytes and its lengths
        n = sum(2 if f.data_type.is_string else 1 for f in right)
        if n > kernels.MAX_COLS:
            return (f"a temporal join build row of {n} value leaves (K22a "
                    f"takes {kernels.MAX_COLS})")
        for key, pk in zip(self.left_keys, self.right_mat.pk_indices):
            lf, rf = key.return_field(self.left_schema), right[pk]
            if lf.data_type.physical_dtype != rf.data_type.physical_dtype \
                    or (rf.data_type.is_string
                        and lf.str_width != rf.str_width):
                return (f"a temporal join key of {lf.data_type.value} "
                        f"against a {rf.data_type.value} PRIMARY KEY column "
                        "(K22a compares keys of one type and width)")
        return None

    def init_state(self, device) -> TjState:
        return TjState(
            self.right_mat.init_state(device),
            torch.zeros((), dtype=torch.int64, device=device),
            torch.zeros((), dtype=torch.int64, device=device))

    def maybe_rehash(self, state: TjState) -> TjState:
        return TjState(self.right_mat.maybe_rehash(state.right),
                       state.overflow, state.inconsistency)

    def apply_idle_right(self, state: TjState) -> TjState:
        """What a right-side chunk without visible rows does: the build
        table is unchanged, and its overflow is copied."""
        state.overflow.copy_(state.right.overflow)
        return state

    def apply(self, state: TjState, chunk: Chunk, side: str):
        if side == "right":
            right, _ = self.right_mat.apply(state.right, chunk)
            state.overflow.copy_(right.overflow)
            return TjState(right, state.overflow, state.inconsistency), None
        keys, key_nulls = [], []
        for k in self.left_keys:
            d, null = split_col(k.eval(chunk))
            keys.append(d)
            key_nulls.append(null)
        right_cols, out_valid = temporal_probe(
            state.right.table, state.right.values, keys, key_nulls,
            chunk.valid, state.overflow, self.join_type == "left_outer")
        out = Chunk(tuple(chunk.columns) + tuple(right_cols), chunk.ops,
                    out_valid, self._out_schema)
        return state, out

    def __repr__(self):
        return (f"TemporalJoin({self.join_type}, "
                f"keys={len(self.left_keys)})")
