"""Hash aggregation executor (device-resident groups, emit on barrier).

Port of the count/sum/min/max path of
``risingwave_tpu/stream/hash_agg.py``: ``apply`` (:368), ``flush``
(:909), ``_outputs``, ``_interleave``, ``on_watermark``, ``clean_below``
and ``maybe_rehash``, with DISTINCT calls (``_distinct_aggs`` :247,
``_distinct_protos`` :300, the dedup of ``apply`` :501-580, ``rehash_d``
:1068-1093 and ``clean_below``'s dedup eviction :1106-1119).

Groups live in a ``HashTable`` plus one ``[size]`` tensor per primitive
state.  ``apply`` takes one of the reference's two branches, chosen by
the device of the chunk (``common.compact.accel_tuned``):

- on the card, the ACCELERATOR branch (hash_agg.py:394-436, :613-641):
  the chunk is hashed (kernel A), sorted by hash, pre-aggregated per
  run of equal keys (kernel K5, ``agg_preagg``; integer and string
  keys), and only each run's representative probes the table (kernel
  B) and scatters the run's partials (kernel C, ``agg_scatter``);
- on the CPU, the PER-ROW branch (hash_agg.py:437-444, :633-644): every
  row probes and scatters its own contribution.

Both are the reference's own branches, so either compares with the
reference slot for slot when the reference takes the same branch.
Input with deletes and updates (a retractable input) goes through
either branch.

``flush`` compacts the dirty slots into ``emit_capacity`` rows (kernel
K7 on the card) and emits U-/U+ pairs against the ``prev`` snapshot,
as the reference does.

State tensors are updated IN PLACE (the table, prims, row_count, dirty,
prev_*, emitted): one chunk or barrier never copies a ``[size]`` tensor.

An aggregation without watermark cleaning (an unbounded key space)
gets a SPILL RING (``spill_ring`` rows, :181, :357-364, :427-481): input
rows whose group cannot claim a slot divert into the ring, in chunk
order, at ``spill_count``; rows the ring cannot hold stay counted in
``overflow``.  The capture never reads the host: on the card it is one
launch of kernel ``agg_spill`` (``csrc/agg_spill.cu``) every chunk, which
writes nothing while no row overflows (the reference's ``lax.cond``).
``drain_spill`` empties the ring into a chunk at snapshot barriers and
``make_spill_tier`` builds the same aggregation for the host tier
(``stream/spill.py``).

A DISTINCT call (min/max are distinct-insensitive and run as plain
calls) keeps a dedup table keyed (group keys..., argument) with an
int64 count per key (``distinct_tables``, ``distinct_counts``).  Per
chunk its eligible rows (valid, not diverted to the spill ring, a
non-NULL argument, passing the FILTER) find or claim their dedup slots
(K1, K3), K13's rank launch picks each key's first row, and kernel K6d
(``csrc/agg_distinct.cu``, ``distinct_dedup``) resets reclaimed slots,
reads each key's count before and after the chunk, and writes the
+1/-1 transition sign at the first row, the overflow and
negative-count counts and the dead keys, which the K4 sweep tombstones.
The transition signs replace the call's changelog signs; on the
pre-aggregation branch a second K5 launch reduces the call's values
over the chunk's runs after the dedup.

min/max over a RETRACTABLE input (``retractable_input=True``) keep a
materialized-input state (reference :231-242, the ``minput.rs``
analog): per such call a ``[size, B]`` value bucket aligned with the
group table's slots and a ``[size, B]`` occupancy plane
(``minput_vals``, ``minput_occ``; ``B = minput_bucket_cap``).  Every row
that counts (a non-NULL value passing the FILTER, in a group that got a
slot) lands in its group's bucket through kernel K6m
(``csrc/agg_minput.cu``, ``minput_update``): in-chunk +v/-v pairs
cancel, deletes clear a value-equal entry by rank, inserts claim free
entries by rank; a full bucket counts into ``overflow`` and a delete of
an absent value into ``inconsistency``.  The call's ``[size]`` state is
then a cache that ``flush`` recomputes for the emitted slots (K6m's
refresh launch), so the U-/U+ machinery is unchanged.

EMIT ON WINDOW CLOSE (``emit_on_window_close``, reference :961-1026):
``flush`` emits final append-only rows for the groups whose window
closed (``key + lag <= wm``), up to ``emit_capacity`` of them in slot
order (kernel K7e, ``csrc/agg_eowc.cu``), and evicts them through the K4
sweep; ``pending_flush`` is the count of closed groups, so the runtime
drains a window larger than the capacity over several rounds.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

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
    conform_col,
    split_col,
)
from risingwave_tpu_torch.common.compact import (
    _MI_TILE as MI_TILE,
    accel_tuned,
    mask_indices,
    segment_start_positions,
    segment_starts,
    segmented_minmax_at_ends,
    segmented_sum,
)
from risingwave_tpu_torch.common.hash import hash64_columns, leaf_width
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.expr.agg import _ADD_COUNT, AggCall, _minmax_init
from risingwave_tpu_torch.expr.node import Expr, InputRef
from risingwave_tpu_torch.state.hash_table import (
    HashTable,
    gather_key,
    keys_equal,
    permute_dense,
)
from risingwave_tpu_torch.stream.executor import Executor
from risingwave_tpu_torch.stream.hash_join import (
    _first_true,
    _group_totals,
    _rank_by,
    bucket_cancel_cuda,
    rank_by,
)
from risingwave_tpu_torch.stream.materialize import (
    empty_value_col,
    value_leaves,
)

INT64_MIN = -(1 << 63)
INT64_MAX = (1 << 63) - 1


class AggState(NamedTuple):
    table: HashTable
    prims: tuple                  # per-primitive state tensors, each [size]
    row_count: torch.Tensor       # int64 [size]
    dirty: torch.Tensor           # bool [size]
    prev_prims: tuple             # snapshot at the last flush
    prev_row_count: torch.Tensor
    emitted: torch.Tensor         # bool [size] — group present downstream
    overflow: torch.Tensor        # int64 scalar — rows lost to a full table
    inconsistency: torch.Tensor   # int64 scalar — deletes hitting min/max
    wm: torch.Tensor              # int64 scalar — latest watermark
    #: per retractable min/max call (reference ``minput.rs``): its
    #: [size, B] values and [size, B] occupancy, slot-aligned with table
    minput_vals: tuple = ()
    minput_occ: tuple = ()
    #: per DISTINCT call: a dedup table keyed (group keys..., argument)
    #: and an int64 [distinct_table_size] row count per key
    distinct_tables: tuple = ()
    distinct_counts: tuple = ()
    #: the spill ring (``()`` without one): input rows whose group found
    #: no slot, drained at snapshot barriers into the host tier
    spill_rows: tuple = ()        # [R] stores, one per input column
    spill_ops: "torch.Tensor | tuple" = ()    # int8 [R]
    spill_count: "torch.Tensor | tuple" = ()  # int32 scalar


# ---------------------------------------------------------------------------
# kernel C: agg_scatter

_MODES = {"add": 0, "min": 1, "max": 2}
_DTYPES = {torch.int64: 0, torch.int32: 1, torch.float64: 2}
MAX_PRIMS = 8


class _AggArgs(ctypes.Structure):
    """Mirror of ``struct AggArgs`` in ``csrc/agg_scatter.cu``."""

    _fields_ = [
        ("n_prims", ctypes.c_int),
        ("mode", ctypes.c_int * MAX_PRIMS),
        ("dtype", ctypes.c_int * MAX_PRIMS),
        ("state", ctypes.c_void_p * MAX_PRIMS),
        ("value", ctypes.c_void_p * MAX_PRIMS),
        ("init_i", ctypes.c_longlong * MAX_PRIMS),
        ("init_f", ctypes.c_double * MAX_PRIMS),
        ("slots", ctypes.c_void_p), ("inserted", ctypes.c_void_p),
        ("signs", ctypes.c_void_p), ("row_count", ctypes.c_void_p),
        ("dirty", ctypes.c_void_p),
        ("cap", ctypes.c_int), ("size", ctypes.c_int),
    ]


def agg_scatter_plain(prims, modes, inits, values, slots, inserted, signs,
                      row_count, dirty) -> None:
    """Plain PyTorch version of kernel C, in place: reset the states of
    freshly claimed slots to ``inits``, then scatter-add/min/max each
    row's ``values[p]`` into ``prims[p]`` at its slot, add ``signs``
    into ``row_count`` and mark the slot dirty.  Sentinel slots
    (``== size``) are dropped."""
    size = row_count.shape[0]
    ins = slots[inserted & (slots < size)].to(torch.int64)
    live = slots < size
    idx = slots[live].to(torch.int64)
    reduce = {"add": "sum", "min": "amin", "max": "amax"}
    for p, mode, init, val in zip(prims, modes, inits, values):
        p[ins] = init
        p.scatter_reduce_(0, idx, val[live].to(p.dtype), reduce=reduce[mode])
    row_count[ins] = 0
    row_count.index_add_(0, idx, signs[live])
    dirty[idx] = True


def agg_scatter_cuda(prims, modes, inits, values, slots, inserted, signs,
                     row_count, dirty) -> None:
    """Kernel C (``csrc/agg_scatter.cu``): two launches, in place."""
    if len(prims) > MAX_PRIMS:
        raise ValueError(f"more than {MAX_PRIMS} primitive states")
    args = _AggArgs()
    args.n_prims = len(prims)
    keep = []
    for k, (p, mode, init, val) in enumerate(zip(prims, modes, inits, values)):
        if p.dtype not in _DTYPES or (p.dtype == torch.float64
                                      and mode != "add"):
            raise NotImplementedError(
                f"{mode} over {p.dtype} states is not ported to CUDA yet")
        val = val.to(p.dtype).contiguous()
        keep += [p, val]
        args.mode[k] = _MODES[mode]
        args.dtype[k] = _DTYPES[p.dtype]
        args.state[k] = p.data_ptr()
        args.value[k] = val.data_ptr()
        if p.dtype == torch.float64:
            args.init_f[k] = float(init)
        else:
            args.init_i[k] = int(init)
    slots = slots.contiguous()
    ins_u8 = inserted.contiguous().view(torch.uint8)
    signs = signs.to(torch.int64).contiguous()
    dirty_u8 = dirty.view(torch.uint8)
    kernels.require_cuda("agg_scatter", slots, ins_u8, signs, row_count,
                         dirty_u8, *keep)
    args.slots, args.inserted = slots.data_ptr(), ins_u8.data_ptr()
    args.signs, args.row_count = signs.data_ptr(), row_count.data_ptr()
    args.dirty = dirty_u8.data_ptr()
    args.cap, args.size = slots.shape[0], row_count.shape[0]
    fn = kernels.entry("agg_scatter", "rw_agg_scatter",
                       [_AggArgs, ctypes.c_void_p])
    kernels.count_launch("agg_scatter")
    kernels.check(fn(args, kernels.stream_ptr(slots.device)), "agg_scatter")


def agg_scatter(prims, modes, inits, values, slots, inserted, signs,
                row_count, dirty) -> None:
    """In-place agg state update; CUDA tensors launch kernel C."""
    impl = agg_scatter_cuda if slots.device.type == "cuda" \
        else agg_scatter_plain
    impl(prims, modes, inits, values, slots, inserted, signs, row_count,
         dirty)


# ---------------------------------------------------------------------------
# kernel K5: agg_preagg


class Preagg(NamedTuple):
    """A chunk pre-aggregated per run of equal keys, in hash order."""

    s_hash: torch.Tensor      # int64 [cap] sorted key hashes
    s_keys: list              # key columns in sorted order
    starts: torch.Tensor      # bool [cap] segment START rows
    perm: torch.Tensor        # int64 [cap] sorted position -> row
    rep: torch.Tensor         # bool [cap] segment END rows that are valid
    seg_rows: torch.Tensor    # int64 [cap] valid rows of the segment
    seg_signs: torch.Tensor   # int64 [cap] sign sum of the segment
    seg_values: list          # per prim: the segment's reduced partial


def sort_by_hash(h: torch.Tensor, valid: torch.Tensor):
    """(sorted keys, perm): a stable sort of the rows by their UNSIGNED
    hash (``h ^ 2^63`` in signed order), invalid rows last under
    ``INT64_MAX`` (no valid row's hash maps there: the hash is never
    all ones)."""
    key = torch.where(valid, h ^ INT64_MIN, torch.full_like(h, INT64_MAX))
    out = torch.sort(key, stable=True)
    return out.values, out.indices


def agg_preagg_plain(sort_key, perm, key_cols, valid, signs, modes, inits,
                     values) -> Preagg:
    """Plain PyTorch version of kernel K5: the reference's segment
    primitives over the hash-sorted chunk.  Segment results stand at
    each segment's END row; other rows hold the identity (0 for counts
    and sums, the prim's init for min/max)."""
    n = sort_key.shape[0]
    dev = sort_key.device
    s_hash = sort_key ^ INT64_MIN
    s_keys = [gather_key(c, perm) for c in key_cols]
    neq = s_hash[1:] != s_hash[:-1]
    nxt = torch.arange(1, n, device=dev)
    cur = torch.arange(0, n - 1, device=dev)
    for c in s_keys:
        neq = neq | ~keys_equal(gather_key(c, nxt), gather_key(c, cur))
    starts = segment_starts(neq)
    ends = torch.cat([neq, torch.ones(1, dtype=torch.bool, device=dev)])
    s_valid = valid[perm]
    start_pos = segment_start_positions(starts)
    seg_id = torch.cumsum(starts.to(torch.int32), 0, dtype=torch.int32)

    def at_ends(seg, ident=0):
        return torch.where(ends, seg, torch.full_like(seg, ident))

    seg_values = []
    for mode, init, val in zip(modes, inits, values):
        contrib = val[perm]
        if mode == "add":
            seg_values.append(at_ends(segmented_sum(contrib, start_pos)))
        else:
            seg_values.append(at_ends(segmented_minmax_at_ends(
                seg_id, contrib, start_pos, mode), init))
    return Preagg(
        s_hash, s_keys, starts, perm, ends & s_valid,
        at_ends(segmented_sum(s_valid.to(torch.int64), start_pos)),
        at_ends(segmented_sum(signs[perm].to(torch.int64), start_pos)),
        seg_values)


class _PreaggArgs(ctypes.Structure):
    """Mirror of ``struct PreaggArgs`` in ``csrc/agg_preagg.cu``."""

    _fields_ = [
        ("keys", kernels.RwCols),
        ("sort_key", ctypes.c_void_p), ("perm", ctypes.c_void_p),
        ("valid", ctypes.c_void_p), ("signs", ctypes.c_void_p),
        ("starts", ctypes.c_void_p), ("s_hash", ctypes.c_void_p),
        ("rep", ctypes.c_void_p), ("seg_rows", ctypes.c_void_p),
        ("seg_signs", ctypes.c_void_p),
        ("n_prims", ctypes.c_int),
        ("mode", ctypes.c_int * MAX_PRIMS),
        ("dtype", ctypes.c_int * MAX_PRIMS),
        ("value", ctypes.c_void_p * MAX_PRIMS),
        ("seg", ctypes.c_void_p * MAX_PRIMS),
        ("init_i", ctypes.c_longlong * MAX_PRIMS),
        ("init_f", ctypes.c_double * MAX_PRIMS),
        ("n", ctypes.c_int),
        ("status", ctypes.c_void_p), ("carry", ctypes.c_void_p),
        ("epoch", ctypes.c_ulonglong),
    ]


#: rows a tile of K5 (``PA_TILE`` in ``csrc/agg_preagg.cu``) and the values
#: a tile publishes for the look-back (``PA_MAXQ``: rows, signs and
#: MAX_PRIMS primitives)
_PREAGG_TILE = 512
_PREAGG_MAXQ = 2 + MAX_PRIMS
#: the status words carry the epoch above their low 8 bits
_PREAGG_EPOCHS = 1 << 56
#: (device, stream) -> K5's look-back scratch (``kernels.lookback_scratch``)
#: for up to p tiles: status int64 [p] and carry int64 [p * 2 * PA_MAXQ]
_PREAGG_SCRATCH: dict = {}


def _preagg_tensors(p: int, dev: torch.device) -> tuple:
    return (torch.zeros(p, dtype=torch.int64, device=dev),
            torch.empty(p * 2 * _PREAGG_MAXQ, dtype=torch.int64, device=dev))


def agg_preagg_cuda(sort_key, perm, key_cols, valid, signs, modes, inits,
                    values) -> Preagg:
    """Kernel K5 (``csrc/agg_preagg.cu``): one launch, a tile of rows a
    block, the segments' carries across tiles by decoupled look-back."""
    if len(values) > MAX_PRIMS:
        raise ValueError(f"more than {MAX_PRIMS} primitive states")
    n = sort_key.shape[0]
    dev = sort_key.device
    args = _PreaggArgs()
    keys = args.keys
    keep, s_keys = [], []
    k = 0
    for col in key_cols:
        # a StrCol passes as two leaves (its bytes and its lengths), both
        # under the column's null plane; the runs compare every byte
        data, null = split_col(col)
        nu8 = None if null is None else null.contiguous().view(torch.uint8)
        onu8 = None if null is None else torch.empty_like(nu8)
        if isinstance(data, StrCol):
            od = StrCol(torch.empty_like(data.data),
                        torch.empty_like(data.lens))
            pairs = [(data.data, od.data), (data.lens, od.lens)]
        elif data.dtype.is_floating_point:
            raise NotImplementedError(
                "float group keys in the agg's pre-aggregation are not "
                "ported to CUDA yet")
        else:
            od = torch.empty_like(data)
            pairs = [(data, od)]
        for d, o in pairs:
            if k >= kernels.MAX_COLS:
                raise ValueError(f"more than {kernels.MAX_COLS} key leaves")
            d = d.contiguous()
            keep += [t for t in (d, o, nu8, onu8) if t is not None]
            keys.width[k] = leaf_width(d)
            keys.in_data[k], keys.st_data[k] = d.data_ptr(), o.data_ptr()
            keys.in_null[k] = kernels.ptr(nu8)
            keys.st_null[k] = kernels.ptr(onu8)
            k += 1
        s_keys.append(od if null is None
                      else NCol(od, onu8.view(torch.bool)))
    keys.n = k
    sort_key = sort_key.contiguous()
    perm = perm.contiguous()
    valid_u8 = valid.contiguous().view(torch.uint8)
    signs = signs.to(torch.int32).contiguous()
    i64 = dict(dtype=torch.int64, device=dev)
    starts = torch.empty(n, dtype=torch.uint8, device=dev)
    s_hash = torch.empty(n, **i64)
    rep = torch.empty(n, dtype=torch.uint8, device=dev)
    seg_rows = torch.empty(n, **i64)
    seg_signs = torch.empty(n, **i64)
    args.n_prims = len(values)
    seg_values = []
    for p, (mode, init, val) in enumerate(zip(modes, inits, values)):
        if val.dtype not in _DTYPES:
            raise NotImplementedError(
                f"{mode} over {val.dtype} is not ported to CUDA yet")
        val = val.contiguous()
        out = torch.empty_like(val)
        keep += [val, out]
        seg_values.append(out)
        args.mode[p] = _MODES[mode]
        args.dtype[p] = _DTYPES[val.dtype]
        args.value[p], args.seg[p] = val.data_ptr(), out.data_ptr()
        if val.dtype == torch.float64:
            args.init_f[p] = float(init)
        else:
            args.init_i[p] = int(init)
    kernels.require_cuda("agg_preagg", sort_key, perm, valid_u8, signs,
                         starts, *keep)
    args.sort_key, args.perm = sort_key.data_ptr(), perm.data_ptr()
    args.valid, args.signs = valid_u8.data_ptr(), signs.data_ptr()
    args.starts, args.s_hash = starts.data_ptr(), s_hash.data_ptr()
    args.rep, args.seg_rows = rep.data_ptr(), seg_rows.data_ptr()
    args.seg_signs = seg_signs.data_ptr()
    args.n = n
    (status, carry), args.epoch = kernels.lookback_scratch(
        _PREAGG_SCRATCH, dev, max(1, -(-n // _PREAGG_TILE)), _PREAGG_EPOCHS,
        _preagg_tensors)
    args.status, args.carry = status.data_ptr(), carry.data_ptr()
    fn = kernels.entry("agg_preagg", "rw_agg_preagg",
                       [_PreaggArgs, ctypes.c_void_p])
    kernels.count_launch("agg_preagg")
    kernels.check(fn(args, kernels.stream_ptr(dev)), "agg_preagg")
    return Preagg(s_hash, s_keys, starts.view(torch.bool), perm,
                  rep.view(torch.bool), seg_rows, seg_signs, seg_values)


def agg_preagg(key_cols, h, valid, signs, modes, inits, values) -> Preagg:
    """Sort a chunk by key hash and pre-aggregate each run of equal keys
    (the sort is ``torch.sort``); CUDA tensors launch kernel K5.
    ``values`` are the rows' lifted contributions in chunk order, one
    per primitive, in the primitive's dtype."""
    sort_key, perm = sort_by_hash(h, valid)
    impl = agg_preagg_cuda if h.device.type == "cuda" else agg_preagg_plain
    return impl(sort_key, perm, key_cols, valid, signs, modes, inits, values)


def preagg_more(pa: Preagg, key_cols, valid, signs, modes, inits,
                values) -> list:
    """The runs' partials of further primitives over the sort of ``pa``
    (the same runs); CUDA tensors launch kernel K5 again."""
    impl = agg_preagg_cuda if valid.device.type == "cuda" \
        else agg_preagg_plain
    return impl(pa.s_hash ^ INT64_MIN, pa.perm, key_cols, valid, signs,
                modes, inits, values).seg_values


# ---------------------------------------------------------------------------
# the spill capture: agg_spill


def spill_mask_plain(valid, overflow, pa: "Preagg | None"):
    """Row-order bool mask of the rows that divert to the ring: on the
    per-row branch the valid rows that overflowed, on the pre-aggregation
    branch every valid row of a segment whose representative did
    (``seg_over`` through ``perm``)."""
    if pa is None:
        return valid & overflow
    cap = valid.shape[0]
    seg_id = torch.cumsum(pa.starts.to(torch.int64), 0)
    seg_over = torch.zeros(cap + 1, dtype=torch.bool, device=valid.device)
    seg_over[seg_id[pa.rep]] = overflow[pa.rep]
    mask = torch.zeros(cap, dtype=torch.bool, device=valid.device)
    mask[pa.perm] = valid[pa.perm] & seg_over[seg_id]
    return mask


def _scatter_ring_col_(store, pos: torch.Tensor, col, rows) -> None:
    """In place ``store[pos] = col[rows]`` (a NULL-less column into a
    nullable store writes NULL flags of 0)."""
    if isinstance(store, NCol):
        if isinstance(col, NCol):
            _scatter_ring_col_(store.data, pos, col.data, rows)
            store.null[pos] = col.null[rows]
        else:
            _scatter_ring_col_(store.data, pos, col, rows)
            store.null[pos] = False
    elif isinstance(store, StrCol):
        store.data[pos] = col.data[rows]
        store.lens[pos] = col.lens[rows]
    else:
        store[pos] = col[rows]


def spill_capture_plain(state: "AggState", chunk: Chunk, valid, overflow,
                        pa: "Preagg | None", ring: int) -> torch.Tensor:
    """Plain PyTorch version of kernel ``agg_spill``, in place: the
    masked rows, in chunk order, go to ring positions ``spill_count +
    rank``; the count advances, clamped at the ring's size, and the rows
    past it add to ``overflow``.  Returns the row-order mask."""
    mask = spill_mask_plain(valid, overflow, pa)
    m32 = mask.to(torch.int32)
    pos = state.spill_count + torch.cumsum(m32, 0, dtype=torch.int32) - m32
    ok = mask & (pos < ring)
    tgt = pos[ok].to(torch.int64)
    for store, col in zip(state.spill_rows, chunk.columns):
        _scatter_ring_col_(store, tgt, col, ok)
    state.spill_ops[tgt] = chunk.ops[ok]
    state.overflow.add_((mask & ~ok).sum(dtype=torch.int64))
    state.spill_count.copy_(torch.clamp(
        state.spill_count + mask.sum(dtype=torch.int32), max=ring))
    return mask


class _SpillArgs(ctypes.Structure):
    """Mirror of ``struct AggSpillArgs`` in ``csrc/agg_spill.cu``."""

    _fields_ = [
        ("cols", kernels.JoinCols),
        ("ops", ctypes.c_void_p), ("ring_ops", ctypes.c_void_p),
        ("valid", ctypes.c_void_p), ("overflow", ctypes.c_void_p),
        ("rep", ctypes.c_void_p), ("starts", ctypes.c_void_p),
        ("perm", ctypes.c_void_p), ("seg_over", ctypes.c_void_p),
        ("mask", ctypes.c_void_p), ("count", ctypes.c_void_p),
        ("lost", ctypes.c_void_p), ("cap", ctypes.c_int),
        ("ring", ctypes.c_int),
    ]


def spill_capture_cuda(state: "AggState", chunk: Chunk, valid, overflow,
                       pa: "Preagg | None", ring: int) -> torch.Tensor:
    """Kernel ``agg_spill`` (``csrc/agg_spill.cu``): one launch of one
    block every chunk, in place; no host read.  Returns the row-order
    mask the kernel wrote."""
    cap = chunk.capacity
    dev = chunk.device
    a = _SpillArgs()
    keep = []
    k = 0
    for store, col in zip(state.spill_rows, chunk.columns):
        sd, sn = split_col(store)
        cd, cn = split_col(col)
        pairs = [(x, y) for (x, _), (y, _) in zip(value_leaves(sd),
                                                  value_leaves(cd))]
        if sn is not None:
            if cn is None:
                cn = torch.zeros(cap, dtype=torch.bool, device=dev)
            pairs.append((sn.view(torch.uint8),
                          cn.contiguous().view(torch.uint8)))
        for dst, src in pairs:
            if k >= kernels.MAX_JOIN_LEAVES:
                raise ValueError(f"more than {kernels.MAX_JOIN_LEAVES} leaves")
            src = src.contiguous()
            keep += [dst, src]
            a.cols.width[k] = leaf_width(src)
            a.cols.src[k] = src.data_ptr()
            a.cols.dst[k] = dst.data_ptr()
            k += 1
    a.cols.n = k
    u8 = lambda t: t.contiguous().view(torch.uint8)  # noqa: E731
    flags = [u8(valid), u8(overflow)]
    if pa is not None:
        flags += [u8(pa.rep), u8(pa.starts)]
        perm = pa.perm.contiguous()
        keep.append(perm)
    ops = chunk.ops.contiguous()
    scratch = torch.empty(2 * cap + 1, dtype=torch.uint8, device=dev)
    kernels.require_cuda("agg_spill", ops, state.spill_ops,
                         state.spill_count, state.overflow, scratch,
                         *flags, *keep)
    a.ops, a.ring_ops = ops.data_ptr(), state.spill_ops.data_ptr()
    a.valid, a.overflow = flags[0].data_ptr(), flags[1].data_ptr()
    if pa is not None:
        a.rep, a.starts = flags[2].data_ptr(), flags[3].data_ptr()
        a.perm = perm.data_ptr()
    a.seg_over, a.mask = scratch.data_ptr(), scratch[cap + 1:].data_ptr()
    a.count, a.lost = state.spill_count.data_ptr(), \
        state.overflow.data_ptr()
    a.cap, a.ring = cap, ring
    fn = kernels.entry("agg_spill", "rw_agg_spill",
                       [_SpillArgs, ctypes.c_void_p])
    kernels.count_launch("agg_spill")
    kernels.check(fn(a, kernels.stream_ptr(dev)), "agg_spill")
    return scratch[cap + 1:].view(torch.bool)


def spill_capture(state: "AggState", chunk: Chunk, valid, overflow,
                  pa: "Preagg | None", ring: int) -> torch.Tensor:
    """Divert the overflowed rows into the spill ring, in place, and
    return the row-order mask of the diverted rows; CUDA tensors launch
    kernel ``agg_spill``."""
    impl = spill_capture_cuda if chunk.device.type == "cuda" \
        else spill_capture_plain
    return impl(state, chunk, valid, overflow, pa, ring)


# ---------------------------------------------------------------------------
# kernel K6d: the DISTINCT dedup


def distinct_dedup_plain(cnt, slots, inserted, eligible, over, rank, signs,
                         overflow, inconsistency):
    """Plain PyTorch version of kernel K6d, in place on the per-key
    counts ``cnt`` and the two counters: the reference's dedup pass of
    one DISTINCT call after K3 (``slots``, ``inserted``, ``over``) and
    the rank of each surviving eligible row among rows of its slot.
    Returns (int64 [cap] transition signs at the keys' first rows, bool
    [cap] the first rows whose key retracted to 0)."""
    size = cnt.shape[0]
    dev = cnt.device
    overflow.add_((over & eligible).sum(dtype=torch.int64))
    live = eligible & ~over
    cnt[slots[inserted & (slots < size)].to(torch.int64)] = 0
    safe = torch.clamp(slots, max=size - 1).to(torch.int64)
    contrib = torch.where(live, signs.to(torch.int64),
                          torch.zeros((), dtype=torch.int64, device=dev))
    delta = torch.zeros(size, dtype=torch.int64, device=dev)
    delta.index_add_(0, safe, contrib)
    n0 = cnt[safe]
    n1 = n0 + delta[safe]
    inconsistency.add_((live & (n1 < 0)).sum(dtype=torch.int64))
    rep = live & (rank == 0)
    d_sign = torch.where(rep, (n1 > 0).to(torch.int64)
                         - (n0 > 0).to(torch.int64),
                         torch.zeros_like(n0))
    cnt.index_add_(0, safe, contrib)
    return d_sign, rep & (n1 <= 0) & (n0 > 0)


class _DistinctArgs(ctypes.Structure):
    """Mirror of ``struct AggDistinctArgs`` in ``csrc/agg_distinct.cu``."""

    _fields_ = [
        ("slots", ctypes.c_void_p), ("inserted", ctypes.c_void_p),
        ("eligible", ctypes.c_void_p), ("over", ctypes.c_void_p),
        ("rank", ctypes.c_void_p), ("signs", ctypes.c_void_p),
        ("cnt", ctypes.c_void_p), ("n0", ctypes.c_void_p),
        ("d_sign", ctypes.c_void_p), ("dead", ctypes.c_void_p),
        ("overflow", ctypes.c_void_p), ("inconsistency", ctypes.c_void_p),
        ("cap", ctypes.c_int), ("size", ctypes.c_int),
    ]


def distinct_dedup_cuda(cnt, slots, inserted, eligible, over, rank, signs,
                        overflow, inconsistency):
    """Kernel K6d (``csrc/agg_distinct.cu``): four grid launches, in
    place; no host read."""
    cap = slots.shape[0]
    dev = slots.device
    u8 = lambda t: t.contiguous().view(torch.uint8)  # noqa: E731
    flags = [u8(inserted), u8(eligible), u8(over)]
    slots = slots.to(torch.int32).contiguous()
    rank = rank.to(torch.int32).contiguous()
    signs = signs.to(torch.int32).contiguous()
    n0 = torch.empty(cap, dtype=torch.int64, device=dev)
    d_sign = torch.empty(cap, dtype=torch.int64, device=dev)
    dead = torch.empty(cap, dtype=torch.uint8, device=dev)
    kernels.require_cuda("agg_distinct", cnt, slots, rank, signs, n0, d_sign,
                         dead, overflow, inconsistency, *flags)
    a = _DistinctArgs()
    a.slots, a.inserted = slots.data_ptr(), flags[0].data_ptr()
    a.eligible, a.over = flags[1].data_ptr(), flags[2].data_ptr()
    a.rank, a.signs, a.cnt = rank.data_ptr(), signs.data_ptr(), cnt.data_ptr()
    a.n0, a.d_sign, a.dead = n0.data_ptr(), d_sign.data_ptr(), dead.data_ptr()
    a.overflow = overflow.data_ptr()
    a.inconsistency = inconsistency.data_ptr()
    a.cap, a.size = cap, cnt.shape[0]
    fn = kernels.entry("agg_distinct", "rw_agg_distinct",
                       [_DistinctArgs, ctypes.c_void_p])
    kernels.count_launch("agg_distinct")
    kernels.check(fn(a, kernels.stream_ptr(dev)), "agg_distinct")
    return d_sign, dead.view(torch.bool)


def distinct_dedup(cnt, slots, inserted, eligible, over, rank, signs,
                   overflow, inconsistency):
    """One DISTINCT call's dedup after its K3 probe and rank; CUDA
    tensors launch kernel K6d.  See ``distinct_dedup_plain``."""
    impl = distinct_dedup_cuda if slots.device.type == "cuda" \
        else distinct_dedup_plain
    return impl(cnt, slots, inserted, eligible, over, rank, signs, overflow,
                inconsistency)


# ---------------------------------------------------------------------------
# kernel K6m: the materialized input of retractable min/max


def minput_survivors(row_slots, v, signs, active):
    """``(pair_h, is_ins, is_del)``: K1 over each row's (slot, value) pair
    and the inserts and deletes that survive the in-chunk annihilation
    (the k-th insert of a pair cancels its k-th delete), in row order."""
    is_ins = active & (signs > 0)
    is_del = active & (signs < 0)
    pair_h = hash64_columns([row_slots.to(torch.int64), v])
    n_ins_h = _group_totals(pair_h, is_ins)
    n_del_h = _group_totals(pair_h, is_del)
    keep_ins = ~(_rank_by(pair_h, is_ins) < n_del_h)
    is_del = is_del & ~(_rank_by(pair_h, is_del) < n_ins_h)
    return pair_h, is_ins & keep_ins, is_del


def minput_update_plain(vals, occ, row_slots, v, signs, active, ins_pos,
                        overflow, inconsistency) -> None:
    """Plain PyTorch version of kernel K6m's update, in place: the
    reference's ``_minput_update`` (:790) over rows in the agg's row
    order (sorted on the pre-aggregation branch).  Reclaimed slots
    (``ins_pos``) start empty; +v/-v pairs on (slot, value) cancel; each
    delete clears the rank-th value-equal occupied entry of its slot's
    bucket (a miss counts into ``inconsistency``), then each insert
    claims the rank-th free entry (none: ``overflow``)."""
    size, B = occ.shape
    occ[ins_pos[ins_pos < size].to(torch.int64)] = False
    pair_h, is_ins, is_del = minput_survivors(row_slots, v, signs, active)
    safe = torch.clamp(row_slots, max=size - 1).to(torch.int64)
    occ_flat, vals_flat = occ.view(-1), vals.view(-1)
    del_rank = _rank_by(pair_h, is_del)
    match = occ[safe] & (vals[safe] == v[:, None])
    match_rank = torch.cumsum(match.to(torch.int32), 1) - 1
    clear = match & (match_rank == del_rank[:, None]) & is_del[:, None]
    any_clear = clear.any(dim=1)
    inconsistency.add_((is_del & ~any_clear).sum(dtype=torch.int64))
    occ_flat[(safe * B + _first_true(clear))[any_clear]] = False
    ins_rank = _rank_by(row_slots.to(torch.int64), is_ins)
    free = ~occ[safe]
    free_rank = torch.cumsum(free.to(torch.int32), 1) - 1
    take = free & (free_rank == ins_rank[:, None]) & is_ins[:, None]
    got = take.any(dim=1)
    flat = (safe * B + _first_true(take))[got]
    occ_flat[flat] = True
    vals_flat[flat] = v[got]
    overflow.add_((is_ins & ~got).sum(dtype=torch.int64))


class _MinputArgs(ctypes.Structure):
    """Mirror of ``struct MinputArgs`` in ``csrc/agg_minput.cu``."""

    _fields_ = [
        ("vals", ctypes.c_void_p), ("occupied", ctypes.c_void_p),
        ("row_slots", ctypes.c_void_p), ("v", ctypes.c_void_p),
        ("is_ins", ctypes.c_void_p), ("is_del", ctypes.c_void_p),
        ("ins_rank", ctypes.c_void_p), ("del_rank", ctypes.c_void_p),
        ("ins_pos", ctypes.c_void_p), ("overflow", ctypes.c_void_p),
        ("inconsistency", ctypes.c_void_p), ("clear_pos", ctypes.c_void_p),
        ("take_pos", ctypes.c_void_p), ("cap", ctypes.c_int),
        ("size", ctypes.c_int), ("B", ctypes.c_int), ("dtype", ctypes.c_int),
    ]


def minput_update_cuda(vals, occ, row_slots, v, signs, active, ins_pos,
                       overflow, inconsistency) -> None:
    """Kernel K6m's update (``csrc/agg_minput.cu``), in place: K1 on the
    (slot, value) pairs, the annihilation launch (which also ranks the
    surviving deletes), K13's rank launch for the inserts, then the five
    update launches; no host read."""
    if vals.dtype not in _DTYPES:
        raise NotImplementedError(
            f"min/max over {vals.dtype} values is not ported to K6m")
    cap = row_slots.shape[0]
    dev = row_slots.device
    size, B = occ.shape
    v = v.to(vals.dtype).contiguous()
    pair_h = hash64_columns([row_slots.to(torch.int64), v])
    is_ins, is_del, del_rank = bucket_cancel_cuda(
        "agg_minput", pair_h, active & (signs > 0), active & (signs < 0))
    ins_rank = rank_by(row_slots.to(torch.int64), is_ins)
    slots32 = row_slots.to(torch.int32).contiguous()
    ins32 = ins_pos.to(torch.int32).contiguous()
    scratch = torch.empty(2 * cap, dtype=torch.int32, device=dev)
    occ_u8 = occ.view(torch.uint8)
    flags = [is_ins.contiguous().view(torch.uint8),
             is_del.contiguous().view(torch.uint8)]
    ranks = [ins_rank.contiguous(), del_rank.contiguous()]
    kernels.require_cuda("agg_minput", vals, occ_u8, slots32, v, ins32,
                         overflow, inconsistency, scratch, *flags, *ranks)
    a = _MinputArgs()
    a.vals, a.occupied = vals.data_ptr(), occ_u8.data_ptr()
    a.row_slots, a.v = slots32.data_ptr(), v.data_ptr()
    a.is_ins, a.is_del = flags[0].data_ptr(), flags[1].data_ptr()
    a.ins_rank, a.del_rank = ranks[0].data_ptr(), ranks[1].data_ptr()
    a.ins_pos = ins32.data_ptr()
    a.overflow, a.inconsistency = overflow.data_ptr(), \
        inconsistency.data_ptr()
    a.clear_pos, a.take_pos = scratch.data_ptr(), scratch[cap:].data_ptr()
    a.cap, a.size, a.B, a.dtype = cap, size, B, _DTYPES[vals.dtype]
    fn = kernels.entry("agg_minput", "rw_minput_update",
                       [_MinputArgs, ctypes.c_void_p])
    kernels.count_launch("agg_minput")
    kernels.check(fn(a, kernels.stream_ptr(dev)), "agg_minput")


def minput_update(vals, occ, row_slots, v, signs, active, ins_pos, overflow,
                  inconsistency) -> None:
    """Apply one chunk's rows to a min/max call's value buckets, in
    place; CUDA tensors launch kernel K6m.  See ``minput_update_plain``."""
    impl = minput_update_cuda if occ.device.type == "cuda" \
        else minput_update_plain
    impl(vals, occ, row_slots, v, signs, active, ins_pos, overflow,
         inconsistency)


def minput_refresh_plain(prim, vals, occ, slots, mode: str) -> None:
    """Plain PyTorch version of K6m's refresh, in place: the reference's
    ``_refresh_minput_caches`` (:879) for one call: each live emitted
    slot's cache becomes the min or max of its bucket's occupied values
    (the type's identity for an empty bucket)."""
    size = prim.shape[0]
    live = slots < size
    safe = torch.clamp(slots, max=size - 1).to(torch.int64)
    masked = torch.where(occ[safe], vals[safe],
                         torch.full_like(vals[safe],
                                         _minmax_init(mode)(vals.dtype)))
    red = masked.amin(1) if mode == "min" else masked.amax(1)
    prim[safe[live]] = red[live]


class _RefreshArgs(ctypes.Structure):
    """Mirror of ``struct RefreshArgs`` in ``csrc/agg_minput.cu``."""

    _fields_ = [
        ("vals", ctypes.c_void_p), ("occupied", ctypes.c_void_p),
        ("slots", ctypes.c_void_p), ("prim", ctypes.c_void_p),
        ("n", ctypes.c_int), ("size", ctypes.c_int), ("B", ctypes.c_int),
        ("dtype", ctypes.c_int), ("mode", ctypes.c_int),
    ]


def minput_refresh_cuda(prim, vals, occ, slots, mode: str) -> None:
    """K6m's refresh launch (``csrc/agg_minput.cu``): one warp per
    emitted slot, in place."""
    if vals.dtype not in _DTYPES or prim.dtype != vals.dtype:
        raise NotImplementedError(
            f"min/max over {vals.dtype} values is not ported to K6m")
    size, B = occ.shape
    slots32 = slots.to(torch.int32).contiguous()
    occ_u8 = occ.view(torch.uint8)
    kernels.require_cuda("minput_refresh", prim, vals, occ_u8, slots32)
    a = _RefreshArgs()
    a.vals, a.occupied = vals.data_ptr(), occ_u8.data_ptr()
    a.slots, a.prim = slots32.data_ptr(), prim.data_ptr()
    a.n, a.size, a.B = slots32.shape[0], size, B
    a.dtype, a.mode = _DTYPES[vals.dtype], _MODES[mode]
    fn = kernels.entry("minput_refresh", "rw_minput_refresh",
                       [_RefreshArgs, ctypes.c_void_p])
    kernels.count_launch("minput_refresh")
    kernels.check(fn(a, kernels.stream_ptr(prim.device)), "minput_refresh")


def minput_refresh(prim, vals, occ, slots, mode: str) -> None:
    """Recompute one min/max call's cache at the emitted ``slots`` from
    its buckets, in place; CUDA tensors launch K6m's refresh."""
    impl = minput_refresh_cuda if occ.device.type == "cuda" \
        else minput_refresh_plain
    impl(prim, vals, occ, slots, mode)


# ---------------------------------------------------------------------------
# kernel K7e: the closed windows of EMIT ON WINDOW CLOSE


def closed_mask(occupied, key, key_null, lag: int, wm) -> torch.Tensor:
    """bool [size]: the reference's ``_closed_mask`` (:961): occupied
    slots whose window key plus ``lag`` is at most the watermark, never
    a NULL window, nothing before the first watermark."""
    closed = occupied & (key + lag <= wm) & (wm != INT64_MIN)
    return closed if key_null is None else closed & ~key_null


def eowc_slots_plain(occupied, key, key_null, lag: int, wm, k: int):
    """Plain PyTorch version of kernel K7e: ``(int32 [k] the first k
    closed slots ascending, the ``size`` sentinel past the last; int64
    scalar count of closed slots)``."""
    closed = closed_mask(occupied, key, key_null, lag, wm)
    return (mask_indices(closed, k, occupied.shape[0]),
            closed.sum(dtype=torch.int64))


class _EowcArgs(ctypes.Structure):
    """Mirror of ``struct EowcArgs`` in ``csrc/agg_eowc.cu``."""

    _fields_ = [
        ("occupied", ctypes.c_void_p), ("key", ctypes.c_void_p),
        ("key_null", ctypes.c_void_p), ("wm", ctypes.c_void_p),
        ("lag", ctypes.c_longlong), ("counts", ctypes.c_void_p),
        ("out", ctypes.c_void_p), ("total", ctypes.c_void_p),
        ("size", ctypes.c_int), ("k", ctypes.c_int),
    ]


def eowc_slots_cuda(occupied, key, key_null, lag: int, wm, k: int):
    """Kernel K7e (``csrc/agg_eowc.cu``): two launches, the watermark
    read on the card; no host read."""
    if key.dtype != torch.int64:
        raise NotImplementedError(
            f"EMIT ON WINDOW CLOSE over a {key.dtype} window key is not "
            "ported to K7e")
    size = occupied.shape[0]
    dev = occupied.device
    occ_u8 = occupied.contiguous().view(torch.uint8)
    key = key.contiguous()
    nul = None if key_null is None else key_null.contiguous().view(
        torch.uint8)
    wm = wm.reshape(1).contiguous()
    out = torch.empty(max(k, 1), dtype=torch.int32, device=dev)
    counts = torch.empty(max(1, -(-size // MI_TILE)), dtype=torch.int32,
                         device=dev)
    total = torch.empty((), dtype=torch.int64, device=dev)
    kernels.require_cuda("agg_eowc", occ_u8, key, wm, out, counts, total,
                         *([nul] if nul is not None else []))
    a = _EowcArgs()
    a.occupied, a.key = occ_u8.data_ptr(), key.data_ptr()
    a.key_null, a.wm = kernels.ptr(nul), wm.data_ptr()
    a.lag = lag
    a.counts, a.out, a.total = counts.data_ptr(), out.data_ptr(), \
        total.data_ptr()
    a.size, a.k = size, k
    fn = kernels.entry("agg_eowc", "rw_agg_eowc",
                       [_EowcArgs, ctypes.c_void_p])
    kernels.count_launch("agg_eowc")
    kernels.check(fn(a, kernels.stream_ptr(dev)), "agg_eowc")
    return out[:k], total


def eowc_slots(occupied, key, key_null, lag: int, wm, k: int):
    """The first ``k`` closed group slots and the closed count; CUDA
    tensors launch kernel K7e.  See ``eowc_slots_plain``."""
    impl = eowc_slots_cuda if occupied.device.type == "cuda" \
        else eowc_slots_plain
    return impl(occupied, key, key_null, lag, wm, k)


# ---------------------------------------------------------------------------


def interleave(old, new):
    """[n] + [n] -> [2n] with old at even, new at odd positions."""
    if isinstance(old, NCol):
        return NCol(interleave(old.data, new.data),
                    interleave(old.null, new.null))
    if isinstance(old, StrCol):
        return StrCol(interleave(old.data, new.data),
                      interleave(old.lens, new.lens))
    return torch.stack([old, new], dim=1).reshape(
        (old.shape[0] * 2,) + tuple(old.shape[1:]))


def slot_mask(slots: torch.Tensor, size: int) -> torch.Tensor:
    """bool [size]: True at the live entries of ``slots`` (the ``size``
    sentinel lands on a dump entry that is cut off)."""
    m = torch.zeros(size + 1, dtype=torch.bool, device=slots.device)
    m[slots.to(torch.int64)] = True
    return m[:size]


class HashAggExecutor(Executor):
    """GROUP BY aggregation over a device hash table."""

    emits_on_apply = False
    emits_on_flush = True

    def __init__(
        self,
        in_schema: Schema,
        group_by: Sequence[tuple[str, Expr]],
        aggs: Sequence[AggCall],
        table_size: int = 1 << 16,
        emit_capacity: int = 4096,
        watermark_group_idx: int | None = None,
        watermark_lag: int = 0,
        watermark_src_col: int | None = None,
        emit_on_window_close: bool = False,
        retractable_input: bool = False,
        minput_bucket_cap: int = 64,
        distinct_table_size: int | None = None,
        spill_ring: int = 0,
    ):
        super().__init__(in_schema)
        self.group_by = tuple(group_by)
        self.aggs = tuple(aggs)
        #: overflow-row ring capacity (0: overflow is an error); the
        #: planner sets it for aggregations without watermark cleaning
        self.spill_ring = spill_ring
        self._ctor_kwargs = dict(
            in_schema=in_schema, group_by=self.group_by, aggs=self.aggs,
            emit_capacity=emit_capacity,
            watermark_group_idx=watermark_group_idx,
            watermark_lag=watermark_lag,
            watermark_src_col=watermark_src_col,
            emit_on_window_close=emit_on_window_close,
            retractable_input=retractable_input,
            minput_bucket_cap=minput_bucket_cap)
        #: EOWC: flush emits only CLOSED windows, as final append-only
        #: rows, and evicts them
        self.emit_on_window_close = emit_on_window_close
        if emit_on_window_close and watermark_group_idx is None:
            raise ValueError(
                "EMIT ON WINDOW CLOSE needs a watermarked window group key")
        self.watermark_group_idx = watermark_group_idx
        self.watermark_lag = watermark_lag
        self.watermark_src_col = watermark_src_col
        self.table_size = table_size
        self.emit_capacity = emit_capacity
        key_fields = []
        for name, e in self.group_by:
            f = e.return_field(in_schema)
            key_fields.append(Field(name, f.data_type, str_width=f.str_width,
                                    decimal_scale=f.decimal_scale,
                                    nullable=f.nullable))
        agg_fields = tuple(a.out_field(in_schema) for a in self.aggs)
        self._out_schema = Schema(tuple(key_fields) + agg_fields)
        self._prim_specs = [(ai, ps) for ai, a in enumerate(self.aggs)
                            for ps in a.spec().states]
        #: retractable min/max through materialized-input buckets; their
        #: prims are flush-time caches (no apply scatter)
        self.minput_bucket_cap = minput_bucket_cap
        self._minput_aggs: list[int] = [
            ai for ai, a in enumerate(self.aggs)
            if retractable_input and a.kind in ("min", "max")]
        self._cache_prims = {pi for pi, (ai, _) in enumerate(self._prim_specs)
                             if ai in self._minput_aggs}
        #: DISTINCT calls with their own counted dedup tables; min/max
        #: are distinct-insensitive and run as plain calls
        self.distinct_table_size = distinct_table_size or table_size
        self._distinct_aggs: list[int] = [
            ai for ai, a in enumerate(self.aggs)
            if a.distinct and a.kind not in ("min", "max")]
        # hidden non-null-count prims: an aggregate whose argument rows
        # are all NULL (or all filtered out) outputs NULL
        self._nn_prim: dict[int, int] = {}
        for ai, a in enumerate(self.aggs):
            if a.arg is None or a.kind in ("count", "count_star"):
                continue
            if a.arg.return_field(in_schema).nullable or a.filter is not None:
                self._nn_prim[ai] = len(self._prim_specs)
                self._prim_specs.append((ai, _ADD_COUNT))

    @property
    def out_schema(self) -> Schema:
        return self._out_schema

    # ------------------------------------------------------------------
    def _key_protos(self, device):
        return [self._col_proto(e.return_field(self.in_schema), device)
                for _, e in self.group_by]

    @staticmethod
    def _col_proto(f: Field, device):
        """A one-row key prototype of field ``f`` (an NCol if nullable)."""
        if f.data_type.is_string:
            p = StrCol(torch.zeros((1, f.str_width), dtype=torch.uint8,
                                   device=device),
                       torch.zeros(1, dtype=torch.int32, device=device))
        else:
            p = torch.zeros(1, dtype=f.data_type.physical_dtype,
                            device=device)
        if f.nullable:
            p = NCol(p, torch.zeros(1, dtype=torch.bool, device=device))
        return p

    def _distinct_protos(self, agg_idx: int, device) -> list:
        """Key prototypes of a DISTINCT call's dedup table: (group
        keys..., argument)."""
        f = self.aggs[agg_idx].arg.return_field(self.in_schema)
        return self._key_protos(device) + [self._col_proto(f, device)]

    def cuda_refusal(self) -> str | None:
        """Why the card's pre-aggregation (K5) and scatter (K6) cannot run
        this aggregation, or None."""
        for name, e in self.group_by:
            t = e.return_field(self.in_schema).data_type
            if t in (DataType.FLOAT32, DataType.FLOAT64):
                return (f"GROUP BY on a {t.value} column is not ported to "
                        "the pre-aggregation kernel (K5)")
        # a string key is two leaves: its bytes and its lengths
        def leaves(f):
            return 2 if f.data_type.is_string else 1

        n = sum(leaves(e.return_field(self.in_schema))
                for _, e in self.group_by)
        if n > kernels.MAX_COLS:
            return (f"{n} group-key leaves (K5 takes {kernels.MAX_COLS})")
        for agg_idx in self._distinct_aggs:
            f = self.aggs[agg_idx].arg.return_field(self.in_schema)
            if n + leaves(f) > kernels.MAX_COLS:
                return (f"a DISTINCT dedup key of {n + leaves(f)} leaves "
                        f"(K1 and K3 take {kernels.MAX_COLS})")
        for agg_idx in self._minput_aggs:
            dt = self._input_dtype(agg_idx)
            if dt not in _DTYPES:
                return (f"{self.aggs[agg_idx].kind} over {dt} values on a "
                        "retractable input is not ported to the "
                        "materialized-input kernel (K6m)")
        if self.emit_on_window_close:
            f = self.group_by[self.watermark_group_idx][1].return_field(
                self.in_schema)
            if f.data_type.physical_dtype != torch.int64:
                return (f"EMIT ON WINDOW CLOSE over a {f.data_type.value} "
                        "window key is not ported to K7e")
        for pi, (agg_idx, ps) in enumerate(self._prim_specs):
            if pi in self._cache_prims:
                continue  # a K6m cache: no K5 or K6 work
            dt = ps.dtype(self._input_dtype(agg_idx))
            if dt not in _DTYPES:
                return (f"{self.aggs[agg_idx].kind} over {dt} values is not "
                        "ported to the aggregation kernels (K5, K6)")
            if dt == torch.float64 and ps.mode != "add":
                return (f"{ps.mode} over float64 is not ported to the "
                        "aggregation scatter (K6)")
        return None

    def _input_dtype(self, agg_idx: int) -> torch.dtype:
        a = self.aggs[agg_idx]
        if a.arg is None:
            return torch.int64
        return a.arg.return_field(self.in_schema).data_type.physical_dtype

    def _make_prims(self, device) -> tuple:
        out = []
        for agg_idx, ps in self._prim_specs:
            dt = ps.dtype(self._input_dtype(agg_idx))
            out.append(torch.full((self.table_size,), ps.init(dt), dtype=dt,
                                  device=device))
        return tuple(out)

    def init_state(self, device) -> AggState:
        size = self.table_size
        i64 = dict(dtype=torch.int64, device=device)
        return AggState(
            table=HashTable.create(self._key_protos(device), size, device),
            prims=self._make_prims(device),
            row_count=torch.zeros(size, **i64),
            dirty=torch.zeros(size, dtype=torch.bool, device=device),
            prev_prims=self._make_prims(device),
            prev_row_count=torch.zeros(size, **i64),
            emitted=torch.zeros(size, dtype=torch.bool, device=device),
            overflow=torch.zeros((), **i64),
            inconsistency=torch.zeros((), **i64),
            wm=torch.full((), INT64_MIN, **i64),
            minput_vals=tuple(
                torch.zeros((size, self.minput_bucket_cap),
                            dtype=self._input_dtype(ai), device=device)
                for ai in self._minput_aggs),
            minput_occ=tuple(
                torch.zeros((size, self.minput_bucket_cap), dtype=torch.bool,
                            device=device)
                for _ in self._minput_aggs),
            distinct_tables=tuple(
                HashTable.create(self._distinct_protos(ai, device),
                                 self.distinct_table_size, device)
                for ai in self._distinct_aggs),
            distinct_counts=tuple(
                torch.zeros(self.distinct_table_size, **i64)
                for _ in self._distinct_aggs),
            spill_rows=tuple(empty_value_col(f, self.spill_ring, device)
                             for f in self.in_schema)
            if self.spill_ring else (),
            spill_ops=torch.zeros(self.spill_ring, dtype=torch.int8,
                                  device=device) if self.spill_ring else (),
            spill_count=torch.zeros((), dtype=torch.int32, device=device)
            if self.spill_ring else (),
        )

    # ------------------------------------------------------------------
    def apply(self, state: AggState, chunk: Chunk):
        """Apply one chunk, in place: pre-aggregated per key on the card,
        per row on the CPU (see the module docstring)."""
        signs = chunk.signs()
        valid = chunk.valid
        cap = chunk.capacity
        dev = chunk.device
        key_cols = [conform_col(e.eval(chunk),
                                e.return_field(self.in_schema).nullable, cap)
                    for _, e in self.group_by]
        h = hash64_columns(key_cols)
        arg_cache: dict[int, object] = {}
        filt_cache: dict[int, torch.Tensor] = {}

        def arg_of(agg_idx):
            if agg_idx not in arg_cache:
                arg_cache[agg_idx] = self.aggs[agg_idx].arg.eval(chunk)
            return arg_cache[agg_idx]

        def filter_mask(agg_idx):
            """bool [cap] FILTER (WHERE ...) mask (NULL excludes), or None."""
            a = self.aggs[agg_idx]
            if a.filter is None:
                return None
            if agg_idx not in filt_cache:
                fcol, fnull = split_col(a.filter.eval(chunk))
                filt_cache[agg_idx] = fcol if fnull is None else fcol & ~fnull
            return filt_cache[agg_idx]

        # per primitive its column (NULL payloads zeroed) and signs; a
        # DISTINCT call's signs come from its dedup, after the probe
        modes, inits, values, later = [], [], [], []
        cols: list = []
        for pi, (agg_idx, ps) in enumerate(self._prim_specs):
            a = self.aggs[agg_idx]
            if pi in self._cache_prims:
                # a K6m cache, recomputed at flush: no K5/K6 work
                for lst in (modes, inits, values, cols):
                    lst.append(None)
                continue
            if a.arg is None:
                col = torch.ones(cap, dtype=torch.int64, device=dev)
            else:
                col = arg_of(agg_idx)
            col, col_null = split_col(col)
            prim_signs = signs
            if col_null is not None:
                # NULL arguments contribute nothing: zero sign and payload
                # (a string's payload is packed under a zero sign)
                if not isinstance(col, StrCol):
                    col = torch.where(col_null, torch.zeros_like(col), col)
                prim_signs = torch.where(col_null, torch.zeros_like(signs),
                                         signs)
            fm = filter_mask(agg_idx)
            if fm is not None:
                prim_signs = torch.where(fm, prim_signs,
                                         torch.zeros_like(prim_signs))
            modes.append(ps.mode)
            inits.append(ps.init(state.prims[pi].dtype))
            cols.append(col)
            if agg_idx in self._distinct_aggs:
                later.append(pi)
                values.append(None)
            else:
                values.append(
                    ps.lift(col, prim_signs).to(state.prims[pi].dtype))
        now = [pi for pi in range(len(values)) if values[pi] is not None]
        scat = [pi for pi in range(len(values)) if pi not in self._cache_prims]
        pa = None
        if accel_tuned(chunk.device):
            # only each run's representative probes and scatters the
            # run's partials; an overflowed representative loses its run
            pa = agg_preagg(key_cols, h, valid, signs,
                            [modes[pi] for pi in now],
                            [inits[pi] for pi in now],
                            [values[pi] for pi in now])
            table, slots, inserted, overflow = state.table.lookup_or_insert(
                pa.s_keys, pa.rep, hashes=pa.s_hash)
            n_over = torch.where(pa.rep & overflow, pa.seg_rows,
                                 torch.zeros_like(pa.seg_rows)).sum()
            for pi, v in zip(now, pa.seg_values):
                values[pi] = v
            row_signs = pa.seg_signs
        else:
            table, slots, inserted, overflow = state.table.lookup_or_insert(
                key_cols, valid, hashes=h)
            n_over = (overflow & valid).sum(dtype=torch.int64)
            row_signs = signs.to(torch.int64)
        spill_mask = None
        if self.spill_ring:
            # overflowed rows divert into the ring; only the rows the ring
            # cannot hold count into overflow (added by the capture)
            spill_mask = spill_capture(state, chunk, valid, overflow, pa,
                                       self.spill_ring)
            n_over = torch.zeros((), dtype=torch.int64, device=dev)
        if later:
            d_signs = self._dedup(state, chunk, key_cols, signs, spill_mask,
                                  arg_of, filter_mask)
            lifted = [self._prim_specs[pi][1].lift(
                cols[pi], d_signs[self._prim_specs[pi][0]]).to(
                    state.prims[pi].dtype) for pi in later]
            if pa is not None:
                lifted = preagg_more(pa, key_cols, valid, signs,
                                     [modes[pi] for pi in later],
                                     [inits[pi] for pi in later], lifted)
            for pi, v in zip(later, lifted):
                values[pi] = v
        agg_scatter([state.prims[pi] for pi in scat],
                    [modes[pi] for pi in scat], [inits[pi] for pi in scat],
                    [values[pi] for pi in scat], slots, inserted, row_signs,
                    state.row_count, state.dirty)
        if self._minput_aggs:
            self._minput_apply(state, chunk, signs, slots, inserted, pa,
                               arg_of, filter_mask)

        n_bad = torch.zeros((), dtype=torch.int64, device=dev)
        if any(not a.spec().retractable and ai not in self._minput_aggs
               for ai, a in enumerate(self.aggs)):
            n_bad = (valid & (signs < 0)).sum(dtype=torch.int64)
        return state._replace(
            table=table,
            overflow=state.overflow + n_over,
            inconsistency=state.inconsistency + n_bad,
        ), None

    def _minput_apply(self, state: AggState, chunk: Chunk, signs, slots,
                      inserted, pa: "Preagg | None", arg_of,
                      filter_mask) -> None:
        """The materialized-input block of the reference's ``apply``
        (:646-691), in place: every row that counts lands in its group's
        value bucket (K6m).  On the pre-aggregation branch the rows are in
        hash-sorted order and each takes its segment representative's
        slot (a segment whose representative overflowed keeps the
        ``size`` sentinel and is skipped: its rows already count into
        ``overflow``)."""
        size = self.table_size
        cap = chunk.capacity
        dev = chunk.device
        valid = chunk.valid
        ins_pos = torch.where(inserted, slots, torch.full_like(slots, size))
        if pa is None:
            perm = None
            row_slots, s_signs, s_valid = slots, signs, valid
        else:
            perm = pa.perm
            seg_id = torch.cumsum(pa.starts.to(torch.int64), 0)
            seg_slot = torch.full((cap + 1,), size, dtype=slots.dtype,
                                  device=dev)
            seg_slot[seg_id[pa.rep]] = slots[pa.rep]
            row_slots = seg_slot[seg_id]
            s_signs, s_valid = signs[perm], valid[perm]
        row_ok = s_valid & (row_slots < size) & (s_signs != 0)
        for mi, agg_idx in enumerate(self._minput_aggs):
            vcol, vnull = split_col(arg_of(agg_idx))
            active = row_ok
            if vnull is not None:
                active = active & ~(vnull if perm is None else vnull[perm])
            fm = filter_mask(agg_idx)
            if fm is not None:
                active = active & (fm if perm is None else fm[perm])
            vals = state.minput_vals[mi]
            v = (vcol if perm is None else vcol[perm]).to(vals.dtype)
            minput_update(vals, state.minput_occ[mi], row_slots, v, s_signs,
                          active, ins_pos, state.overflow,
                          state.inconsistency)

    def _dedup(self, state: AggState, chunk: Chunk, key_cols, signs,
               spill_mask, arg_of, filter_mask) -> dict:
        """The DISTINCT dedup (reference :501-580), in place: per call,
        the rows that count (valid, not diverted, a non-NULL argument,
        passing the FILTER) update their (group, value) key's count;
        returns each call's int64 [cap] transition signs, +1/-1 at a
        key's first row when its count leaves or reaches 0.  Dead keys
        become tombstones (the K4 sweep on the card); the dedup's
        overflow and negative counts add to the agg's counters."""
        cap = chunk.capacity
        d_signs = {}
        for di, agg_idx in enumerate(self._distinct_aggs):
            f = self.aggs[agg_idx].arg.return_field(self.in_schema)
            acol = conform_col(arg_of(agg_idx), f.nullable, cap)
            _, anull = split_col(acol)
            eligible = chunk.valid & (signs != 0)
            if spill_mask is not None:
                # diverted rows replay in the tier's own dedup state
                eligible = eligible & ~spill_mask
            if anull is not None:
                eligible = eligible & ~anull
            fm = filter_mask(agg_idx)
            if fm is not None:
                eligible = eligible & fm
            dt = state.distinct_tables[di]
            _, dslots, dins, dover = dt.lookup_or_insert(key_cols + [acol],
                                                         eligible)
            rank = rank_by(dslots.to(torch.int64), eligible & ~dover)
            d_sign, dead = distinct_dedup(
                state.distinct_counts[di], dslots, dins, eligible, dover,
                rank, signs, state.overflow, state.inconsistency)
            # a (group, value) whose count retracted to 0 frees its slot
            dt.clear_slots(dslots, dead)
            d_signs[agg_idx] = d_sign
        return d_signs

    # ------------------------------------------------------------------
    def _outputs(self, prims: tuple, row_count, slots):
        """Per-emitted-slot output columns from the state tensors."""
        safe = torch.clamp(slots, max=self.table_size - 1).to(torch.int64)
        cols = []
        pi = 0
        for ai, a in enumerate(self.aggs):
            spec = a.spec()
            n = len(spec.states)
            st = tuple(prims[pi + k][safe] for k in range(n))
            pi += n
            out_f = self._out_schema[len(self.group_by) + ai]
            out = spec.output(st, row_count[safe], out_f)
            if ai in self._nn_prim:
                out = NCol(out, prims[self._nn_prim[ai]][safe] == 0)
            cols.append(out)
        return cols

    def _refresh_minput_caches(self, state: AggState, slots) -> None:
        """Recompute the retractable min/max outputs of the emitted
        ``slots`` from their buckets (reference :879), in place."""
        for mi, agg_idx in enumerate(self._minput_aggs):
            pi = next(p for p, (ai, _) in enumerate(self._prim_specs)
                      if ai == agg_idx)
            minput_refresh(state.prims[pi], state.minput_vals[mi],
                           state.minput_occ[mi], slots,
                           self.aggs[agg_idx].kind)

    def flush(self, state: AggState, epoch):
        """Emit up to ``emit_capacity`` dirty groups as a changelog chunk
        of interleaved (old, new) rows; un-emitted dirty groups stay dirty
        for the runtime's next drain round.  Under EMIT ON WINDOW CLOSE,
        the closed windows' final rows instead (``_flush_eowc``)."""
        if self.emit_on_window_close:
            return self._flush_eowc(state)
        cap = self.emit_capacity
        size = self.table_size
        slots = mask_indices(state.dirty, cap, size)
        self._refresh_minput_caches(state, slots)
        slot_live = slots < size
        safe = torch.clamp(slots, max=size - 1).to(torch.int64)
        old_nonempty = state.prev_row_count[safe] > 0
        new_nonempty = state.row_count[safe] > 0
        del_side = slot_live & state.emitted[safe] & old_nonempty
        ins_side = slot_live & new_nonempty

        key_vals = state.table.gather_keys(slots)
        old_cols = self._outputs(state.prev_prims, state.prev_row_count,
                                 slots)
        new_cols = self._outputs(state.prims, state.row_count, slots)
        out_cols = [interleave(k, k) for k in key_vals]
        out_cols += [interleave(o, n) for o, n in zip(old_cols, new_cols)]

        both = del_side & ins_side
        i8 = lambda v: torch.full_like(both, v, dtype=torch.int8)  # noqa: E731
        op_even = torch.where(both, i8(OP_UPDATE_DELETE), i8(OP_DELETE))
        op_odd = torch.where(both, i8(OP_UPDATE_INSERT), i8(OP_INSERT))
        out = Chunk(out_cols, interleave(op_even, op_odd),
                    interleave(del_side, ins_side), self._out_schema)

        # persist current as prev for the emitted slots; clear their dirt
        sel = slot_mask(slots, size)
        for p, c in zip(state.prev_prims, state.prims):
            torch.where(sel, c, p, out=p)
        torch.where(sel, state.row_count, state.prev_row_count,
                    out=state.prev_row_count)
        torch.where(sel, state.row_count > 0, state.emitted,
                    out=state.emitted)
        state.dirty.logical_and_(~sel)
        return state, out

    def _window_key(self, state: AggState):
        return split_col(state.table.key_cols[self.watermark_group_idx])

    def _flush_eowc(self, state: AggState):
        """Final rows of up to ``emit_capacity`` closed windows' groups,
        in slot order (K7e), as an append-only chunk; the emitted groups
        are evicted (the K4 sweep by slot list), their row counts zeroed
        and their dirt cleared (reference :973-1001)."""
        cap = self.emit_capacity
        size = self.table_size
        key, key_null = self._window_key(state)
        slots, _ = eowc_slots(state.table.occupied, key, key_null,
                              self.watermark_lag, state.wm, cap)
        self._refresh_minput_caches(state, slots)
        slot_live = slots < size
        safe = torch.clamp(slots, max=size - 1).to(torch.int64)
        live = slot_live & (state.row_count[safe] > 0)
        out_cols = list(state.table.gather_keys(slots)) + self._outputs(
            state.prims, state.row_count, slots)
        out = Chunk(out_cols, torch.full((cap,), OP_INSERT, dtype=torch.int8,
                                         device=slots.device),
                    live, self._out_schema)
        state.table.clear_slots(slots, slot_live)
        sel = slot_mask(slots, size)
        state.row_count.masked_fill_(sel, 0)
        state.dirty.logical_and_(~sel)
        return state, out

    def drain_spill(self, state: AggState):
        """``(state with an empty ring, Chunk of the diverted rows)``: the
        runtime drains the ring at snapshot barriers into the host tier.
        The chunk's columns are the ring's stores: copy them before the
        next chunk."""
        R = self.spill_ring
        valid = torch.arange(R, dtype=torch.int32,
                             device=state.spill_ops.device) < state.spill_count
        chunk = Chunk(state.spill_rows, state.spill_ops, valid,
                      self.in_schema)
        state.spill_count.zero_()
        return state, chunk

    def reconstructible_from_rows(self) -> bool:
        """True when the agg's whole state round-trips through its own
        input rows (reference :717): plain InputRef keys in order and one
        sum/sum0/min/max call per trailing input column, no materialized
        input, no DISTINCT, no packed string state."""
        n_keys = len(self.group_by)
        for ki, (_, e) in enumerate(self.group_by):
            if not (isinstance(e, InputRef) and e.index == ki):
                return False
        if self._minput_aggs or self._distinct_aggs:
            return False
        for ai, a in enumerate(self.aggs):
            if a.kind not in ("sum", "sum0", "min", "max") \
                    or a.distinct or a.filter is not None:
                return False
            if not (isinstance(a.arg, InputRef)
                    and a.arg.index == n_keys + ai):
                return False
            if self.in_schema[n_keys + ai].data_type.is_string:
                return False
        return len(self.in_schema) == n_keys + len(self.aggs)

    def make_spill_tier(self, table_size: int) -> "HashAggExecutor":
        """A same-shaped aggregation for the host (CPU) overflow tier."""
        return HashAggExecutor(
            table_size=table_size,
            distinct_table_size=max(table_size, self.distinct_table_size),
            **self._ctor_kwargs)

    def pending_flush(self, state: AggState) -> torch.Tensor:
        """Groups awaiting a flush round: the dirty ones, or under EOWC
        the closed ones (K7e's count)."""
        if self.emit_on_window_close:
            key, key_null = self._window_key(state)
            return eowc_slots(state.table.occupied, key, key_null,
                              self.watermark_lag, state.wm, 0)[1]
        return state.dirty.sum(dtype=torch.int64)

    def on_watermark(self, state: AggState, watermark):
        if self.watermark_group_idx is None:
            return state
        if (self.watermark_src_col is not None
                and watermark.col_idx != self.watermark_src_col):
            return state
        state = state._replace(wm=torch.maximum(state.wm, watermark.value))
        if self.emit_on_window_close:
            return state  # emission evicts; nothing is cleaned before
        return self.clean_below(state, self.watermark_group_idx,
                                watermark.value - self.watermark_lag)

    def clean_below(self, state: AggState, key_col_idx: int, threshold):
        """Drop groups whose group key ``key_col_idx`` is below
        ``threshold`` (watermark state cleaning), in place."""
        key, key_null = split_col(state.table.key_cols[key_col_idx])
        stale = state.table.occupied & (key < threshold)
        if key_null is not None:
            stale &= ~key_null
        state.table.clear_where(stale)
        state.row_count.masked_fill_(stale, 0)
        state.dirty.logical_and_(~stale)
        state.prev_row_count.masked_fill_(stale, 0)
        state.emitted.logical_and_(~stale)
        for occ in state.minput_occ:
            occ.logical_and_(~stale[:, None])
        # the dedup keys carry the same group-key prefix: their (group,
        # value) rows leave with the window
        for dt, cnt in zip(state.distinct_tables, state.distinct_counts):
            k, kn = split_col(dt.key_cols[key_col_idx])
            stale_d = dt.occupied & (k < threshold)
            if kn is not None:
                stale_d &= ~kn
            dt.clear_where(stale_d)
            cnt.masked_fill_(stale_d, 0)
        return state

    def maybe_rehash(self, state: AggState) -> AggState:
        """Rebuild the group table once tombstones exceed a quarter of it,
        and the DISTINCT calls' dedup tables (each with its counts) once
        the most tombstoned one passes a quarter of its size
        (maintenance-time; ONE readback of the tombstone counts)."""
        counts = [state.table.tombstone_count()]
        if self._distinct_aggs:
            counts.append(torch.stack([dt.tombstone_count()
                                       for dt in state.distinct_tables]
                                      ).max())
        tombs = torch.stack(counts).tolist()
        if len(tombs) > 1 and tombs[1] > self.distinct_table_size // 4:
            state = self._rehash_distinct(state)
        if tombs[0] <= self.table_size // 4:
            return state
        fresh, moved = state.table.rehashed()
        prims, prev_prims = [], []
        for pi, (_, ps) in enumerate(self._prim_specs):
            init = ps.init(state.prims[pi].dtype)
            prims.append(permute_dense(state.prims[pi], moved, init))
            prev_prims.append(permute_dense(state.prev_prims[pi], moved, init))
        return state._replace(
            table=fresh,
            prims=tuple(prims),
            row_count=permute_dense(state.row_count, moved),
            dirty=permute_dense(state.dirty, moved),
            prev_prims=tuple(prev_prims),
            prev_row_count=permute_dense(state.prev_row_count, moved),
            emitted=permute_dense(state.emitted, moved),
            minput_vals=tuple(permute_dense(v, moved)
                              for v in state.minput_vals),
            minput_occ=tuple(permute_dense(o, moved)
                             for o in state.minput_occ),
        )

    @staticmethod
    def _rehash_distinct(state: AggState) -> AggState:
        """``rehash_d``: every dedup table rebuilt without tombstones
        (K3), its counts moved with their keys (K4)."""
        tables, counts = [], []
        for dt, cnt in zip(state.distinct_tables, state.distinct_counts):
            fresh, moved = dt.rehashed()
            tables.append(fresh)
            counts.append(permute_dense(cnt, moved))
        return state._replace(distinct_tables=tuple(tables),
                              distinct_counts=tuple(counts))
