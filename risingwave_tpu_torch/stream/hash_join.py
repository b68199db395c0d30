"""Streaming hash join: the join matrix over pool and dense sides.

Port of ``risingwave_tpu/stream/hash_join.py``: ``SideState``,
``PoolSideState``, ``JoinState`` and ``JoinEmit`` (:194-330),
``_null_stripped_keys``, ``_empty_store``, ``_pool_capacity``,
``_gather_bucket``, ``_scatter_rows``, ``_rank_by``, ``_rank_by_sorted``,
``_totals_from_sort`` and ``_group_totals`` (:87-190), and of
``HashJoinExecutor`` ``init_state``, ``_update_side`` (:492, dense),
``_update_side_pool`` (:597), ``_bucket_row_hash`` (:685),
``apply_begin`` (:705), ``emit_window`` (:850), ``build_rows_of``,
``max_windows``, ``maybe_rehash`` (``rebuild``, ``rebuild_pool``,
``compact_pool``) and ``clean_below`` (:1036-1146).

Every join type of ``JOIN_TYPES`` runs, over either storage:

- a POOL side keeps ONE ``TagTable`` of ``(key-hash, rank)`` tags over
  a bump-allocated row pool (append-only inputs): the rank-r row of a
  key owns the entry of ``pair_tag(hash, r)``, the key's degree lives at
  its head (rank 0) entry, ``pool_pos`` maps an entry to its pool row
  and ``slot_clean`` holds the window key that watermark cleaning
  compares;
- a DENSE side keeps a ``HashTable`` of join keys and ``[size, B]``
  bucket stores with an occupancy bitmap and a per-key ``count``
  (retractable inputs): inserts claim the rank-th free position of
  their key's bucket, deletes clear the rank-th value-equal entry, and
  a +row and a -row of one value inside a chunk annihilate first.

Emission is output-centric and windowed: the logical array ``[up |
pairs | self | down]`` is cut into ``out_capacity`` windows, and every
output row finds its probe row by a binary search over prefix sums and
its build row by a tag lookup (pool) or as the j-th occupied position of
its key's bucket (dense).  Outer pads, semi rows and
anti rows are the preserved side's self rows; a key whose own-side count
crosses 0 flips the other side's stored rows (up/down transitions, the
first row of the key in the chunk emits them).

On the card the path runs these kernels, each beside its plain version:

- K12 ``tag_insert_ranked`` / ``tag_probe`` (``state/tag_table.py``);
- K13 ``join_update`` (``csrc/join_update.cu``): the segmented rank
  over the chunk's stably sorted key hashes (``torch.sort``), then,
  after K12, the bump allocator, the un-claim of dropped rows, the pool
  row scatter, ``pool_pos`` / ``slot_clean``, the degree add from each
  key's rank-0 row and the counters; its rank launch also gives the
  dense side's delete and insert ranks and the transitions' ``first``;
- K13d ``join_dense`` (``csrc/join_dense.cu``): the dense side update
  after K1's row hashes and K3's key slots: in-chunk annihilation,
  deletes by value, the rank-th free position of the post-delete
  occupancy, the row scatter and the counts;
- K14 ``join_emit`` (``csrc/join_emit.cu``): one emission window, one
  thread per output row, over a pool or a dense build, with pad null
  flags, semi/anti columns and the transitions' op codes;
- K15 ``join_clean`` (``csrc/join_clean.cu``): the watermark clean of a
  pool side (with the table's tombstone and live counts for the rehash
  conditions) and the pool compaction; the rows then move through K4
  ``permute_rows`` (``csrc/permute.cu``), as do the rebuilds' per-slot
  columns, every column of a table in one entry.  A dense side cleans
  with the table's ``clear_where`` and rebuilds through K3 and K4.

State tensors are updated in place where the reference returns a new
tree; the rebuilds and the compaction build new tensors and return a
new state.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from risingwave_tpu_torch import kernels
from risingwave_tpu_torch.common.chunk import (
    OP_DELETE,
    OP_INSERT,
    OP_UPDATE_DELETE,
    OP_UPDATE_INSERT,
    Chunk,
    NCol,
    StrCol,
    split_col,
)
from risingwave_tpu_torch.common.compact import mask_indices
from risingwave_tpu_torch.common.hash import (
    hash64_columns,
    key_leaves,
    leaf_width,
)
from risingwave_tpu_torch.common.types import Field, Schema
from risingwave_tpu_torch.expr.node import Expr
from risingwave_tpu_torch.state.hash_table import (
    HashTable,
    gather_key,
    permute_dense_many,
)
from risingwave_tpu_torch.state.tag_table import TagTable, pair_tag
from risingwave_tpu_torch.stream.materialize import (
    empty_value_col,
    value_leaves,
)

INT64_MIN = -(1 << 63)
INT64_MAX = (1 << 63) - 1

#: the join matrix of the reference
JOIN_TYPES = (
    "inner", "left_outer", "right_outer", "full_outer",
    "left_semi", "left_anti", "right_semi", "right_anti",
)


def _null_stripped_keys(key_cols):
    """(bare key cols, any-key-null mask | None): a NULL join key matches
    nothing, so its rows are masked out of updates and probes."""
    null_any = None
    bare = []
    for c in key_cols:
        d, n = split_col(c)
        bare.append(d)
        if n is not None:
            null_any = n if null_any is None else (null_any | n)
    return bare, null_any


def _pool_capacity(rows: tuple) -> int:
    """Row capacity of a pool side's flat stores."""
    store = rows[0]
    while isinstance(store, NCol):
        store = store.data
    if isinstance(store, StrCol):
        return store.lens.shape[0]
    return store.shape[0]


def _sort_key(group: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """The int64 sort key that orders ``group``'s bit patterns as the
    reference's uint64 (sign bit flipped), inactive rows last under the
    all-ones sentinel (``hash64_columns`` never returns all-ones)."""
    return torch.where(active, group ^ INT64_MIN,
                       torch.full_like(group, INT64_MAX))


def _rank_by_sorted(group: torch.Tensor, active: torch.Tensor):
    """Stable rank of each active row among rows of equal ``group``,
    with the sort artifacts ``(rank, order, seg_id)``."""
    cap = group.shape[0]
    dev = group.device
    sorted_key, order = torch.sort(_sort_key(group, active), stable=True)
    is_new = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                        sorted_key[1:] != sorted_key[:-1]])
    idx = torch.arange(cap, dtype=torch.int32, device=dev)
    start = torch.cummax(torch.where(is_new, idx, torch.zeros_like(idx)),
                         0).values
    seg_id = torch.cumsum(is_new.to(torch.int32), 0) - 1
    rank = torch.zeros(cap, dtype=torch.int32, device=dev)
    rank[order] = idx - start
    return rank, order, seg_id


def _rank_by(group: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Stable rank of each active row among active rows of equal
    ``group`` (int32, row order)."""
    return _rank_by_sorted(group, active)[0]


def _group_totals(group: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Per-row sum of ``values`` over the rows sharing ``group`` (every
    row, active or not; int32)."""
    cap = group.shape[0]
    dev = group.device
    sorted_g, order = torch.sort(group ^ INT64_MIN, stable=True)
    is_new = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                        sorted_g[1:] != sorted_g[:-1]])
    seg_id = torch.cumsum(is_new.to(torch.int32), 0) - 1
    return _totals_from_sort(order, seg_id, values)


def _totals_from_sort(order, seg_id, values) -> torch.Tensor:
    """Per-row group total of ``values`` from a ``_rank_by_sorted``
    decomposition (no second sort)."""
    cap = order.shape[0]
    sums = torch.zeros(cap, dtype=torch.int32, device=order.device)
    sums.index_add_(0, seg_id.to(torch.int64), values[order].to(torch.int32))
    out = torch.zeros(cap, dtype=torch.int32, device=order.device)
    out[order] = sums[seg_id.to(torch.int64)]
    return out


def _set_drop_(dst, idx: torch.Tensor, values, n: int) -> None:
    """In place ``dst[idx] = values`` where ``idx < n`` (the reference's
    ``.at[idx].set(values, mode="drop")``)."""
    keep = idx < n
    pos = idx[keep].to(torch.int64)
    if isinstance(dst, NCol):
        _set_drop_(dst.data, idx, values.data, n)
        dst.null[pos] = values.null[keep]
    elif isinstance(dst, StrCol):
        dst.data[pos] = values.data[keep]
        dst.lens[pos] = values.lens[keep]
    else:
        dst[pos] = values[keep]


def _empty_store(f: Field, size: int, bucket: int, device):
    """A dense side's ``[size, bucket]`` store of one column."""
    if f.data_type.is_string:
        col = StrCol(torch.zeros((size, bucket, f.str_width),
                                 dtype=torch.uint8, device=device),
                     torch.zeros((size, bucket), dtype=torch.int32,
                                 device=device))
    else:
        col = torch.zeros((size, bucket), dtype=f.data_type.physical_dtype,
                          device=device)
    if f.nullable:
        return NCol(col, torch.zeros((size, bucket), dtype=torch.bool,
                                     device=device))
    return col


def _gather_bucket(store, slots: torch.Tensor):
    """``[size, B, ...]`` gathered at ``[cap]`` slots -> ``[cap, B, ...]``."""
    idx = slots.to(torch.int64)
    if isinstance(store, NCol):
        return NCol(_gather_bucket(store.data, slots), store.null[idx])
    if isinstance(store, StrCol):
        return StrCol(store.data[idx], store.lens[idx])
    return store[idx]


def _flat_rows(store):
    """A ``[size, B, ...]`` store as a ``[size * B, ...]`` view (in-place
    writes reach the store)."""
    if isinstance(store, NCol):
        return NCol(_flat_rows(store.data), store.null.reshape(-1))
    if isinstance(store, StrCol):
        return StrCol(store.data.reshape((-1,) + store.data.shape[2:]),
                      store.lens.reshape(-1))
    return store.reshape((-1,) + store.shape[2:])


def _at_bucket(store, slot: torch.Tensor, bidx: torch.Tensor):
    """``store[slot, bidx]`` of a ``[size, B, ...]`` store."""
    if isinstance(store, NCol):
        return NCol(_at_bucket(store.data, slot, bidx), store.null[slot, bidx])
    if isinstance(store, StrCol):
        return StrCol(store.data[slot, bidx], store.lens[slot, bidx])
    return store[slot, bidx]


class PoolSideState(NamedTuple):
    """One pool side: a fused (key-hash, rank) tag table over a
    bump-allocated shared row pool."""

    table: TagTable           # packed (key-hash, rank) tags -> entry slot
    count: torch.Tensor       # int32 [size] key degree, kept at its head
    pool_pos: torch.Tensor    # int32 [size] entry slot -> pool position
    slot_clean: torch.Tensor  # int64 [size] watermark-cleaning key value
    rows: tuple               # [pool] stores, one per input column
    pool_len: torch.Tensor    # int32 () bump-allocator cursor
    overflow: torch.Tensor    # int64 — rows that found no table/pool space
    inconsistency: torch.Tensor  # int64 — retractions on an append-only side


class SideState(NamedTuple):
    """One dense side: a key table over ``[size, B]`` bucket stores."""

    key_table: HashTable
    rows: tuple               # [size, B] stores, one per input column
    occupied: torch.Tensor    # bool [size, B]
    count: torch.Tensor       # int32 [size] live rows per key
    overflow: torch.Tensor    # int64 — rows that found no bucket space
    inconsistency: torch.Tensor  # int64 — deletes with no stored match


class JoinState(NamedTuple):
    left: "PoolSideState | SideState"
    right: "PoolSideState | SideState"
    emit_overflow: torch.Tensor  # int64 — matches dropped
    chunks: torch.Tensor         # int64 — probe chunks applied
    probe_iters: torch.Tensor    # int64 — ranked-insert probe rounds
    emit_rows: torch.Tensor      # int64 — staged emission rows
    emit_windows: torch.Tensor   # int64 — emission windows drained


class JoinEmit(NamedTuple):
    """One chunk's staged emission space ``[up | pairs | self | down]``
    (device tensors; the scalars are 0-d int32)."""

    probe_cols: tuple
    signs: torch.Tensor       # int32 [cap]
    slots: torch.Tensor       # int32 [cap] clamped build-side key slots
    probe_hash: torch.Tensor  # int64 [cap] probe rows' join-key hashes
    m: torch.Tensor           # int32 [cap] live build rows per probe row
    up_cnt: torch.Tensor      # int32 [cap]
    up_end: torch.Tensor      # int32 [cap] inclusive cumsum
    U: torch.Tensor
    pair_end: torch.Tensor    # int32 [cap] inclusive cumsum of pair counts
    P: torch.Tensor
    self_sel: torch.Tensor    # int32 [cap] compacted self-row indices
    S: torch.Tensor
    down_cnt: torch.Tensor    # int32 [cap]
    down_end: torch.Tensor    # int32 [cap] inclusive cumsum
    total: torch.Tensor       # int32 U + P + S + D


# ---------------------------------------------------------------------------
# K13: the pool side update


#: most leaves (payloads, string lengths, null planes) one descriptor
#: holds (``RW_JOIN_LEAVES`` in ``csrc/rw_join.cuh``)
MAX_LEAVES = kernels.MAX_JOIN_LEAVES
#: rows a block of K13's update launches takes (``JOIN_TILE``)
JOIN_TILE = 256


def _leaf_width(t: torch.Tensor) -> int:
    return t.element_size() * (t.shape[1] if t.dim() > 1 else 1)


def _leaf_pairs(stores, cols):
    """Flatten column stores and chunk columns into matching leaves:
    payloads (a string's bytes and lengths) and one null plane per
    nullable column."""
    out = []
    for store, col in zip(stores, cols):
        sl, cl = value_leaves(store), value_leaves(col)
        out += [(sd, d) for (sd, _), (d, _) in zip(sl, cl)]
        if sl[0][1] is not None:
            out.append((sl[0][1].view(torch.uint8),
                         cl[0][1].view(torch.uint8)))
    return out


class _UpdateArgs(ctypes.Structure):
    """Mirror of ``struct JoinUpdateArgs`` in ``csrc/join_update.cu``."""

    _fields_ = [
        ("cols", kernels.JoinCols),
        ("valid", ctypes.c_void_p), ("ops", ctypes.c_void_p),
        ("null_keys", ctypes.c_void_p), ("is_ins", ctypes.c_void_p),
        ("over", ctypes.c_void_p), ("existed", ctypes.c_void_p),
        ("inserted", ctypes.c_void_p), ("slots", ctypes.c_void_p),
        ("rank", ctypes.c_void_p), ("head_slot", ctypes.c_void_p),
        ("order", ctypes.c_void_p), ("seg_start", ctypes.c_void_p),
        ("clean_key", ctypes.c_void_p),
        ("tags", ctypes.c_void_p), ("count", ctypes.c_void_p),
        ("pool_pos", ctypes.c_void_p), ("slot_clean", ctypes.c_void_p),
        ("pool_len", ctypes.c_void_p), ("overflow", ctypes.c_void_p),
        ("inconsistency", ctypes.c_void_p),
        ("got", ctypes.c_void_p), ("tile_counts", ctypes.c_void_p),
        ("cap", ctypes.c_int), ("size", ctypes.c_int), ("pool", ctypes.c_int),
    ]


def _update_side_pool_plain(side: PoolSideState, chunk: Chunk, clean_spec,
                            key_cols, null_keys, h):
    """Plain PyTorch version of the pool side update (K12 + K13), in
    place; returns ``(side, probe rounds int32 scalar)``."""
    size = side.table.size
    pool = _pool_capacity(side.rows)
    signs = chunk.signs()
    joinable = chunk.valid if null_keys is None \
        else chunk.valid & ~null_keys
    is_ins = joinable & (signs > 0)
    n_bad = (joinable & (signs < 0)).sum(dtype=torch.int64)
    cr, sort_order, sort_seg = _rank_by_sorted(h, is_ins)
    (table, slots, _, head_slot, inserted, existed, over,
     iters) = side.table._ranked_plain(h, cr, side.count, is_ins)
    got = is_ins & ~over
    n_overwrite = (got & existed).sum(dtype=torch.int64)
    offs = torch.cumsum(got.to(torch.int32), 0, dtype=torch.int32) - 1
    pos = side.pool_len + offs
    fits = pos < pool
    dropped = got & ~fits
    table.clear_slots(slots, dropped & inserted)
    got = got & fits
    tgt = torch.where(got, pos, torch.full_like(pos, pool))
    for store, col in zip(side.rows, chunk.columns):
        _set_drop_(store, tgt, col, pool)
    safe_slot = torch.clamp(slots, max=size - 1)
    spos = torch.where(got, safe_slot, torch.full_like(safe_slot, size))
    _set_drop_(side.pool_pos, spos, tgt, size)
    if clean_spec is not None:
        _set_drop_(side.slot_clean, spos,
                   key_cols[clean_spec[0]].to(torch.int64), size)
    rep = got & (cr == 0) & (head_slot < size)
    key_tot = _totals_from_sort(sort_order, sort_seg, got)
    ext = torch.cat([side.count, side.count.new_zeros(1)])
    ext.index_add_(0, torch.where(rep, head_slot,
                                  torch.full_like(head_slot, size))
                   .to(torch.int64),
                   torch.where(rep, key_tot, torch.zeros_like(key_tot)))
    side.count.copy_(ext[:size])
    side.pool_len.add_(got.sum(dtype=torch.int32))
    side.overflow.add_((is_ins & over).sum(dtype=torch.int64)
                       + dropped.sum(dtype=torch.int64) + n_overwrite)
    side.inconsistency.add_(n_bad)
    return side, iters


def join_rank_cuda(h: torch.Tensor, is_ins: torch.Tensor):
    """K13's rank kernel after the stable unsigned sort (``torch.sort``):
    ``(rank int32 [cap] in row order, order int64 [cap], seg_start int32
    [cap] in sorted order)``."""
    sorted_key, order = torch.sort(_sort_key(h, is_ins), stable=True)
    cr, seg_start = join_rank_sorted_cuda(sorted_key, order)
    return cr, order, seg_start


def join_rank_sorted_cuda(sorted_key: torch.Tensor, order: torch.Tensor):
    """K13's rank launch over the sort's ``(sorted_key, order)``:
    ``(rank int32 [cap] in row order, seg_start int32 [cap])``."""
    cap = sorted_key.shape[0]
    dev = sorted_key.device
    cr = torch.empty(cap, dtype=torch.int32, device=dev)
    seg_start = torch.empty(cap, dtype=torch.int32, device=dev)
    kernels.require_cuda("join_update", sorted_key, order)
    fn = kernels.entry("join_update", "rw_join_rank", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p])
    kernels.count_launch("join_update")
    kernels.check(fn(sorted_key.data_ptr(), order.data_ptr(), cr.data_ptr(),
                     seg_start.data_ptr(), cap, kernels.stream_ptr(dev)),
                  "join_update")
    return cr, seg_start


def join_update_cuda(side: PoolSideState, chunk: Chunk, clean_spec,
                     key_cols, null_keys, is_ins, ranked, probe) -> None:
    """K13's update kernel, in place, after the ranked insert:
    ``ranked`` is ``join_rank_cuda``'s result and ``probe`` K12's
    ``(table, slots, target, head_slot, inserted, existed, overflow,
    iters)``."""
    cr, order, seg_start = ranked
    table, slots, _, head_slot, inserted, existed, over, _ = probe
    size = side.table.size
    cap = chunk.capacity
    dev = chunk.device
    a = _UpdateArgs()
    leaves = _leaf_pairs(side.rows, chunk.columns)
    if len(leaves) > MAX_LEAVES:
        raise ValueError(f"more than {MAX_LEAVES} column leaves")
    keep = []
    a.cols.n = len(leaves)
    for k, (st, d) in enumerate(leaves):
        d = d.contiguous()
        keep += [st, d]
        a.cols.width[k] = _leaf_width(d)
        a.cols.from_probe[k] = 1
        a.cols.src[k] = d.data_ptr()
        a.cols.dst[k] = st.data_ptr()
    valid_u8 = chunk.valid.contiguous().view(torch.uint8)
    ops = chunk.ops.contiguous()
    ins_u8 = is_ins.contiguous().view(torch.uint8)
    nk = None if null_keys is None else null_keys.contiguous().view(
        torch.uint8)
    ckey = None
    if clean_spec is not None:
        ckey = key_cols[clean_spec[0]].to(torch.int64).contiguous()
        keep.append(ckey)
    got = torch.empty(cap, dtype=torch.uint8, device=dev)
    tile_counts = torch.empty(-(-cap // JOIN_TILE), dtype=torch.int32,
                              device=dev)
    kernels.require_cuda("join_update", valid_u8, ops, ins_u8, table.tags,
                         side.count, side.pool_pos, side.slot_clean,
                         side.pool_len, side.overflow, side.inconsistency,
                         slots, cr, head_slot, order, seg_start, *keep)
    a.valid, a.ops, a.null_keys = valid_u8.data_ptr(), ops.data_ptr(), \
        kernels.ptr(nk)
    a.is_ins, a.over = ins_u8.data_ptr(), over.view(torch.uint8).data_ptr()
    a.existed = existed.view(torch.uint8).data_ptr()
    a.inserted = inserted.view(torch.uint8).data_ptr()
    a.slots, a.rank, a.head_slot = slots.data_ptr(), cr.data_ptr(), \
        head_slot.data_ptr()
    a.order, a.seg_start = order.data_ptr(), seg_start.data_ptr()
    a.clean_key = kernels.ptr(ckey)
    a.tags, a.count = table.tags.data_ptr(), side.count.data_ptr()
    a.pool_pos, a.slot_clean = side.pool_pos.data_ptr(), \
        side.slot_clean.data_ptr()
    a.pool_len, a.overflow = side.pool_len.data_ptr(), \
        side.overflow.data_ptr()
    a.inconsistency = side.inconsistency.data_ptr()
    a.got, a.tile_counts = got.data_ptr(), tile_counts.data_ptr()
    a.cap, a.size, a.pool = cap, size, _pool_capacity(side.rows)
    fn = kernels.entry("join_update", "rw_join_update",
                       [_UpdateArgs, ctypes.c_void_p])
    kernels.count_launch("join_update")
    kernels.check(fn(a, kernels.stream_ptr(dev)), "join_update")


def insert_mask(chunk: Chunk, null_keys) -> torch.Tensor:
    """Joinable inserts: valid Insert / UpdateInsert rows, no NULL key."""
    ins_like = (chunk.ops == OP_INSERT) | (chunk.ops == OP_UPDATE_INSERT)
    is_ins = chunk.valid & ins_like
    return is_ins if null_keys is None else is_ins & ~null_keys


def _update_side_pool_cuda(side: PoolSideState, chunk: Chunk, clean_spec,
                           key_cols, null_keys, h):
    """K13 around K12: the stable key sort and the rank kernel, the
    ranked insert, then the update kernel; no host sync."""
    is_ins = insert_mask(chunk, null_keys)
    ranked = join_rank_cuda(h, is_ins)
    probe = side.table.lookup_or_insert_ranked(h, ranked[0], side.count,
                                               is_ins)
    join_update_cuda(side, chunk, clean_spec, key_cols, null_keys, is_ins,
                     ranked, probe)
    return side, probe[-1]


def update_side_pool(side: PoolSideState, chunk: Chunk, clean_spec,
                     key_cols, null_keys, h):
    """Apply an append-only chunk to a pool side, in place; CUDA
    tensors run K12 and K13."""
    impl = _update_side_pool_cuda if chunk.device.type == "cuda" \
        else _update_side_pool_plain
    return impl(side, chunk, clean_spec, key_cols, null_keys, h)


# ---------------------------------------------------------------------------
# K13d: the dense side update


def rank_by(group: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """``_rank_by``; CUDA tensors run K13's rank launch after the stable
    unsigned sort."""
    if group.device.type == "cuda":
        return join_rank_cuda(group, active)[0]
    return _rank_by(group, active)


def bucket_row_hash(side: SideState, safe_slots: torch.Tensor):
    """Row hashes of a dense side's buckets at ``[cap]`` slots:
    ``[cap, B]`` (``_bucket_row_hash``)."""
    cols = [_flat_rows(_gather_bucket(store, safe_slots))
            for store in side.rows]
    return hash64_columns(cols).reshape(safe_slots.shape[0],
                                        side.occupied.shape[1])


def _first_true(onehot: torch.Tensor) -> torch.Tensor:
    """Index of the first True of each row (0 when none: ``argmax``)."""
    return torch.argmax(onehot.to(torch.int8), dim=1).to(torch.int64)


def update_side_dense_plain(side: SideState, chunk: Chunk, key_cols,
                            null_keys, h) -> SideState:
    """Plain PyTorch version of the dense side update (K1, K13's ranks,
    K3 and K13d), in place."""
    B = side.occupied.shape[1]
    size = side.key_table.size
    signs = chunk.signs()
    joinable = chunk.valid if null_keys is None \
        else chunk.valid & ~null_keys
    is_ins = joinable & (signs > 0)
    is_del = joinable & (signs < 0)
    # in-chunk annihilation: a +row and a -row of one value cancel (the
    # delete pass sees only the pre-chunk state)
    row_hash = hash64_columns(list(chunk.columns))
    ins_rank_h = _rank_by(row_hash, is_ins)
    del_rank_h = _rank_by(row_hash, is_del)
    n_ins_h = _group_totals(row_hash, is_ins)
    n_del_h = _group_totals(row_hash, is_del)
    is_ins = is_ins & ~(ins_rank_h < n_del_h)
    is_del = is_del & ~(del_rank_h < n_ins_h)
    # key slots: inserts may create, deletes only look up
    table, slots_ins, _, overflow = side.key_table.lookup_or_insert(
        key_cols, is_ins, hashes=h)
    is_ins = is_ins & ~overflow
    slots_del, found_del, probe_over = table.lookup_counted(
        key_cols, is_del, hashes=h)
    n_missing = (is_del & ~found_del).sum(dtype=torch.int64)
    is_del = is_del & found_del
    safe_ins = torch.clamp(slots_ins, max=size - 1).to(torch.int64)
    safe_del = torch.clamp(slots_del, max=size - 1).to(torch.int64)
    occ_flat = side.occupied.view(-1)
    # deletes: clear the rank-th value-equal entry
    del_rank = _rank_by(row_hash, is_del)
    val_match = side.occupied[safe_del] & (
        bucket_row_hash(side, safe_del) == row_hash[:, None])
    match_rank = torch.cumsum(val_match.to(torch.int32), 1) - 1
    clear = val_match & (match_rank == del_rank[:, None]) & is_del[:, None]
    any_clear = clear.any(dim=1)
    n_missing = n_missing + (is_del & ~any_clear).sum(dtype=torch.int64)
    occ_flat[(safe_del * B + _first_true(clear))[any_clear]] = False
    side.count.index_add_(0, safe_del[any_clear], torch.full_like(
        safe_del[any_clear], -1, dtype=torch.int32))
    # inserts: claim the rank-th free position of the post-delete bucket
    ins_rank = _rank_by(slots_ins.to(torch.int64), is_ins)
    free = ~side.occupied[safe_ins]
    free_rank = torch.cumsum(free.to(torch.int32), 1) - 1
    take = free & (free_rank == ins_rank[:, None]) & is_ins[:, None]
    got = take.any(dim=1)
    flat_take = torch.where(got, safe_ins * B + _first_true(take),
                            torch.full_like(safe_ins, size * B))
    occ_flat[flat_take[got]] = True
    for store, col in zip(side.rows, chunk.columns):
        _set_drop_(_flat_rows(store), flat_take, col, size * B)
    side.count.index_add_(0, safe_ins[got], torch.ones_like(
        safe_ins[got], dtype=torch.int32))
    side.overflow.add_((is_ins & ~got).sum(dtype=torch.int64)
                       + overflow.sum(dtype=torch.int64) + probe_over)
    side.inconsistency.add_(n_missing)
    return side


def bucket_cancel_cuda(lib: str, row_hash: torch.Tensor,
                       is_ins: torch.Tensor, is_del: torch.Tensor):
    """The bucket annihilation launch of library ``lib`` (K13d's
    ``join_dense`` or K6m's ``agg_minput``, both from ``rw_bucket.cuh``)
    after one stable sort of the rows' hashes (``torch.sort``):
    ``(is_ins, is_del, del_rank)`` with the cancelled pairs removed and
    each surviving delete's int32 rank among the surviving deletes of
    equal hash (0 elsewhere)."""
    cap = row_hash.shape[0]
    dev = row_hash.device
    sorted_key, order = torch.sort(_sort_key(row_hash, is_ins | is_del),
                                   stable=True)
    ins_u8 = is_ins.contiguous().view(torch.uint8)
    del_u8 = is_del.contiguous().view(torch.uint8)
    out_ins = torch.empty(cap, dtype=torch.uint8, device=dev)
    out_del = torch.empty(cap, dtype=torch.uint8, device=dev)
    del_rank = torch.empty(cap, dtype=torch.int32, device=dev)
    scratch = torch.empty(5 * cap, dtype=torch.int32, device=dev)
    kernels.require_cuda(lib, sorted_key, order, ins_u8, del_u8, out_ins,
                         out_del, del_rank, scratch)
    fn = kernels.entry(lib, "rw_bucket_cancel", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p])
    kernels.count_launch(lib)
    kernels.check(fn(sorted_key.data_ptr(), order.data_ptr(),
                     ins_u8.data_ptr(), del_u8.data_ptr(),
                     out_ins.data_ptr(), out_del.data_ptr(),
                     del_rank.data_ptr(), scratch.data_ptr(), cap,
                     kernels.stream_ptr(dev)), lib)
    return out_ins.view(torch.bool), out_del.view(torch.bool), del_rank


class _DenseArgs(ctypes.Structure):
    """Mirror of ``struct JoinDenseArgs`` in ``csrc/join_dense.cu``."""

    _fields_ = [
        ("cols", kernels.JoinCols), ("hash", kernels.RwCols),
        ("row_hash", ctypes.c_void_p),
        ("is_ins", ctypes.c_void_p), ("ins_over", ctypes.c_void_p),
        ("slots_ins", ctypes.c_void_p), ("ins_rank", ctypes.c_void_p),
        ("is_del", ctypes.c_void_p), ("found_del", ctypes.c_void_p),
        ("slots_del", ctypes.c_void_p), ("del_rank", ctypes.c_void_p),
        ("probe_over", ctypes.c_void_p),
        ("occupied", ctypes.c_void_p), ("count", ctypes.c_void_p),
        ("overflow", ctypes.c_void_p), ("inconsistency", ctypes.c_void_p),
        ("clear_pos", ctypes.c_void_p), ("take_pos", ctypes.c_void_p),
        ("cap", ctypes.c_int), ("size", ctypes.c_int), ("B", ctypes.c_int),
    ]


def join_dense_cuda(side: SideState, chunk: Chunk, row_hash, is_ins,
                    ins_over, slots_ins, ins_rank, is_del, found_del,
                    slots_del, del_rank, probe_over) -> None:
    """K13d's update launch (``csrc/join_dense.cu``), in place: deletes
    by value (each stored entry hashed with K1's device function), then
    inserts into the rank-th free position of the post-delete occupancy,
    the row scatter and the counts."""
    cap = chunk.capacity
    dev = chunk.device
    B = side.occupied.shape[1]
    a = _DenseArgs()
    flat = [_flat_rows(s) for s in side.rows]
    leaves = _leaf_pairs(flat, chunk.columns)
    if len(leaves) > MAX_LEAVES:
        raise ValueError(f"more than {MAX_LEAVES} column leaves")
    keep = []
    a.cols.n = len(leaves)
    for k, (st, d) in enumerate(leaves):
        d = d.contiguous()
        keep += [st, d]
        a.cols.width[k] = _leaf_width(d)
        a.cols.from_probe[k] = 1
        a.cols.src[k] = d.data_ptr()
        a.cols.dst[k] = st.data_ptr()
    hl = key_leaves(flat)
    a.hash.n = len(hl)
    for k, (d, nl, kind) in enumerate(hl):
        nu8 = None if nl is None else nl.view(torch.uint8)
        keep += [d] + ([nu8] if nu8 is not None else [])
        a.hash.width[k] = leaf_width(d)
        a.hash.in_data[k] = d.data_ptr()
        a.hash.in_null[k] = kernels.ptr(nu8)
        a.hash.kind[k] = kind
    u8 = lambda t: t.contiguous().view(torch.uint8)  # noqa: E731
    flags = [u8(t) for t in (is_ins, ins_over, is_del, found_del)]
    ints = [t.contiguous() for t in (slots_ins, ins_rank, slots_del,
                                     del_rank)]
    row_hash = row_hash.contiguous()
    probe_over = probe_over.to(torch.int64).reshape(()).contiguous()
    scratch = torch.empty(2 * cap, dtype=torch.int32, device=dev)
    occ_u8 = side.occupied.view(torch.uint8)
    kernels.require_cuda("join_dense", row_hash, probe_over, occ_u8,
                         side.count, side.overflow, side.inconsistency,
                         scratch, *flags, *ints, *keep)
    a.row_hash = row_hash.data_ptr()
    a.is_ins, a.ins_over, a.is_del, a.found_del = (
        t.data_ptr() for t in flags)
    a.slots_ins, a.ins_rank, a.slots_del, a.del_rank = (
        t.data_ptr() for t in ints)
    a.probe_over = probe_over.data_ptr()
    a.occupied, a.count = occ_u8.data_ptr(), side.count.data_ptr()
    a.overflow = side.overflow.data_ptr()
    a.inconsistency = side.inconsistency.data_ptr()
    a.clear_pos = scratch.data_ptr()
    a.take_pos = scratch[cap:].data_ptr()
    a.cap, a.size, a.B = cap, side.key_table.size, B
    fn = kernels.entry("join_dense", "rw_join_dense",
                       [_DenseArgs, ctypes.c_void_p])
    kernels.count_launch("join_dense")
    kernels.check(fn(a, kernels.stream_ptr(dev)), "join_dense")


def dense_update_args_cuda(side: SideState, chunk: Chunk, key_cols,
                           null_keys, h) -> tuple:
    """The inputs of K13d's update launch: K1's row hashes, the
    annihilation launch, K3's key slots (inserts claim theirs) and K13's
    ranks; no host sync."""
    signs = chunk.signs()
    joinable = chunk.valid if null_keys is None \
        else chunk.valid & ~null_keys
    row_hash = hash64_columns(list(chunk.columns))
    # the deletes rank among those K3 found, so the annihilation's rank
    # is not theirs
    is_ins, is_del, _ = bucket_cancel_cuda(
        "join_dense", row_hash, joinable & (signs > 0),
        joinable & (signs < 0))
    table, slots_ins, _, ins_over = side.key_table.lookup_or_insert(
        key_cols, is_ins, hashes=h)
    slots_del, found_del, probe_over = table.lookup_counted(
        key_cols, is_del, hashes=h)
    del_rank = rank_by(row_hash, is_del & found_del)
    ins_rank = rank_by(slots_ins.to(torch.int64), is_ins & ~ins_over)
    return (row_hash, is_ins, ins_over, slots_ins, ins_rank, is_del,
            found_del, slots_del, del_rank, probe_over)


def _update_side_dense_cuda(side: SideState, chunk: Chunk, key_cols,
                            null_keys, h) -> SideState:
    """K13d around K1, K13's ranks and K3; no host sync."""
    join_dense_cuda(side, chunk, *dense_update_args_cuda(
        side, chunk, key_cols, null_keys, h))
    return side


def update_side_dense(side: SideState, chunk: Chunk, key_cols, null_keys,
                      h) -> SideState:
    """Apply a retractable chunk to a dense side, in place; CUDA tensors
    run K13d."""
    impl = _update_side_dense_cuda if chunk.device.type == "cuda" \
        else update_side_dense_plain
    return impl(side, chunk, key_cols, null_keys, h)


# ---------------------------------------------------------------------------
# K14: one emission window


def _decode(end, cnt, pos, cap):
    """Row index and within-row offset of ``pos`` in a cumsum section."""
    r = torch.clamp(torch.searchsorted(end, pos, right=True),
                    max=cap - 1).to(torch.int64)
    return r, pos - (end[r] - cnt[r])


class EmitSpec(NamedTuple):
    """What a window writes, fixed per join and probe side: ``layout``
    lists the output columns as ``(from_probe, column index, pad)`` with
    pad 0 (none), 1 (NULL on transition rows) or 2 (NULL on self rows);
    ``ops_updown`` the transitions' op codes."""

    layout: tuple
    emit_pairs: bool
    ops_updown: tuple


def rank_to_idx_of(occ: torch.Tensor) -> torch.Tensor:
    """The bucket index of each row's k-th live build row, live rows
    first (the stable argsort of the free flags, int32 [n, B]): the
    reference's ``rank_to_idx``.  ``occ`` is the build buckets'
    occupancy at the rows' key slots, all False where the key has no
    live rows."""
    return torch.argsort((~occ).to(torch.int8), dim=1,
                         stable=True).to(torch.int32)


def _padded(col, is_pad: torch.Tensor):
    """A column with the pad rows' null flags ORed in (``pad_null``)."""
    if isinstance(col, NCol):
        return NCol(col.data, col.null | is_pad)
    return NCol(col, is_pad)


def emit_window_plain(build_rows, index, p: JoinEmit, w: int, out_cap: int,
                      spec: EmitSpec):
    """Plain PyTorch version of kernel K14: ``(columns, ops, valid,
    probe_bound)`` of window ``w``.  ``index`` addresses the build rows:
    ``("pool", tag table, pool_pos)`` or ``("dense", occupied)``."""
    cap = p.signs.shape[0]
    dev = p.signs.device
    gpos = w * out_cap + torch.arange(out_cap, dtype=torch.int32, device=dev)
    valid_out = gpos < p.total
    in_up = valid_out & (gpos < p.U)
    ppos = gpos - p.U
    in_pairs = valid_out & (gpos >= p.U) & (ppos < p.P)
    spos = ppos - p.P
    in_self = valid_out & (ppos >= p.P) & (spos < p.S)
    dpos = spos - p.S
    in_down = valid_out & (spos >= p.S)
    in_trans = in_up | in_down
    pair_cnt = p.m if spec.emit_pairs else torch.zeros_like(p.m)
    ur, uj = _decode(p.up_end, p.up_cnt, gpos, cap)
    pr, pj = _decode(p.pair_end, pair_cnt, ppos, cap)
    sr = p.self_sel[torch.clamp(spos, 0, cap - 1).to(torch.int64)] \
        .to(torch.int64)
    dr, dj = _decode(p.down_end, p.down_cnt, dpos, cap)
    r = torch.where(in_up, ur, torch.where(in_pairs, pr,
                                           torch.where(in_self, sr, dr)))
    zero = torch.zeros_like(uj)
    j = torch.where(in_up, uj, torch.where(in_pairs, pj,
                                           torch.where(in_down, dj, zero)))
    probe_bound = torch.zeros((), dtype=torch.int64, device=dev)
    if index[0] == "pool":
        _, btable, bpool_pos = index
        need = in_pairs | in_trans
        pool = _pool_capacity(build_rows)
        _, bslot, bfound, boverflow, _ = btable._probe_tags_plain(
            pair_tag(p.probe_hash[r], j.to(torch.int32)), need,
            insert=False)
        probe_bound = (boverflow & need).sum(dtype=torch.int64)
        bpos = torch.clamp(bpool_pos[torch.clamp(bslot, max=btable.size - 1)
                                     .to(torch.int64)], 0, pool - 1) \
            .to(torch.int64)
        valid_out = valid_out & (~need | bfound)

        def build_val(store):
            return gather_key(store, bpos)
    else:
        # the reference's rank_to_idx[r, clip(j, 0, B - 1)], for the
        # window's rows only (a key with no live rows reads all free)
        occupied = index[1]
        slot = p.slots[r].to(torch.int64)
        B = occupied.shape[1]
        occ = occupied[slot] & (p.m[r] > 0)[:, None]
        bidx = rank_to_idx_of(occ).gather(
            1, torch.clamp(j, 0, B - 1).to(torch.int64)[:, None])[:, 0] \
            .to(torch.int64)

        def build_val(store):
            return _at_bucket(store, slot, bidx)
    cols = []
    for from_probe, ci, pad in spec.layout:
        col = gather_key(p.probe_cols[ci], r) if from_probe \
            else build_val(build_rows[ci])
        if pad:
            col = _padded(col, in_trans if pad == 1 else in_self)
        cols.append(col)
    sign_r = p.signs[r]
    base_op = torch.where(sign_r > 0,
                          torch.full_like(sign_r, OP_INSERT),
                          torch.full_like(sign_r, OP_DELETE))
    up_op, down_op = spec.ops_updown
    ops = torch.where(in_up, torch.full_like(sign_r, up_op),
                      torch.where(in_down, torch.full_like(sign_r, down_op),
                                  base_op)).to(torch.int8)
    return cols, ops, valid_out, probe_bound


class _EmitArgs(ctypes.Structure):
    """Mirror of ``struct JoinEmitArgs`` in ``csrc/join_emit.cu``."""

    _fields_ = [
        ("cols", kernels.JoinCols),
        ("up_end", ctypes.c_void_p), ("up_cnt", ctypes.c_void_p),
        ("pair_end", ctypes.c_void_p), ("m", ctypes.c_void_p),
        ("self_sel", ctypes.c_void_p), ("down_end", ctypes.c_void_p),
        ("down_cnt", ctypes.c_void_p), ("U", ctypes.c_void_p),
        ("P", ctypes.c_void_p), ("S", ctypes.c_void_p),
        ("total", ctypes.c_void_p), ("probe_hash", ctypes.c_void_p),
        ("signs", ctypes.c_void_p), ("tags", ctypes.c_void_p),
        ("pool_pos", ctypes.c_void_p), ("occupied", ctypes.c_void_p),
        ("slots", ctypes.c_void_p), ("live", ctypes.c_void_p),
        ("ops", ctypes.c_void_p), ("valid", ctypes.c_void_p),
        ("probe_bound", ctypes.c_void_p),
        ("w", ctypes.c_longlong), ("out_cap", ctypes.c_int),
        ("cap", ctypes.c_int), ("size", ctypes.c_int), ("pool", ctypes.c_int),
        ("max_iters", ctypes.c_int), ("up_op", ctypes.c_int),
        ("down_op", ctypes.c_int), ("dense", ctypes.c_int),
        ("B", ctypes.c_int),
    ]


def _empty_like_rows(col, n: int):
    """An uninitialised [n] column of ``col``'s structure."""
    if isinstance(col, NCol):
        return NCol(_empty_like_rows(col.data, n),
                    torch.empty(n, dtype=torch.bool, device=col.null.device))
    if isinstance(col, StrCol):
        return StrCol(torch.empty((n,) + col.data.shape[1:],
                                  dtype=col.data.dtype,
                                  device=col.data.device),
                      torch.empty(n, dtype=col.lens.dtype,
                                  device=col.lens.device))
    return torch.empty((n,) + col.shape[1:], dtype=col.dtype,
                       device=col.device)


def emit_window_cuda(build_rows, index, p: JoinEmit, w: int, out_cap: int,
                     spec: EmitSpec):
    """Kernel K14 (``csrc/join_emit.cu``): one launch per window."""
    dev = p.signs.device
    dense = index[0] == "dense"
    if dense:
        build_rows = [_flat_rows(s) for s in build_rows]
    a = _EmitArgs()
    keep = []
    cols = []
    k = 0

    def add(dst, src, from_probe, pad=0):
        nonlocal k
        if k >= MAX_LEAVES:
            raise ValueError(f"more than {MAX_LEAVES} column leaves")
        if src is not None:
            src = src.contiguous()
            keep.append(src)
        keep.append(dst)
        a.cols.width[k] = 1 if pad else _leaf_width(src)
        a.cols.from_probe[k] = int(from_probe)
        a.cols.pad[k] = pad
        a.cols.src[k] = kernels.ptr(src)
        a.cols.dst[k] = dst.data_ptr()
        k += 1

    for from_probe, ci, pad in spec.layout:
        src_col = p.probe_cols[ci] if from_probe else build_rows[ci]
        data, null = split_col(src_col)
        out = _empty_like_rows(data, out_cap)
        for dst, src in _leaf_pairs([out], [data]):
            add(dst, src, from_probe)
        if pad or null is not None:
            out_null = torch.empty(out_cap, dtype=torch.bool, device=dev)
            add(out_null.view(torch.uint8),
                None if null is None else null.view(torch.uint8),
                from_probe, pad)
            out = NCol(out, out_null)
        cols.append(out)
    a.cols.n = k
    ops = torch.empty(out_cap, dtype=torch.int8, device=dev)
    valid = torch.empty(out_cap, dtype=torch.bool, device=dev)
    probe_bound = torch.zeros((), dtype=torch.int64, device=dev)
    pair_cnt = p.m if spec.emit_pairs else torch.zeros_like(p.m)
    arrays = [p.up_end, p.up_cnt, p.pair_end, pair_cnt, p.self_sel,
              p.down_end, p.down_cnt, p.U, p.P, p.S, p.total, p.signs]
    for t in arrays:
        if t.dtype != torch.int32:
            raise ValueError("join_emit: int32 emission arrays expected")
    if dense:
        occ = index[1]
        idx = [p.probe_hash, occ.view(torch.uint8), p.slots, p.m]
        a.occupied, a.slots, a.live = (t.data_ptr() for t in idx[1:])
        a.size, a.pool, a.B = occ.shape[0], 1, occ.shape[1]
    else:
        _, btable, bpool_pos = index
        idx = [p.probe_hash, btable.tags, bpool_pos]
        a.tags, a.pool_pos = btable.tags.data_ptr(), bpool_pos.data_ptr()
        a.size, a.pool = btable.size, _pool_capacity(build_rows)
        a.max_iters = min(btable.size + 2, 1024)
    kernels.require_cuda("join_emit", *arrays, *idx, ops, valid, *keep)
    (a.up_end, a.up_cnt, a.pair_end, a.m, a.self_sel, a.down_end,
     a.down_cnt, a.U, a.P, a.S, a.total, a.signs) = (
        t.data_ptr() for t in arrays)
    a.probe_hash = p.probe_hash.data_ptr()
    a.ops, a.valid = ops.data_ptr(), valid.data_ptr()
    a.probe_bound = probe_bound.data_ptr()
    a.w, a.out_cap, a.cap = w, out_cap, p.signs.shape[0]
    a.up_op, a.down_op = spec.ops_updown
    a.dense = int(dense)
    fn = kernels.entry("join_emit", "rw_join_emit",
                       [_EmitArgs, ctypes.c_void_p])
    kernels.count_launch("join_emit")
    kernels.check(fn(a, kernels.stream_ptr(dev)), "join_emit")
    return cols, ops, valid, probe_bound


def emit_window(build_rows, index, p: JoinEmit, w: int, out_cap: int,
                spec: EmitSpec):
    """One emission window; CUDA tensors launch kernel K14."""
    impl = emit_window_cuda if p.signs.device.type == "cuda" \
        else emit_window_plain
    return impl(build_rows, index, p, w, out_cap, spec)


# ---------------------------------------------------------------------------
# K15: watermark cleaning and pool compaction


def clean_pool_plain(s: PoolSideState, threshold: torch.Tensor):
    """Plain PyTorch version of K15's clean, in place: entries whose
    window key is below ``threshold`` become tombstones and their degree
    0.  Returns int32 [2]: the table's tombstones and live entries
    after the clean."""
    stale = s.table.occupied & (s.slot_clean < threshold)
    s.table.clear_where(stale)
    s.count.masked_fill_(stale, 0)
    return torch.stack([s.table.tombstone_count(), s.table.count()])


def clean_pool_cuda(s: PoolSideState, threshold: torch.Tensor):
    """K15 clean (``csrc/join_clean.cu``): one elementwise pass that also
    counts tombstones and live entries."""
    dev = s.count.device
    stats = torch.zeros(2, dtype=torch.int32, device=dev)
    thr = threshold.to(torch.int64).reshape(()).contiguous()
    kernels.require_cuda("join_clean", s.table.tags, s.count, s.slot_clean,
                         thr, stats)
    fn = kernels.entry("join_clean", "rw_join_clean", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    kernels.count_launch("join_clean")
    kernels.check(fn(s.table.tags.data_ptr(), s.count.data_ptr(),
                     s.slot_clean.data_ptr(), thr.data_ptr(),
                     stats.data_ptr(), s.table.size,
                     kernels.stream_ptr(dev)), "join_clean")
    return stats


def clean_pool(s: PoolSideState, threshold: torch.Tensor):
    impl = clean_pool_cuda if s.count.device.type == "cuda" \
        else clean_pool_plain
    return impl(s, threshold)


def compact_pool_plain(s: PoolSideState) -> PoolSideState:
    """Plain PyTorch version of K15's compaction: live rows move to a
    dense prefix of the pool in slot order, the cursor resets."""
    pool = _pool_capacity(s.rows)
    occ = s.table.occupied
    new_pos = torch.cumsum(occ.to(torch.int32), 0, dtype=torch.int32) - 1
    moved = torch.full((pool + 1,), pool, dtype=torch.int32,
                       device=occ.device)
    src = torch.where(occ, s.pool_pos, torch.full_like(s.pool_pos, pool))
    moved[src.to(torch.int64)] = torch.where(occ, new_pos,
                                             torch.full_like(new_pos, pool))
    moved = moved[:pool]
    return s._replace(
        rows=tuple(permute_dense_many(s.rows, moved)),
        pool_pos=torch.where(occ, new_pos, s.pool_pos),
        pool_len=occ.sum(dtype=torch.int32),
    )


#: slots per block of the compaction scan (CP_TILE in join_clean.cu)
_CP_TILE = 1024


def compact_pool_cuda(s: PoolSideState) -> PoolSideState:
    """K15 compaction (``csrc/join_clean.cu``): tile counts, one-block
    scan of the tiles, per-tile scan writing ``moved``, ``pool_pos`` and
    ``pool_len``; the rows then move in one K4 entry (``permute.cu``)."""
    pool = _pool_capacity(s.rows)
    size = s.table.size
    dev = s.count.device
    pool_pos = s.pool_pos.clone()
    pool_len = torch.empty((), dtype=torch.int32, device=dev)
    moved = torch.empty(pool, dtype=torch.int32, device=dev)
    tiles = torch.empty(-(-size // _CP_TILE), dtype=torch.int32, device=dev)
    kernels.require_cuda("join_clean", s.table.tags, pool_pos, pool_len,
                         moved, tiles)
    fn = kernels.entry("join_clean", "rw_join_compact", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    kernels.count_launch("join_clean")
    kernels.check(fn(s.table.tags.data_ptr(), pool_pos.data_ptr(),
                     moved.data_ptr(), pool_len.data_ptr(),
                     tiles.data_ptr(), size, pool,
                     kernels.stream_ptr(dev)), "join_clean")
    return s._replace(rows=tuple(permute_dense_many(s.rows, moved)),
                      pool_pos=pool_pos, pool_len=pool_len)


def compact_pool(s: PoolSideState) -> PoolSideState:
    impl = compact_pool_cuda if s.count.device.type == "cuda" \
        else compact_pool_plain
    return impl(s)


def rebuild_pool(s: PoolSideState) -> PoolSideState:
    """Rehash the tag table (K12 insert on the card); only the dense
    per-slot companions move (pool rows are addressed through
    ``pool_pos``)."""
    fresh, moved = s.table.rehashed()
    count, pool_pos, slot_clean = permute_dense_many(
        [s.count, s.pool_pos, s.slot_clean], moved)
    return s._replace(table=fresh, count=count, pool_pos=pool_pos,
                      slot_clean=slot_clean)


def rebuild_dense(s: SideState) -> SideState:
    """Rehash a dense side's key table (K3 on the card); the buckets,
    the occupancy and the counts move with their keys (K4)."""
    fresh, moved = s.key_table.rehashed()
    out = permute_dense_many([*s.rows, s.occupied, s.count], moved)
    return s._replace(key_table=fresh, rows=tuple(out[:-2]),
                      occupied=out[-2], count=out[-1])


def clean_dense(s: SideState, key_col_idx: int,
                threshold: torch.Tensor) -> torch.Tensor:
    """A dense side's watermark clean, in place: keys whose
    ``key_col_idx``-th column is below ``threshold`` tombstone, their
    buckets empty and their counts drop to 0.  Returns int32 [2]: the
    table's tombstones and live keys after the clean."""
    key = s.key_table.key_cols[key_col_idx]
    stale = s.key_table.occupied & (key < threshold)
    s.key_table.clear_where(stale)
    s.occupied.logical_and_(~stale[:, None])
    s.count.masked_fill_(stale, 0)
    return table_stats(s)


def rehash_conditions(s, stats: torch.Tensor):
    """(rebuild, compact) device bools of ``maybe_rehash`` from the
    table's [tombstones, live] ``stats`` (a dense side never compacts)."""
    if isinstance(s, SideState):
        rebuild = stats[0] > s.key_table.size // 4
        return rebuild, torch.zeros_like(rebuild)
    pool = _pool_capacity(s.rows)
    rebuild = stats[0] > s.table.size // 4
    dead = s.pool_len - stats[1]
    compact = (s.pool_len >= pool - pool // 4) & (dead > pool // 8)
    return rebuild, compact


def table_stats(s) -> torch.Tensor:
    if isinstance(s, SideState):
        t = s.key_table
        return torch.stack([t.tombstone_count(),
                            t.occupied.sum(dtype=torch.int64)]) \
            .to(torch.int32)
    return torch.stack([s.table.tombstone_count(), s.table.count()])


# ---------------------------------------------------------------------------


class HashJoinExecutor:
    """Equi-join of two changelog streams, every join type of
    ``JOIN_TYPES``; the DAG runtime drives it through ``apply_begin`` /
    ``emit_window``.  Output schema: left ++ right columns (the side a
    preserved side pads made nullable) for inner and outer joins, the
    preserved side's columns for semi and anti joins."""

    def __init__(
        self,
        left_schema: Schema,
        right_schema: Schema,
        left_keys: Sequence[Expr],
        right_keys: Sequence[Expr],
        table_size: int = 1 << 14,
        bucket_cap: int = 16,
        out_capacity: int = 16384,
        left_bucket_cap: int | None = None,
        right_bucket_cap: int | None = None,
        left_table_size: int | None = None,
        right_table_size: int | None = None,
        join_type: str = "inner",
        left_storage: str = "dense",
        right_storage: str = "dense",
        left_pool_size: int | None = None,
        right_pool_size: int | None = None,
    ):
        if join_type not in JOIN_TYPES:
            raise ValueError(f"unknown join type {join_type!r}")
        if left_storage not in ("dense", "pool") \
                or right_storage not in ("dense", "pool"):
            raise ValueError("storage must be 'dense' or 'pool'")
        self.join_type = join_type
        self.left_schema = left_schema
        self.right_schema = right_schema
        self.left_keys = tuple(left_keys)
        self.right_keys = tuple(right_keys)
        self.table_size = table_size
        self.left_bucket_cap = left_bucket_cap or bucket_cap
        self.right_bucket_cap = right_bucket_cap or bucket_cap
        self.left_table_size = left_table_size or table_size
        self.right_table_size = right_table_size or table_size
        self.out_capacity = out_capacity
        self.left_storage = left_storage
        self.right_storage = right_storage
        self.left_pool_size = left_pool_size or (
            self.left_table_size * self.left_bucket_cap)
        self.right_pool_size = right_pool_size or (
            self.right_table_size * self.right_bucket_cap)
        #: preserved sides survive unmatched: NULL-padded (outer), as the
        #: output itself (semi), inverted (anti)
        self.preserve_left = join_type in (
            "left_outer", "full_outer", "left_semi", "left_anti")
        self.preserve_right = join_type in (
            "right_outer", "full_outer", "right_semi", "right_anti")
        self.is_semi = join_type.endswith("_semi")
        self.is_anti = join_type.endswith("_anti")
        self.emit_pairs = not (self.is_semi or self.is_anti)
        if self.emit_pairs:
            left_out = left_schema if not self.preserve_right else Schema(
                tuple(f.with_nullable() for f in left_schema))
            right_out = right_schema if not self.preserve_left else Schema(
                tuple(f.with_nullable() for f in right_schema))
            self._out_schema = left_out.concat(right_out)
        else:
            self._out_schema = left_schema if self.preserve_left \
                else right_schema
        #: per-side watermark cleaning: (key_idx, lag_us, src_col)
        self.left_clean: tuple[int, int, int] | None = None
        self.right_clean: tuple[int, int, int] | None = None
        if self.is_semi:
            self.ops_updown = (OP_INSERT, OP_DELETE)
        elif self.is_anti:
            self.ops_updown = (OP_DELETE, OP_INSERT)
        else:  # outer pads retract on the first match, return on the last
            self.ops_updown = (OP_UPDATE_DELETE, OP_UPDATE_INSERT)
        self._specs = {side: self._emit_spec(side)
                       for side in ("left", "right")}

    @property
    def out_schema(self) -> Schema:
        return self._out_schema

    def __repr__(self) -> str:
        return f"HashJoinExecutor({self.join_type})"

    def storage_of(self, side: str) -> str:
        return self.left_storage if side == "left" else self.right_storage

    def _preserved(self, side: str) -> bool:
        return self.preserve_left if side == "left" else self.preserve_right

    def _emit_spec(self, side: str) -> EmitSpec:
        """The output columns of a window whose probe rows arrive on
        ``side``: left ++ right, the probe side padded on transition rows
        and the build side on self rows where the other side is
        preserved; semi/anti the preserved side only."""
        layout = []
        if self.emit_pairs:
            for src_side in ("left", "right"):
                schema = self.left_schema if src_side == "left" \
                    else self.right_schema
                from_probe = src_side == side
                nullable = self.preserve_left if src_side == "right" \
                    else self.preserve_right
                pad = (1 if from_probe else 2) if nullable else 0
                layout += [(from_probe, ci, pad) for ci in range(len(schema))]
        else:
            pres = "left" if self.preserve_left else "right"
            schema = self.left_schema if pres == "left" \
                else self.right_schema
            layout = [(pres == side, ci, 0) for ci in range(len(schema))]
        return EmitSpec(tuple(layout), self.emit_pairs, self.ops_updown)

    def cuda_refusal(self) -> str | None:
        """Why the card's join kernels cannot run this join, or None:
        K13, K13d and K14 move at most ``MAX_LEAVES`` column leaves, and
        K13d hashes a dense side's rows through at most 16 key leaves."""
        for side, schema in (("left", self.left_schema),
                             ("right", self.right_schema)):
            n = sum(2 if f.data_type.is_string else 1 for f in schema)
            n_null = sum(1 for f in schema if f.nullable)
            if n + n_null > MAX_LEAVES:
                return (f"a {side} join side of {n + n_null} column leaves "
                        f"(K13, K13d and K14 take {MAX_LEAVES})")
            if self.storage_of(side) == "dense" and n > 16:
                return (f"a dense {side} join side of {n} hashed column "
                        "leaves (K13d's row hash takes 16)")
        n_out = sum((2 if f.data_type.is_string else 1) + int(f.nullable)
                    for f in self._out_schema)
        if n_out > MAX_LEAVES:
            return (f"a join output of {n_out} column leaves (K14 takes "
                    f"{MAX_LEAVES})")
        return None

    def _pool_side_state(self, schema: Schema, pool: int,
                         device) -> PoolSideState:
        i32 = dict(dtype=torch.int32, device=device)
        i64 = dict(dtype=torch.int64, device=device)
        return PoolSideState(
            table=TagTable.create(pool, device),
            count=torch.zeros(pool, **i32),
            pool_pos=torch.zeros(pool, **i32),
            slot_clean=torch.zeros(pool, **i64),
            rows=tuple(empty_value_col(f, pool, device) for f in schema),
            pool_len=torch.zeros((), **i32),
            overflow=torch.zeros((), **i64),
            inconsistency=torch.zeros((), **i64),
        )

    def _side_state(self, schema: Schema, keys: Sequence[Expr],
                    bucket: int, size: int, device) -> SideState:
        protos = []
        for e in keys:
            f = e.return_field(schema)
            protos.append(empty_value_col(f.with_nullable(False)
                                          if f.nullable else f, 1, device))
        i64 = dict(dtype=torch.int64, device=device)
        return SideState(
            key_table=HashTable.create(protos, size, device),
            rows=tuple(_empty_store(f, size, bucket, device)
                       for f in schema),
            occupied=torch.zeros((size, bucket), dtype=torch.bool,
                                 device=device),
            count=torch.zeros(size, dtype=torch.int32, device=device),
            overflow=torch.zeros((), **i64),
            inconsistency=torch.zeros((), **i64),
        )

    def _init_side(self, side: str, device):
        schema = self.left_schema if side == "left" else self.right_schema
        if self.storage_of(side) == "pool":
            pool = self.left_pool_size if side == "left" \
                else self.right_pool_size
            return self._pool_side_state(schema, pool, device)
        keys = self.left_keys if side == "left" else self.right_keys
        bucket = self.left_bucket_cap if side == "left" \
            else self.right_bucket_cap
        size = self.left_table_size if side == "left" \
            else self.right_table_size
        return self._side_state(schema, keys, bucket, size, device)

    def init_state(self, device) -> JoinState:
        z = dict(dtype=torch.int64, device=device)
        return JoinState(
            left=self._init_side("left", device),
            right=self._init_side("right", device),
            emit_overflow=torch.zeros((), **z),
            chunks=torch.zeros((), **z),
            probe_iters=torch.zeros((), **z),
            emit_rows=torch.zeros((), **z),
            emit_windows=torch.zeros((), **z),
        )

    # ------------------------------------------------------------------
    def apply_begin(self, state: JoinState, chunk: Chunk, side: str):
        """Update own-side state (in place) and stage the emission
        space; returns ``(state, pending)``."""
        own = state.left if side == "left" else state.right
        other = state.right if side == "left" else state.left
        other_side = "right" if side == "left" else "left"
        keys = self.left_keys if side == "left" else self.right_keys
        own_clean = self.left_clean if side == "left" else self.right_clean
        cap = chunk.capacity
        dev = chunk.device
        i32 = dict(dtype=torch.int32, device=dev)
        key_cols, null_keys = _null_stripped_keys(
            [e.eval(chunk) for e in keys])
        probe_hash = hash64_columns(key_cols)
        other_pres = self._preserved(other_side)
        # own per-key counts BEFORE the chunk (the update is in place)
        old_count = own.count.clone() if other_pres else None
        upd_iters = torch.zeros((), **i32)
        if self.storage_of(side) == "pool":
            _, upd_iters = update_side_pool(own, chunk, own_clean, key_cols,
                                            null_keys, probe_hash)
        else:
            update_side_dense(own, chunk, key_cols, null_keys, probe_hash)
        signs = chunk.signs()
        active = chunk.valid & (signs != 0)
        joinable = active if null_keys is None else active & ~null_keys

        # probe the build side: per-row key slot and live rows
        if self.storage_of(other_side) == "pool":
            # ONE lookup of each key's head (hash, 0)
            bsize = other.table.size
            slots, found, probe_over = other.table.lookup_pair_counted(
                probe_hash, torch.zeros(cap, **i32), joinable)
            safe = torch.clamp(slots, max=bsize - 1)
            m = torch.where(found, other.count[safe.to(torch.int64)],
                            torch.zeros(cap, **i32))
        else:
            bsize = other.key_table.size
            slots, found, probe_over = other.key_table.lookup_counted(
                key_cols, joinable, hashes=probe_hash)
            safe = torch.clamp(slots, max=bsize - 1)
            occ = other.occupied[safe.to(torch.int64)] & found[:, None]
            m = occ.sum(dim=1, dtype=torch.int32)
        pair_cnt = m if self.emit_pairs else torch.zeros_like(m)
        pair_end = torch.cumsum(pair_cnt, 0, dtype=torch.int32)
        P = pair_end[-1]

        # self rows of a preserved probe side: pads (outer), matched rows
        # (semi), unmatched rows (anti); a NULL key matches nothing
        if self._preserved(side):
            self_mask = active & (m > 0) if self.is_semi \
                else active & (m == 0)
        else:
            self_mask = torch.zeros(cap, dtype=torch.bool, device=dev)
        self_sel = mask_indices(self_mask, cap, cap)
        S = self_mask.sum(dtype=torch.int32)

        # transitions of the other side's stored rows: a key whose own
        # count crosses 0 flips them (its first row in the chunk emits)
        if other_pres:
            if self.storage_of(side) == "pool":
                oslots, ofound, _ = own.table.lookup_pair_counted(
                    probe_hash, torch.zeros(cap, **i32), joinable)
                osafe = torch.clamp(oslots, max=own.table.size - 1)
            else:
                oslots, ofound, _ = own.key_table.lookup_counted(
                    key_cols, joinable, hashes=probe_hash)
                osafe = torch.clamp(oslots, max=own.key_table.size - 1)
            osafe = osafe.to(torch.int64)
            oldc = old_count[osafe]
            newc = own.count[osafe]
            eligible = joinable & ofound
            up = eligible & (oldc == 0) & (newc > 0)
            down = eligible & (oldc > 0) & (newc == 0)
            first = rank_by(oslots.to(torch.int64), up | down) == 0
            zeros = torch.zeros(cap, **i32)
            up_cnt = torch.where(up & first, m, zeros)
            down_cnt = torch.where(down & first, m, zeros)
        else:
            up_cnt = down_cnt = torch.zeros(cap, **i32)
        up_end = torch.cumsum(up_cnt, 0, dtype=torch.int32)
        U = up_end[-1]
        down_end = torch.cumsum(down_cnt, 0, dtype=torch.int32)
        total = U + P + S + down_end[-1]
        pending = JoinEmit(
            probe_cols=chunk.columns, signs=signs, slots=safe,
            probe_hash=probe_hash, m=m,
            up_cnt=up_cnt, up_end=up_end, U=U, pair_end=pair_end, P=P,
            self_sel=self_sel, S=S, down_cnt=down_cnt, down_end=down_end,
            total=total)
        state.emit_overflow.add_(probe_over)
        state.chunks.add_(1)
        state.probe_iters.add_(upd_iters.to(torch.int64))
        state.emit_rows.add_(total.to(torch.int64))
        out_cap = self.out_capacity
        state.emit_windows.add_(torch.clamp(
            torch.div(total + out_cap - 1, out_cap, rounding_mode="floor"),
            min=1).to(torch.int64))
        return state, pending

    def emit_window(self, build_rows, p: JoinEmit, w: int, side: str):
        """Window ``w`` of the pending emission space: ``(chunk,
        probe_bound int64)``."""
        rows, index = build_rows
        cols, ops, valid, probe_bound = emit_window(
            rows, index, p, w, self.out_capacity, self._specs[side])
        return Chunk(cols, ops, valid, self._out_schema), probe_bound

    def build_rows_of(self, state: JoinState, side: str) -> tuple:
        """(row stores, index) of the build side: ``("pool", tag table,
        pool_pos)`` or ``("dense", occupied)``."""
        build = state.right if side == "left" else state.left
        if isinstance(build, PoolSideState):
            return build.rows, ("pool", build.table, build.pool_pos)
        return build.rows, ("dense", build.occupied)

    def max_windows(self, chunk_cap: int) -> int:
        """Static bound on emission windows for one chunk (a pool's worst
        case is the whole pool joining one probe row)."""
        depth_l = self.left_pool_size if self.left_storage == "pool" \
            else self.left_bucket_cap
        depth_r = self.right_pool_size if self.right_storage == "pool" \
            else self.right_bucket_cap
        worst = chunk_cap * max(depth_l, depth_r) * 2 + chunk_cap
        return -(-worst // self.out_capacity)

    # ------------------------------------------------------------------
    def clean_side(self, state: JoinState, side: str, threshold):
        """Watermark state cleaning of one side, in place: a pool side's
        entries whose window key (``slot_clean``) is below ``threshold``
        tombstone, a whole closed window at once (their pool rows linger
        until the next compaction); a dense side's keys whose clean key
        column is below it empty.  Returns the table's [tombstones,
        live] after the clean (int32 device tensor)."""
        s = getattr(state, side)
        thr = torch.as_tensor(threshold, dtype=torch.int64,
                              device=s.count.device)
        if isinstance(s, SideState):
            return clean_dense(s, getattr(self, f"{side}_clean")[0], thr)
        return clean_pool(s, thr)

    def clean_below(self, state: JoinState, side: str, key_col_idx: int,
                    threshold) -> JoinState:
        """The reference's entry point (a pool side cleans by
        ``slot_clean``, a dense side by its ``key_col_idx``-th key)."""
        s = getattr(state, side)
        if isinstance(s, SideState):
            clean_dense(s, key_col_idx, torch.as_tensor(
                threshold, dtype=torch.int64, device=s.count.device))
        else:
            self.clean_side(state, side, threshold)
        return state

    def rehash_decisions(self, state: JoinState, stats: dict):
        """Device bools [rebuild_l, compact_l, rebuild_r, compact_r] of
        ``maybe_rehash``; ``stats[side]`` are the side's [tombstones,
        live] (computed here when absent)."""
        conds = []
        for side in ("left", "right"):
            s = getattr(state, side)
            st = stats.get(side)
            if st is None:
                st = table_stats(s)
            conds.extend(rehash_conditions(s, st))
        return torch.stack(conds)

    def apply_rehash(self, state: JoinState, decisions,
                     fired: dict | None = None) -> JoinState:
        """Run ``rebuild`` / ``rebuild_pool`` / ``compact_pool`` where the
        host-read ``decisions`` say so.  A pool side that was rebuilt
        re-reads its compaction condition (the rehash may have
        overflowed rows)."""
        sides = {}
        for i, side in enumerate(("left", "right")):
            s = getattr(state, side)
            rebuild, compact = decisions[2 * i], decisions[2 * i + 1]
            if isinstance(s, SideState):
                if rebuild:
                    s = rebuild_dense(s)
                    if fired is not None:
                        fired["rebuild"] = fired.get("rebuild", 0) + 1
                sides[side] = s
                continue
            if rebuild:
                s = rebuild_pool(s)
                compact = bool(rehash_conditions(s, table_stats(s))[1])
                if fired is not None:
                    fired["rebuild_pool"] = fired.get("rebuild_pool", 0) + 1
            if compact:
                s = compact_pool(s)
                if fired is not None:
                    fired["compact_pool"] = fired.get("compact_pool", 0) + 1
            sides[side] = s
        return state._replace(left=sides["left"], right=sides["right"])

    def maybe_rehash(self, state: JoinState) -> JoinState:
        """Rebuild tombstone-heavy tables and compact dead-heavy pools
        (one readback of the four conditions)."""
        decisions = [bool(v) for v in
                     self.rehash_decisions(state, {}).tolist()]
        return self.apply_rehash(state, decisions)
