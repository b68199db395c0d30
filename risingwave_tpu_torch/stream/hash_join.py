"""Streaming hash join with pool storage on both sides (Nexmark q8).

Port of the pool half of ``risingwave_tpu/stream/hash_join.py``:
``PoolSideState`` / ``JoinState`` / ``JoinEmit`` (:204-330),
``_null_stripped_keys``, ``_pool_capacity``, ``_rank_by``,
``_rank_by_sorted``, ``_totals_from_sort`` and ``_group_totals``
(:140-190; the top-N pool uses the unsorted forms), and of ``HashJoinExecutor`` the pool
branches of ``init_state``, ``_update_side_pool`` (:597),
``apply_begin`` (:705), ``emit_window`` (:850), ``build_rows_of``,
``max_windows``, ``maybe_rehash`` (``rebuild_pool``, ``compact_pool``)
and ``clean_below`` (:1048-1146).

A pool side keeps ONE ``TagTable`` of ``(key-hash, rank)`` tags over a
bump-allocated row pool: the rank-r row of a key owns the entry of
``pair_tag(hash, r)``, the key's degree lives at its head (rank 0)
entry, ``pool_pos`` maps an entry to its pool row and ``slot_clean``
holds the window key that watermark cleaning compares.  Emission is
output-centric and windowed: the logical array ``[up | pairs | self |
down]`` is cut into ``out_capacity`` windows, and every output row finds
its probe row by a binary search over prefix sums and its build row by a
tag lookup.

Ported: the INNER join with pool storage on both sides, which is what
the planner picks for append-only inputs such as q8's.  Dense (bucket)
storage and outer, semi and anti joins raise ``NotImplementedError``.

On the card the path runs these kernels, each beside its plain version:

- K12 ``tag_insert_ranked`` / ``tag_probe`` (``state/tag_table.py``);
- K13 ``join_update`` (``csrc/join_update.cu``): the segmented rank
  over the chunk's stably sorted key hashes (``torch.sort``), then,
  after K12, the bump allocator, the un-claim of dropped rows, the pool
  row scatter, ``pool_pos`` / ``slot_clean``, the degree add from each
  key's rank-0 row and the counters;
- K14 ``join_emit`` (``csrc/join_emit.cu``): one emission window, one
  thread per output row;
- K15 ``join_clean`` (``csrc/join_clean.cu``): the watermark clean of a
  side (with the table's tombstone and live counts for the rehash
  conditions) and the pool compaction (occupancy scan, ``moved`` map,
  new ``pool_pos`` / ``pool_len``); the rows then move through K4
  ``permute_rows`` (``csrc/permute.cu``), as do ``rebuild_pool``'s
  per-slot columns, every column of a table in one entry.

State tensors are updated in place where the reference returns a new
tree; ``rebuild_pool`` and ``compact_pool`` build new tensors and return
a new state.
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
from risingwave_tpu_torch.common.hash import hash64_columns
from risingwave_tpu_torch.common.types import Schema
from risingwave_tpu_torch.expr.node import Expr
from risingwave_tpu_torch.state.hash_table import (
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

#: the join matrix of the reference (only "inner" is ported)
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


class JoinState(NamedTuple):
    left: PoolSideState
    right: PoolSideState
    emit_overflow: torch.Tensor  # int64 — matches dropped
    chunks: torch.Tensor         # int64 — probe chunks applied
    probe_iters: torch.Tensor    # int64 — ranked-insert probe rounds
    emit_rows: torch.Tensor      # int64 — staged emission rows
    emit_windows: torch.Tensor   # int64 — emission windows drained


class JoinEmit(NamedTuple):
    """One chunk's staged emission space ``[up | pairs | self | down]``
    (device tensors; the scalars are 0-d int32).  The reference's
    ``rank_to_idx`` addresses dense build sides, which are not ported."""

    probe_cols: tuple
    signs: torch.Tensor       # int32 [cap]
    slots: torch.Tensor       # int32 [cap] clamped build-side head slots
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
MAX_LEAVES = 32


class _ColDesc(ctypes.Structure):
    """Mirror of ``struct JoinCols`` in ``csrc/rw_join.cuh``."""

    _fields_ = [
        ("n", ctypes.c_int),
        ("width", ctypes.c_int * MAX_LEAVES),
        ("from_probe", ctypes.c_int * MAX_LEAVES),
        ("src", ctypes.c_void_p * MAX_LEAVES),
        ("dst", ctypes.c_void_p * MAX_LEAVES),
    ]


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
        ("cols", _ColDesc),
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
        ("got", ctypes.c_void_p), ("pos", ctypes.c_void_p),
        ("prefix", ctypes.c_void_p),
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
    cap = h.shape[0]
    dev = h.device
    sorted_key, order = torch.sort(_sort_key(h, is_ins), stable=True)
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
    return cr, order, seg_start


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
    i32 = dict(dtype=torch.int32, device=dev)
    got = torch.empty(cap, dtype=torch.uint8, device=dev)
    pos = torch.empty(cap, **i32)
    prefix = torch.empty(cap, **i32)
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
    a.got, a.pos, a.prefix = got.data_ptr(), pos.data_ptr(), \
        prefix.data_ptr()
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
# K14: one emission window


def _decode(end, cnt, pos, cap):
    """Row index and within-row offset of ``pos`` in a cumsum section."""
    r = torch.clamp(torch.searchsorted(end, pos, right=True),
                    max=cap - 1).to(torch.int64)
    return r, pos - (end[r] - cnt[r])


def emit_window_plain(build_rows, btable: TagTable, bpool_pos,
                      p: JoinEmit, w: int, out_cap: int, side: str,
                      ops_updown: tuple[int, int]):
    """Plain PyTorch version of kernel K14: ``(columns, ops, valid,
    probe_bound)`` of window ``w``; columns are the probe side's then
    the build side's when ``side == "left"`` (left ++ right)."""
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
    ur, uj = _decode(p.up_end, p.up_cnt, gpos, cap)
    pr, pj = _decode(p.pair_end, p.m, ppos, cap)
    sr = p.self_sel[torch.clamp(spos, 0, cap - 1).to(torch.int64)] \
        .to(torch.int64)
    dr, dj = _decode(p.down_end, p.down_cnt, dpos, cap)
    r = torch.where(in_up, ur, torch.where(in_pairs, pr,
                                           torch.where(in_self, sr, dr)))
    zero = torch.zeros_like(uj)
    j = torch.where(in_up, uj, torch.where(in_pairs, pj,
                                           torch.where(in_down, dj, zero)))
    need = in_pairs | in_trans
    pool = _pool_capacity(build_rows)
    _, bslot, bfound, boverflow, _ = btable._probe_tags_plain(
        pair_tag(p.probe_hash[r], j.to(torch.int32)), need, insert=False)
    probe_bound = (boverflow & need).sum(dtype=torch.int64)
    bpos = torch.clamp(bpool_pos[torch.clamp(bslot, max=btable.size - 1)
                                 .to(torch.int64)], 0, pool - 1) \
        .to(torch.int64)
    valid_out = valid_out & (~need | bfound)
    probe_vals = [gather_key(c, r) for c in p.probe_cols]
    build_vals = [gather_key(s, bpos) for s in build_rows]
    cols = probe_vals + build_vals if side == "left" \
        else build_vals + probe_vals
    sign_r = p.signs[r]
    base_op = torch.where(sign_r > 0,
                          torch.full_like(sign_r, OP_INSERT),
                          torch.full_like(sign_r, OP_DELETE))
    up_op, down_op = ops_updown
    ops = torch.where(in_up, torch.full_like(sign_r, up_op),
                      torch.where(in_down, torch.full_like(sign_r, down_op),
                                  base_op)).to(torch.int8)
    return cols, ops, valid_out, probe_bound


class _EmitArgs(ctypes.Structure):
    """Mirror of ``struct JoinEmitArgs`` in ``csrc/join_emit.cu``."""

    _fields_ = [
        ("cols", _ColDesc),
        ("up_end", ctypes.c_void_p), ("up_cnt", ctypes.c_void_p),
        ("pair_end", ctypes.c_void_p), ("m", ctypes.c_void_p),
        ("self_sel", ctypes.c_void_p), ("down_end", ctypes.c_void_p),
        ("down_cnt", ctypes.c_void_p), ("U", ctypes.c_void_p),
        ("P", ctypes.c_void_p), ("S", ctypes.c_void_p),
        ("total", ctypes.c_void_p), ("probe_hash", ctypes.c_void_p),
        ("signs", ctypes.c_void_p), ("tags", ctypes.c_void_p),
        ("pool_pos", ctypes.c_void_p),
        ("ops", ctypes.c_void_p), ("valid", ctypes.c_void_p),
        ("probe_bound", ctypes.c_void_p),
        ("w", ctypes.c_longlong), ("out_cap", ctypes.c_int),
        ("cap", ctypes.c_int), ("size", ctypes.c_int), ("pool", ctypes.c_int),
        ("max_iters", ctypes.c_int), ("up_op", ctypes.c_int),
        ("down_op", ctypes.c_int),
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


def emit_window_cuda(build_rows, btable: TagTable, bpool_pos,
                     p: JoinEmit, w: int, out_cap: int, side: str,
                     ops_updown: tuple[int, int]):
    """Kernel K14 (``csrc/join_emit.cu``): one launch per window."""
    dev = p.signs.device
    probe_out = [_empty_like_rows(c, out_cap) for c in p.probe_cols]
    build_out = [_empty_like_rows(s, out_cap) for s in build_rows]
    a = _EmitArgs()
    keep = []
    k = 0
    order = ((probe_out, p.probe_cols, 1), (build_out, build_rows, 0))
    if side != "left":
        order = order[::-1]
    for outs, srcs, from_probe in order:
        for dst, src in _leaf_pairs(outs, srcs):
            if k >= MAX_LEAVES:
                raise ValueError(f"more than {MAX_LEAVES} column leaves")
            src = src.contiguous()
            keep += [dst, src]
            a.cols.width[k] = _leaf_width(src)
            a.cols.from_probe[k] = from_probe
            a.cols.src[k] = src.data_ptr()
            a.cols.dst[k] = dst.data_ptr()
            k += 1
    a.cols.n = k
    ops = torch.empty(out_cap, dtype=torch.int8, device=dev)
    valid = torch.empty(out_cap, dtype=torch.bool, device=dev)
    probe_bound = torch.zeros((), dtype=torch.int64, device=dev)
    arrays = (p.up_end, p.up_cnt, p.pair_end, p.m, p.self_sel, p.down_end,
              p.down_cnt, p.U, p.P, p.S, p.total, p.probe_hash, p.signs,
              btable.tags, bpool_pos)
    for t in arrays[:11] + (p.signs, bpool_pos):
        if t.dtype != torch.int32:
            raise ValueError("join_emit: int32 emission arrays expected")
    kernels.require_cuda("join_emit", *arrays, ops, valid, *keep)
    (a.up_end, a.up_cnt, a.pair_end, a.m, a.self_sel, a.down_end,
     a.down_cnt, a.U, a.P, a.S, a.total, a.probe_hash, a.signs, a.tags,
     a.pool_pos) = (t.data_ptr() for t in arrays)
    a.ops, a.valid = ops.data_ptr(), valid.data_ptr()
    a.probe_bound = probe_bound.data_ptr()
    a.w, a.out_cap, a.cap = w, out_cap, p.signs.shape[0]
    a.size, a.pool = btable.size, _pool_capacity(build_rows)
    a.max_iters = min(btable.size + 2, 1024)
    a.up_op, a.down_op = ops_updown
    fn = kernels.entry("join_emit", "rw_join_emit",
                       [_EmitArgs, ctypes.c_void_p])
    kernels.count_launch("join_emit")
    kernels.check(fn(a, kernels.stream_ptr(dev)), "join_emit")
    cols = probe_out + build_out if side == "left" \
        else build_out + probe_out
    return cols, ops, valid, probe_bound


def emit_window(build_rows, btable, bpool_pos, p: JoinEmit, w: int,
                out_cap: int, side: str, ops_updown: tuple[int, int]):
    """One emission window; CUDA tensors launch kernel K14."""
    impl = emit_window_cuda if p.signs.device.type == "cuda" \
        else emit_window_plain
    return impl(build_rows, btable, bpool_pos, p, w, out_cap, side,
                ops_updown)


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


def rehash_conditions(s: PoolSideState, stats: torch.Tensor):
    """(rebuild, compact) device bools of ``maybe_rehash`` from the
    table's [tombstones, live] ``stats``."""
    pool = _pool_capacity(s.rows)
    rebuild = stats[0] > s.table.size // 4
    dead = s.pool_len - stats[1]
    compact = (s.pool_len >= pool - pool // 4) & (dead > pool // 8)
    return rebuild, compact


def table_stats(s: PoolSideState) -> torch.Tensor:
    return torch.stack([s.table.tombstone_count(), s.table.count()])


# ---------------------------------------------------------------------------


class HashJoinExecutor:
    """Equi-join of two changelog streams; the DAG runtime drives it
    through ``apply_begin`` / ``emit_window``.  Output schema: left ++
    right columns."""

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
        if join_type != "inner":
            raise NotImplementedError(
                f"{join_type} joins are not ported yet (inner is)")
        if left_storage != "pool" or right_storage != "pool":
            raise NotImplementedError(
                "dense (bucket) join storage is not ported yet (pool is)")
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
        self.preserve_left = self.preserve_right = False
        self.is_semi = self.is_anti = False
        self.emit_pairs = True
        self._out_schema = left_schema.concat(right_schema)
        #: per-side watermark cleaning: (key_idx, lag_us, src_col)
        self.left_clean: tuple[int, int, int] | None = None
        self.right_clean: tuple[int, int, int] | None = None
        #: up/down transition op codes (outer pads; inner has none)
        self.ops_updown = (OP_UPDATE_DELETE, OP_UPDATE_INSERT)

    @property
    def out_schema(self) -> Schema:
        return self._out_schema

    def __repr__(self) -> str:
        return f"HashJoinExecutor({self.join_type})"

    def storage_of(self, side: str) -> str:
        return self.left_storage if side == "left" else self.right_storage

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

    def init_state(self, device) -> JoinState:
        z = dict(dtype=torch.int64, device=device)
        return JoinState(
            left=self._pool_side_state(self.left_schema,
                                       self.left_pool_size, device),
            right=self._pool_side_state(self.right_schema,
                                        self.right_pool_size, device),
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
        keys = self.left_keys if side == "left" else self.right_keys
        own_clean = self.left_clean if side == "left" else self.right_clean
        cap = chunk.capacity
        dev = chunk.device
        key_cols, null_keys = _null_stripped_keys(
            [e.eval(chunk) for e in keys])
        probe_hash = hash64_columns(key_cols)
        _, upd_iters = update_side_pool(own, chunk, own_clean, key_cols,
                                        null_keys, probe_hash)
        signs = chunk.signs()
        active = chunk.valid & (signs != 0)
        joinable = active if null_keys is None else active & ~null_keys

        # the pool build side: ONE lookup of each key's head (hash, 0)
        bsize = other.table.size
        i32 = dict(dtype=torch.int32, device=dev)
        slots, found, probe_over = other.table.lookup_pair_counted(
            probe_hash, torch.zeros(cap, **i32), joinable)
        safe = torch.clamp(slots, max=bsize - 1)
        m = torch.where(found, other.count[safe.to(torch.int64)],
                        torch.zeros(cap, **i32))
        pair_end = torch.cumsum(m, 0, dtype=torch.int32)
        P = pair_end[-1]
        # inner: no self rows and no transitions
        self_mask = torch.zeros(cap, dtype=torch.bool, device=dev)
        self_sel = mask_indices(self_mask, cap, cap)
        zeros = torch.zeros(cap, **i32)
        zero = torch.zeros((), **i32)
        pending = JoinEmit(
            probe_cols=chunk.columns, signs=signs, slots=safe,
            probe_hash=probe_hash, m=m, up_cnt=zeros, up_end=zeros, U=zero,
            pair_end=pair_end, P=P, self_sel=self_sel, S=zero,
            down_cnt=zeros, down_end=zeros, total=P)
        state.emit_overflow.add_(probe_over)
        state.chunks.add_(1)
        state.probe_iters.add_(upd_iters.to(torch.int64))
        state.emit_rows.add_(P.to(torch.int64))
        out_cap = self.out_capacity
        state.emit_windows.add_(torch.clamp(
            torch.div(P + out_cap - 1, out_cap, rounding_mode="floor"),
            min=1).to(torch.int64))
        return state, pending

    def emit_window(self, build_rows, p: JoinEmit, w: int, side: str):
        """Window ``w`` of the pending emission space: ``(chunk,
        probe_bound int64)``."""
        rows, (btable, bpool_pos) = build_rows
        cols, ops, valid, probe_bound = emit_window(
            rows, btable, bpool_pos, p, w, self.out_capacity, side,
            self.ops_updown)
        return Chunk(cols, ops, valid, self._out_schema), probe_bound

    def build_rows_of(self, state: JoinState, side: str) -> tuple:
        """(row stores, (tag table, pool_pos)) of the build side."""
        build = state.right if side == "left" else state.left
        return build.rows, (build.table, build.pool_pos)

    def max_windows(self, chunk_cap: int) -> int:
        """Static bound on emission windows for one chunk (the whole pool
        joining one probe row)."""
        worst = chunk_cap * max(self.left_pool_size,
                                self.right_pool_size) * 2 + chunk_cap
        return -(-worst // self.out_capacity)

    # ------------------------------------------------------------------
    def clean_side(self, state: JoinState, side: str, threshold):
        """Watermark state cleaning of one side, in place: entries whose
        window key (``slot_clean``) is below ``threshold`` tombstone, a
        whole closed window at once; their pool rows linger until the
        next compaction.  Returns the table's [tombstones, live] after
        the clean (int32 device tensor)."""
        s = getattr(state, side)
        thr = torch.as_tensor(threshold, dtype=torch.int64,
                              device=s.count.device)
        return clean_pool(s, thr)

    def clean_below(self, state: JoinState, side: str, key_col_idx: int,
                    threshold) -> JoinState:
        """The reference's entry point: ``clean_side`` (the pool side keys
        cleaning by ``slot_clean``, not by ``key_col_idx``)."""
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
        """Run ``rebuild_pool`` / ``compact_pool`` where the host-read
        ``decisions`` say so.  A side that was rebuilt re-reads its
        compaction condition (the rehash may have overflowed rows)."""
        sides = {}
        for i, side in enumerate(("left", "right")):
            s = getattr(state, side)
            rebuild, compact = decisions[2 * i], decisions[2 * i + 1]
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
        """Rebuild tombstone-heavy tag tables and compact dead-heavy
        pools (one readback of the four conditions)."""
        decisions = [bool(v) for v in
                     self.rehash_decisions(state, {}).tolist()]
        return self.apply_rehash(state, decisions)
