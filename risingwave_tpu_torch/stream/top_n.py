"""Group top-N over a flat row pool (Nexmark q19, q18).

Port of ``risingwave_tpu/stream/top_n.py``: ``_order_key`` (:49),
``TopNState`` (:85), ``_empty_like_col`` / ``_gather`` / ``_scatter`` /
``schema_protos`` (:96-131), ``pool_apply`` (:134) and of
``GroupTopNExecutor`` (:194) ``init_state``, ``apply``, ``_band_mask``
(:295), ``flush`` (:337), ``on_watermark`` (:406) and ``clean_below``
(:418); and ``AppendOnlyDedupExecutor`` (:441, K19b: composed of K1, K3
and the K4 sweep, no kernel of its own).

State is a pool of ``pool_size`` rows (one store per input column) with
validity and a row hash, plus the band emitted at the last barrier:

- ``apply`` folds a changelog chunk into the pool (``pool_apply``):
  in-chunk +row/-row pairs of equal row hash annihilate first, then
  each delete clears the rank-th valid pool row of its hash (slot
  order), and the insert of rank r claims the r-th free slot
  (ascending);
- ``flush`` sorts the whole pool lexicographically (order keys, then
  the group hash, then validity, each a stable sort), ranks every row
  within its group, keeps the ``offset <= rank < offset + limit`` band,
  compacts it into ``emit_capacity`` rows and emits the multiset
  difference against the last emitted band as a ``[2 * emit_capacity]``
  changelog (deletes, then inserts).  With ``rank_alias`` the 1-based
  absolute rank is an output column and part of the diff hash.  On
  append-only input the rows outside the band leave the pool.

Hashes are int64 tensors holding the reference's uint64 bit patterns.
State is updated in place: the pool stores, ``valid``, ``row_hash`` and
the counters; ``flush`` replaces the emitted-band tensors.

On the card:

- K16 ``topn_pool`` (``csrc/topn_pool.cu``) is ``pool_apply`` after K1's
  row hash: one cooperative launch.  A chunk without a delete ranks its
  inserts and compacts the pool's first free slots on the grid and
  writes the claimed rows; with deletes, a chunk-sized hash table of row
  hashes (no ``[cap, pool]`` match matrix) counts each hash's inserts and
  deletes, and the order-dependent ranks run over lists of the contested
  rows and the candidate slots only.  Both counters stay on the card.
- K17 ``topn_band`` (``csrc/topn_band.cu``) is ``_band_mask``: one
  launch encodes the order keys and the group hash (K1's device
  function), the stable sorts stay ``torch.sort``, and one launch ranks
  every sorted row in its group by a binary search for its segment
  start and scatters the band and the 1-based rank back.
- K18 ``topn_flush`` (``csrc/topn_flush.cu``) is ``flush``'s band diff
  after K7's compaction: one launch gathers the band rows (row S-1 for
  dead entries, as the reference's clamp does) and copies the old band
  into the out chunk, plane by plane in words, and folds the rank into
  the hash; after a stable sort of each side's hashes, a grid scan
  (decoupled look-back) counts each hash run's live entries and a
  merge of the two sorted sides decides the rank-aware multiset
  membership of both (no ``[E, E]`` matrix, no search per entry).
- K19a ``topn_clean`` (``csrc/topn_clean.cu``) is ``clean_below``: one
  launch drops the pool rows and the emitted-band rows whose watermark
  column is below the threshold, a device scalar.

Their plain versions (``pool_apply_plain``, ``band_mask_plain``,
``band_diff_plain``, ``clean_below_plain``) serve CPU tensors.  Float,
bool and string order keys on the card and nullable pool columns are
not ported yet.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence

import torch

from risingwave_tpu_torch import kernels
from risingwave_tpu_torch.common.chunk import (
    OP_DELETE,
    OP_INSERT,
    Chunk,
    NCol,
    StrCol,
)
from risingwave_tpu_torch.common.compact import mask_indices
from risingwave_tpu_torch.common.hash import (
    K1,
    hash64_columns,
    hash64_columns_cuda,
    key_leaves,
    leaf_width,
)
from risingwave_tpu_torch.common.types import DataType, Field, Schema
from risingwave_tpu_torch.expr.node import Expr
from risingwave_tpu_torch.state.hash_table import HashTable
from risingwave_tpu_torch.stream.executor import Executor
from risingwave_tpu_torch.stream.hash_join import _group_totals, _rank_by

INT64_MIN = -(1 << 63)


def _f32_order_bits(x32: torch.Tensor) -> torch.Tensor:
    """The reference's order-preserving uint32 image of a float32, as
    int64 in [0, 2^32)."""
    u = x32.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg = (u >> 31) == 1
    return torch.where(neg, ~u & 0xFFFFFFFF, u | (1 << 31))


def _order_key(col, descending: bool) -> torch.Tensor:
    """A column mapped to uint64 keys (int64 bit patterns) that order as
    the requested order does."""
    if isinstance(col, StrCol):
        # first 8 bytes big-endian (the reference's approximation)
        w = col.data.shape[1]
        take = min(8, w)
        b = col.data[:, :take].to(torch.int64)
        shifts = (torch.arange(take - 1, -1, -1, device=b.device)
                  + (8 - take)) * 8
        k = (b << shifts[None, :]).sum(dim=1)  # disjoint bytes: sum == or
    elif col.dtype == torch.bool:
        k = col.to(torch.int64)
    elif col.dtype.is_floating_point:
        if col.dtype == torch.float64:
            hi = col.to(torch.float32)
            lo = (col - hi.to(torch.float64)).to(torch.float32)
            k = (_f32_order_bits(hi) << 32) | _f32_order_bits(lo)
        else:
            k = _f32_order_bits(col.to(torch.float32)) << 32
    else:
        k = col.to(torch.int64) ^ INT64_MIN  # flip the sign bit
    return ~k if descending else k


class TopNState(NamedTuple):
    rows: tuple                # [pool] column stores
    valid: torch.Tensor        # bool [pool]
    row_hash: torch.Tensor     # int64 [pool] (uint64 bits)
    prev_rows: tuple           # last emitted band [emit_cap]
    prev_valid: torch.Tensor
    prev_hash: torch.Tensor
    overflow: torch.Tensor     # int64
    inconsistency: torch.Tensor


def _empty_like_col(col_proto, n: int):
    if isinstance(col_proto, StrCol):
        return StrCol(
            torch.zeros((n, col_proto.data.shape[1]), dtype=torch.uint8,
                        device=col_proto.data.device),
            torch.zeros(n, dtype=torch.int32, device=col_proto.lens.device))
    return torch.zeros(n, dtype=col_proto.dtype, device=col_proto.device)


def _uninit_like_col(col_proto, n: int):
    """``_empty_like_col`` without the zero fill."""
    if isinstance(col_proto, StrCol):
        dev = col_proto.data.device
        return StrCol(
            torch.empty((n, col_proto.data.shape[1]), dtype=torch.uint8,
                        device=dev),
            torch.empty(n, dtype=torch.int32, device=dev))
    return torch.empty(n, dtype=col_proto.dtype, device=col_proto.device)


def _gather(col, idx: torch.Tensor):
    if isinstance(col, StrCol):
        return StrCol(col.data[idx], col.lens[idx])
    return col[idx]


def _scatter_(store, pos: torch.Tensor, col) -> None:
    """In place ``store[pos] = col`` for ``pos < len(store)`` (the
    reference's ``.at[pos].set(col, mode="drop")``; targets unique)."""
    n = store.lens.shape[0] if isinstance(store, StrCol) else store.shape[0]
    keep = pos < n
    at = pos[keep].to(torch.int64)
    if isinstance(store, StrCol):
        store.data[at] = col.data[keep]
        store.lens[at] = col.lens[keep]
    else:
        store[at] = col[keep]


def schema_protos(schema: Schema, device) -> list:
    """One-row column prototypes for pool/table creation."""
    protos = []
    for f in schema:
        if f.data_type.is_string:
            protos.append(StrCol(
                torch.zeros((1, f.str_width), dtype=torch.uint8,
                            device=device),
                torch.zeros(1, dtype=torch.int32, device=device)))
        else:
            protos.append(torch.zeros(1, dtype=f.data_type.physical_dtype,
                                      device=device))
    return protos


def _leaves(col) -> list[torch.Tensor]:
    """The row-major tensors of a pool column (a StrCol: bytes, lens)."""
    if isinstance(col, NCol):
        raise NotImplementedError(
            "nullable columns in a top-N pool are not ported yet")
    return [col.data, col.lens] if isinstance(col, StrCol) else [col]


# ---------------------------------------------------------------------------
# K16: pool_apply


def pool_apply_plain(rows: tuple, valid: torch.Tensor,
                     row_hash_store: torch.Tensor, chunk: Chunk, S: int):
    """Plain PyTorch version of K16, in place.  Returns (rows, valid,
    hashes, n_overflow, n_missing) as the reference does; only the
    delete rows build the reference's match matrix."""
    dev = chunk.device
    signs = chunk.signs()
    is_ins = chunk.valid & (signs > 0)
    is_del = chunk.valid & (signs < 0)
    row_hash = hash64_columns(list(chunk.columns))

    # in-chunk annihilation
    ins_rank_h = _rank_by(row_hash, is_ins)
    del_rank_h = _rank_by(row_hash, is_del)
    n_ins_h = _group_totals(row_hash, is_ins)
    n_del_h = _group_totals(row_hash, is_del)
    is_ins = is_ins & ~(ins_rank_h < n_del_h)
    is_del = is_del & ~(del_rank_h < n_ins_h)

    # deletes: the rank-th valid pool row with the matching hash
    del_rank = _rank_by(row_hash, is_del)
    drows = torch.nonzero(is_del).flatten()
    n_missing = torch.zeros((), dtype=torch.int64, device=dev)
    if drows.numel():
        match = valid[None, :] & (row_hash_store[None, :]
                                  == row_hash[drows][:, None])
        mrank = torch.cumsum(match.to(torch.int32), 1) - 1
        clear = match & (mrank == del_rank[drows][:, None])
        any_clear = clear.any(dim=1)
        j_clear = clear.to(torch.uint8).argmax(dim=1)
        valid[j_clear[any_clear]] = False
        n_missing = (~any_clear).sum(dtype=torch.int64)

    # inserts: the rank-th free slot, ascending
    free = ~valid
    free_pos = torch.cumsum(free.to(torch.int32), 0) - 1
    slot_of_rank = torch.full((S + 1,), S, dtype=torch.int32, device=dev)
    slot_of_rank[torch.where(free, free_pos, S).to(torch.int64)] = \
        torch.arange(S, dtype=torch.int32, device=dev)
    slot_of_rank[S] = S
    ins_rank = torch.cumsum(is_ins.to(torch.int32), 0) - is_ins.to(torch.int32)
    tgt = torch.where(
        is_ins & (ins_rank < S),
        slot_of_rank[torch.clamp(ins_rank, max=S - 1).to(torch.int64)],
        torch.full_like(ins_rank, S))
    got = is_ins & (tgt < S)
    tgt = torch.where(got, tgt, torch.full_like(tgt, S))
    valid[tgt[got].to(torch.int64)] = True
    for store, col in zip(rows, chunk.columns):
        _scatter_(store, tgt, col)
    _scatter_(row_hash_store, tgt, row_hash)
    n_over = (is_ins & ~got).sum(dtype=torch.int64)
    return rows, valid, row_hash_store, n_over, n_missing


class _PoolArgs(ctypes.Structure):
    """Mirror of ``struct PoolApplyArgs`` in ``csrc/topn_pool.cu``."""

    _fields_ = [
        ("cols", kernels.RwCols),
        ("hash", ctypes.c_void_p), ("ops", ctypes.c_void_p),
        ("valid", ctypes.c_void_p), ("pvalid", ctypes.c_void_p),
        ("phash", ctypes.c_void_p), ("tkey", ctypes.c_void_p),
        ("tcount", ctypes.c_void_p), ("rent", ctypes.c_void_p),
        ("surv", ctypes.c_void_p), ("list", ctypes.c_void_p),
        ("cand", ctypes.c_void_p), ("ins_row", ctypes.c_void_p),
        ("sor", ctypes.c_void_p), ("bcount", ctypes.c_void_p),
        ("ctl", ctypes.c_void_p), ("overflow", ctypes.c_void_p),
        ("inconsistency", ctypes.c_void_p),
        ("cap", ctypes.c_int), ("S", ctypes.c_int), ("T", ctypes.c_int),
        ("pv_aligned", ctypes.c_int),
    ]


#: most blocks K16's cooperative grid may hold (``MAX_BLOCKS`` in
#: ``csrc/topn_pool.cu``: the per-block counts' room)
_POOL_MAX_BLOCKS = 4096
#: K16's scratch per (device, stream): {name: tensor}, sized for the
#: largest chunk and pool so far
_POOL_SCRATCH: dict = {}


def _pool_scratch(dev: torch.device, cap: int, S: int) -> dict:
    """K16's scratch for a ``cap``-row chunk into an ``S``-slot pool: the
    hash table (``T >= 2 cap`` entries) and the flag at rest (empty, 0),
    the row and slot lists, the per-block counts."""
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    key = (dev, kernels.stream_ptr(dev))
    e = _POOL_SCRATCH.get(key)
    if e is None or e["rent"].numel() < cap or e["cand"].numel() < S:
        c = 1 << max(cap - 1, 0).bit_length()
        if e is not None:
            c = max(c, e["rent"].numel())
            S = max(S, e["cand"].numel())
        T = max(1024, 2 * c)
        i32 = dict(dtype=torch.int32, device=dev)
        e = {"tkey": torch.full((T,), -1, dtype=torch.int64, device=dev),
             "tcount": torch.zeros(4 * T, **i32),
             "rent": torch.empty(c, **i32),
             "surv": torch.empty(c, dtype=torch.uint8, device=dev),
             "list": torch.empty(c, **i32),
             "cand": torch.empty(max(S, 1), **i32),
             "ins_row": torch.empty(c, **i32),
             "sor": torch.empty(c, **i32),
             "bcount": torch.empty(4 * _POOL_MAX_BLOCKS, **i32),
             "ctl": torch.zeros(1, **i32)}
        _POOL_SCRATCH[key] = e
    return e


def pool_apply_cuda(rows: tuple, valid: torch.Tensor,
                    row_hash_store: torch.Tensor, chunk: Chunk, S: int,
                    overflow: torch.Tensor, inconsistency: torch.Tensor):
    """K16 (``csrc/topn_pool.cu``) after K1's row hash, in place; the
    counts are added to ``overflow`` and ``inconsistency`` on the card."""
    cap = chunk.capacity
    dev = chunk.device
    row_hash, _ = hash64_columns_cuda(list(chunk.columns))
    args = _PoolArgs()
    cols = args.cols
    keep = []
    k = 0
    for store, col in zip(rows, chunk.columns):
        for sd, d in zip(_leaves(store), _leaves(col)):
            if k >= kernels.MAX_COLS:
                raise ValueError(f"more than {kernels.MAX_COLS} pool leaves")
            d = d.contiguous()
            if d.dtype != sd.dtype or d.shape[1:] != sd.shape[1:]:
                raise ValueError(f"pool leaf {k}: {d.dtype} chunk column "
                                 f"against a {sd.dtype} store")
            keep += [d, sd]
            cols.width[k] = leaf_width(d)
            cols.in_data[k], cols.st_data[k] = d.data_ptr(), sd.data_ptr()
            k += 1
    cols.n = k
    sc = _pool_scratch(dev, cap, S)
    valid_u8 = chunk.valid.contiguous().view(torch.uint8)
    ops = chunk.ops.contiguous()
    pvalid = valid.view(torch.uint8)
    kernels.require_cuda("topn_pool", row_hash, ops, valid_u8, pvalid,
                         row_hash_store, overflow, inconsistency,
                         *sc.values(), *keep)
    args.hash, args.ops, args.valid = (row_hash.data_ptr(), ops.data_ptr(),
                                       valid_u8.data_ptr())
    args.pvalid, args.phash = pvalid.data_ptr(), row_hash_store.data_ptr()
    for name, t in sc.items():
        setattr(args, name, t.data_ptr())
    args.overflow = overflow.data_ptr()
    args.inconsistency = inconsistency.data_ptr()
    args.cap, args.S, args.T = cap, S, sc["tkey"].numel()
    args.pv_aligned = int(pvalid.data_ptr() % 16 == 0)
    fn = kernels.entry("topn_pool", "rw_topn_pool_apply",
                       [_PoolArgs, ctypes.c_void_p])
    kernels.count_launch("topn_pool")
    kernels.check(fn(args, kernels.stream_ptr(dev)), "topn_pool")


def pool_apply(rows: tuple, valid: torch.Tensor, row_hash_store: torch.Tensor,
               chunk: Chunk, S: int, overflow: torch.Tensor,
               inconsistency: torch.Tensor) -> None:
    """Apply a changelog chunk to a row pool in place and add the
    overflow and missing-delete counts to the two counters; CUDA tensors
    launch K16."""
    if chunk.device.type == "cuda":
        pool_apply_cuda(rows, valid, row_hash_store, chunk, S, overflow,
                        inconsistency)
        return
    _, _, _, n_over, n_missing = pool_apply_plain(rows, valid,
                                                  row_hash_store, chunk, S)
    overflow.add_(n_over)
    inconsistency.add_(n_missing)


# ---------------------------------------------------------------------------
# K17: the band mask


def _stable_order(order: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """``order`` stably re-sorted by ``key[order]`` (signed int64 or
    uint8 keys)."""
    _, perm = torch.sort(key[order], stable=True)
    return order[perm]


def band_mask_plain(order_cols: Sequence, descending: Sequence[bool],
                    group_cols: Sequence, valid: torch.Tensor, offset: int,
                    limit: int):
    """Plain PyTorch version of K17: (band bool [S], ranks int64 [S],
    the 1-based absolute rank of every slot)."""
    S = valid.shape[0]
    dev = valid.device
    order = torch.arange(S, dtype=torch.int64, device=dev)
    for col, desc in reversed(list(zip(order_cols, descending))):
        order = _stable_order(order, _order_key(col, desc) ^ INT64_MIN)
    gh = hash64_columns(list(group_cols)) if group_cols \
        else torch.zeros(S, dtype=torch.int64, device=dev)
    order = _stable_order(order, gh ^ INT64_MIN)
    order = _stable_order(order, (~valid).to(torch.uint8))
    # the segment scan over the sorted pool
    v = valid[order]
    group_sorted = torch.where(v, gh[order], torch.full_like(gh, -1))
    is_new = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                        group_sorted[1:] != group_sorted[:-1]])
    idx = torch.arange(S, dtype=torch.int32, device=dev)
    start = torch.cummax(torch.where(is_new, idx, torch.zeros_like(idx)),
                         0).values
    rank = idx - start
    band = torch.zeros(S, dtype=torch.bool, device=dev)
    band[order] = v & (rank >= offset) & (rank < offset + limit)
    ranks = torch.zeros(S, dtype=torch.int64, device=dev)
    ranks[order] = (rank + 1).to(torch.int64)
    return band, ranks


#: order-key columns one ``rw_topn_keys`` launch encodes
MAX_ORDER_KEYS = 8


class _KeysArgs(ctypes.Structure):
    """Mirror of ``struct TopnKeysArgs`` in ``csrc/topn_band.cu``."""

    _fields_ = [
        ("group", kernels.RwCols),
        ("okey", ctypes.c_void_p * MAX_ORDER_KEYS),
        ("owidth", ctypes.c_int * MAX_ORDER_KEYS),
        ("odesc", ctypes.c_int * MAX_ORDER_KEYS),
        ("n_order", ctypes.c_int),
        ("out_keys", ctypes.c_void_p), ("gh", ctypes.c_void_p),
        ("S", ctypes.c_int),
    ]


class _BandArgs(ctypes.Structure):
    """Mirror of ``struct TopnBandArgs`` in ``csrc/topn_band.cu``."""

    _fields_ = [
        ("order", ctypes.c_void_p), ("valid", ctypes.c_void_p),
        ("gh", ctypes.c_void_p), ("gs", ctypes.c_void_p),
        ("band", ctypes.c_void_p), ("ranks", ctypes.c_void_p),
        ("S", ctypes.c_int), ("offset", ctypes.c_longlong),
        ("limit", ctypes.c_longlong),
    ]


def band_keys_cuda(order_cols: Sequence, descending: Sequence[bool],
                   group_cols: Sequence, S: int, dev):
    """K17's first launch: the sortable order keys (int64 [n, S]: the
    reference's uint64 key with the sign bit flipped) and the group hash
    (K1's device function; zeros without groups)."""
    if len(order_cols) > MAX_ORDER_KEYS:
        raise ValueError(f"more than {MAX_ORDER_KEYS} order keys")
    args = _KeysArgs()
    keep = []
    for j, (col, desc) in enumerate(zip(order_cols, descending)):
        if isinstance(col, (StrCol, NCol)) or col.dtype == torch.bool \
                or col.dtype.is_floating_point:
            raise NotImplementedError(
                "float, bool and string order keys are not ported to CUDA "
                "yet (queued)")
        col = col.contiguous()
        keep.append(col)
        args.okey[j] = col.data_ptr()
        args.owidth[j] = col.element_size()
        args.odesc[j] = int(desc)
    args.n_order = len(order_cols)
    g = args.group
    if group_cols:
        for k, (d, null, kind) in enumerate(key_leaves(group_cols)):
            d = d.contiguous()
            nu8 = None if null is None else null.contiguous().view(torch.uint8)
            keep += [t for t in (d, nu8) if t is not None]
            g.width[k] = leaf_width(d)
            g.in_data[k] = d.data_ptr()
            g.in_null[k] = kernels.ptr(nu8)
            g.kind[k] = kind
            g.n = k + 1
    keys = torch.empty((max(1, len(order_cols)), S), dtype=torch.int64,
                       device=dev)
    gh = torch.empty(S, dtype=torch.int64, device=dev)
    kernels.require_cuda("topn_band", keys, gh, *keep)
    args.out_keys, args.gh, args.S = keys.data_ptr(), gh.data_ptr(), S
    fn = kernels.entry("topn_band", "rw_topn_keys",
                       [_KeysArgs, ctypes.c_void_p])
    kernels.count_launch("topn_band")
    kernels.check(fn(args, kernels.stream_ptr(dev)), "topn_band")
    return keys[:len(order_cols)], gh


def band_mask_cuda(order_cols: Sequence, descending: Sequence[bool],
                   group_cols: Sequence, valid: torch.Tensor, offset: int,
                   limit: int):
    """K17 (``csrc/topn_band.cu``): keys, the stable sort chain
    (``torch.sort``), then the segment rank, band and scattered rank."""
    S = valid.shape[0]
    dev = valid.device
    keys, gh = band_keys_cuda(order_cols, descending, group_cols, S, dev)
    order = torch.arange(S, dtype=torch.int64, device=dev)
    for j in range(keys.shape[0] - 1, -1, -1):
        order = _stable_order(order, keys[j])
    order = _stable_order(order, gh ^ INT64_MIN)
    valid_u8 = valid.contiguous().view(torch.uint8)
    order = _stable_order(order, 1 - valid_u8)
    band = torch.empty(S, dtype=torch.bool, device=dev)
    ranks = torch.empty(S, dtype=torch.int64, device=dev)
    gs = torch.empty(S, dtype=torch.int64, device=dev)
    kernels.require_cuda("topn_band", order, valid_u8, gh, gs, band, ranks)
    args = _BandArgs(order.data_ptr(), valid_u8.data_ptr(), gh.data_ptr(),
                     gs.data_ptr(), band.data_ptr(), ranks.data_ptr(), S,
                     offset, limit)
    fn = kernels.entry("topn_band", "rw_topn_band",
                       [_BandArgs, ctypes.c_void_p])
    kernels.count_launch("topn_band")
    kernels.check(fn(args, kernels.stream_ptr(dev)), "topn_band")
    return band, ranks


def band_mask(order_cols, descending, group_cols, valid, offset, limit):
    """(band, ranks) of a pool; CUDA tensors launch K17."""
    impl = band_mask_cuda if valid.device.type == "cuda" else band_mask_plain
    return impl(order_cols, descending, group_cols, valid, offset, limit)


# ---------------------------------------------------------------------------
# K18: flush's band diff


def _member_plain(a_hash, a_live, b_hash, b_live) -> torch.Tensor:
    """For each a: does b hold a live copy (rank-aware: the k-th equal
    live a is a member iff b holds more than k equal live copies)?"""
    a_rank = _rank_by(a_hash, a_live)
    b_sorted, _ = torch.sort(b_hash[b_live] ^ INT64_MIN)
    key = a_hash ^ INT64_MIN
    cnt = torch.searchsorted(b_sorted, key, right=True) \
        - torch.searchsorted(b_sorted, key)
    return cnt > a_rank


def _cat(a, b):
    if isinstance(a, StrCol):
        return StrCol(_cat(a.data, b.data), _cat(a.lens, b.lens))
    return torch.cat([a, b], dim=0)


def band_diff_plain(rows: tuple, row_hash: torch.Tensor, ranks, band_idx,
                    prev_rows: tuple, prev_valid, prev_hash):
    """Plain PyTorch version of K18 after K7: (out columns [2E], out
    valid [2E], cur_rows, cur_live, cur_hash).  ``ranks`` is None
    without a rank column."""
    S = row_hash.shape[0]
    cur_live = band_idx < S
    safe = torch.clamp(band_idx, max=S - 1).to(torch.int64)
    cur_rows = tuple(_gather(c, safe) for c in rows)
    cur_hash = torch.where(cur_live, row_hash[safe],
                           torch.zeros_like(row_hash[safe]))
    if ranks is not None:
        # the rank is part of the OUTPUT row: fold it into the diff hash
        cur_rank = torch.where(cur_live, ranks[safe],
                               torch.zeros_like(ranks[safe]))
        cur_rows = cur_rows + (cur_rank,)
        cur_hash = torch.where(cur_live, cur_hash ^ (cur_rank * K1),
                               torch.zeros_like(cur_hash))
    out_cols = tuple(_cat(p, c) for p, c in zip(prev_rows, cur_rows))
    return (out_cols, band_membership_plain(prev_hash, prev_valid, cur_hash,
                                            cur_live),
            cur_rows, cur_live, cur_hash)


def band_membership_plain(prev_hash, prev_valid, cur_hash, cur_live):
    """The ``[2E]`` validity of a band diff: the old entries the new band
    lacks (deletes), then the new entries the old band lacks (inserts),
    by rank-aware multiset membership of the hashes."""
    ins_side = cur_live & ~_member_plain(cur_hash, cur_live, prev_hash,
                                         prev_valid)
    del_side = prev_valid & ~_member_plain(prev_hash, prev_valid, cur_hash,
                                           cur_live)
    return torch.cat([del_side, ins_side])


class _FlushLeaf(ctypes.Structure):
    """Mirror of ``struct FlushLeaf`` in ``csrc/topn_flush.cu``."""

    _fields_ = [("pool", ctypes.c_void_p), ("prev", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("cur", ctypes.c_void_p),
                ("width", ctypes.c_int)]


class _GatherArgs(ctypes.Structure):
    """Mirror of ``struct FlushGatherArgs``."""

    _fields_ = [
        ("leaf", _FlushLeaf * kernels.MAX_COLS), ("n_leaves", ctypes.c_int),
        ("cur_idx", ctypes.c_void_p), ("phash", ctypes.c_void_p),
        ("ranks", ctypes.c_void_p), ("prev_rank", ctypes.c_void_p),
        ("out_rank", ctypes.c_void_p), ("cur_rank", ctypes.c_void_p),
        ("cur_hash", ctypes.c_void_p),
        ("cur_live", ctypes.c_void_p), ("E", ctypes.c_int),
        ("S", ctypes.c_int),
    ]


class _DiffArgs(ctypes.Structure):
    """Mirror of ``struct FlushDiffArgs``."""

    _fields_ = [
        ("skey", ctypes.c_void_p * 2), ("perm", ctypes.c_void_p * 2),
        ("live", ctypes.c_void_p * 2), ("seg", ctypes.c_void_p * 2),
        ("status", ctypes.c_void_p), ("ctl", ctypes.c_void_p),
        ("epoch", ctypes.c_ulonglong), ("out_valid", ctypes.c_void_p),
        ("E", ctypes.c_int), ("n_tiles", ctypes.c_int),
    ]


#: sorted positions a tile of K18's scan (``ST`` in ``csrc/topn_flush.cu``)
DIFF_SCAN_TILE = 512
#: epochs a status word can tag (``epoch << 35`` in a 64-bit word)
_DIFF_EPOCHS = 1 << 29
#: (device, stream) -> K18's membership scratch (``kernels.lookback_scratch``)
#: for bands of up to e entries: run counts int32 [2, e], status words int64
#: [2 * tiles] and the two tickets int32 [2]
_DIFF_SCRATCH: dict = {}


def _diff_tensors(e: int, dev: torch.device) -> tuple:
    tiles = (e + DIFF_SCAN_TILE - 1) // DIFF_SCAN_TILE
    return (torch.empty((2, e), dtype=torch.int32, device=dev),
            torch.zeros(2 * tiles, dtype=torch.int64, device=dev),
            torch.zeros(2, dtype=torch.int32, device=dev))


def band_diff_cuda(rows: tuple, row_hash: torch.Tensor, ranks, band_idx,
                   prev_rows: tuple, prev_valid, prev_hash):
    """K18 (``csrc/topn_flush.cu``): the gather of the band and the old
    band into the out chunk (the band also into ``cur_rows``, buffers of
    its own), the stable sort of each side's hashes (``torch.sort``),
    then the rank-aware membership of both sides."""
    S = row_hash.shape[0]
    E = band_idx.shape[0]
    dev = row_hash.device
    pool_cols = list(rows)
    prev_cols = list(prev_rows[:len(rows)])
    # every row of both is written by the gather: no fill
    out_cols = [_uninit_like_col(c, 2 * E) for c in pool_cols]
    cur_cols = [_uninit_like_col(c, E) for c in pool_cols]
    g = _GatherArgs()
    keep = []
    n = 0
    for pc, vc, oc, cc in zip(pool_cols, prev_cols, out_cols, cur_cols):
        for p, v, o, c in zip(_leaves(pc), _leaves(vc), _leaves(oc),
                              _leaves(cc)):
            if n >= kernels.MAX_COLS:
                raise ValueError(f"more than {kernels.MAX_COLS} band leaves")
            keep += [p, v, o, c]
            leaf = g.leaf[n]
            leaf.pool, leaf.prev = p.data_ptr(), v.data_ptr()
            leaf.out, leaf.cur = o.data_ptr(), c.data_ptr()
            leaf.width = leaf_width(p)
            n += 1
    g.n_leaves = n
    cur_hash = torch.empty(E, dtype=torch.int64, device=dev)
    cur_live = torch.empty(E, dtype=torch.bool, device=dev)
    out_rank = None
    if ranks is not None:
        out_rank = torch.empty(2 * E, dtype=torch.int64, device=dev)
        cur_rank = torch.empty(E, dtype=torch.int64, device=dev)
        keep += [ranks, prev_rows[-1], out_rank, cur_rank]
        g.ranks, g.prev_rank = ranks.data_ptr(), prev_rows[-1].data_ptr()
        g.out_rank, g.cur_rank = out_rank.data_ptr(), cur_rank.data_ptr()
    band_idx = band_idx.contiguous()
    kernels.require_cuda("topn_flush", band_idx, row_hash, cur_hash, cur_live,
                         prev_valid, prev_hash, *keep)
    g.cur_idx, g.phash = band_idx.data_ptr(), row_hash.data_ptr()
    g.cur_hash, g.cur_live = cur_hash.data_ptr(), cur_live.data_ptr()
    g.E, g.S = E, S
    fn = kernels.entry("topn_flush", "rw_topn_flush_gather",
                       [_GatherArgs, ctypes.c_void_p])
    kernels.count_launch("topn_flush")
    kernels.check(fn(g, kernels.stream_ptr(dev)), "topn_flush")

    out_valid = band_membership_cuda(prev_hash, prev_valid, cur_hash,
                                     cur_live)
    if out_rank is not None:
        out_cols.append(out_rank)
        cur_cols.append(cur_rank)
    return tuple(out_cols), out_valid, tuple(cur_cols), cur_live, cur_hash


def band_membership_cuda(prev_hash, prev_valid, cur_hash, cur_live):
    """K18's membership (``rw_topn_flush_diff``: the run scan, then the
    merge) after a stable sort of each side's hashes (``torch.sort``):
    ``band_membership_plain`` on the card, for any pair of (hash, live)
    sides of E entries."""
    E = cur_hash.shape[0]
    dev = cur_hash.device
    d = _DiffArgs()
    out_valid = torch.empty(2 * E, dtype=torch.bool, device=dev)
    (seg, status, ctl), d.epoch = kernels.lookback_scratch(
        _DIFF_SCRATCH, dev, E, _DIFF_EPOCHS, _diff_tensors)
    sides = []
    for s, (h, live) in enumerate(((prev_hash, prev_valid),
                                   (cur_hash, cur_live))):
        skey, perm = torch.sort(h ^ INT64_MIN, stable=True)
        live_u8 = live.contiguous().view(torch.uint8)
        sides += [skey, perm, live_u8]
        d.skey[s], d.perm[s] = skey.data_ptr(), perm.data_ptr()
        d.live[s], d.seg[s] = live_u8.data_ptr(), seg[s].data_ptr()
    kernels.require_cuda("topn_flush", out_valid, seg, status, ctl, *sides)
    d.status, d.ctl = status.data_ptr(), ctl.data_ptr()
    d.out_valid, d.E = out_valid.data_ptr(), E
    d.n_tiles = (E + DIFF_SCAN_TILE - 1) // DIFF_SCAN_TILE
    fn = kernels.entry("topn_flush", "rw_topn_flush_diff",
                       [_DiffArgs, ctypes.c_void_p])
    kernels.count_launch("topn_flush")
    kernels.check(fn(d, kernels.stream_ptr(dev)), "topn_flush")
    return out_valid


def band_diff(rows, row_hash, ranks, band_idx, prev_rows, prev_valid,
              prev_hash):
    """The band diff of ``flush``; CUDA tensors launch K18."""
    impl = band_diff_cuda if row_hash.device.type == "cuda" \
        else band_diff_plain
    return impl(rows, row_hash, ranks, band_idx, prev_rows, prev_valid,
                prev_hash)


def order_keys_cuda_refusal(order_by, schema: Schema) -> str | None:
    """Why K17's key launch cannot encode these ORDER BY keys (it takes
    integer columns: no float, bool or string keys), or None."""
    for e, _ in order_by:
        t = e.return_field(schema).data_type
        if not t.is_integral:
            return (f"ORDER BY on a {t.value} column is not ported to the "
                    "top-N's key kernel (K17)")
    return None


def schema_leaf_count(schema: Schema) -> int:
    """Row-major tensors of a row of ``schema`` (a string has two)."""
    return sum(2 if f.data_type.is_string else 1 for f in schema)


# ---------------------------------------------------------------------------
# K19a: watermark cleaning


def clean_below_plain(col, valid, prev_col, prev_valid, threshold) -> None:
    """Plain PyTorch version of K19a, in place: ``valid &= ~(col <
    threshold)`` on the pool and on the emitted band."""
    valid &= ~(col < threshold)
    prev_valid &= ~(prev_col < threshold)


class _CleanArgs(ctypes.Structure):
    """Mirror of ``struct TopnCleanArgs`` in ``csrc/topn_clean.cu``."""

    _fields_ = [
        ("col", ctypes.c_void_p), ("valid", ctypes.c_void_p),
        ("prev_col", ctypes.c_void_p), ("prev_valid", ctypes.c_void_p),
        ("thr", ctypes.c_void_p), ("width", ctypes.c_int),
        ("S", ctypes.c_int), ("E", ctypes.c_int),
    ]


_INT_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64)


def clean_below_cuda(col, valid, prev_col, prev_valid, threshold) -> None:
    """K19a (``csrc/topn_clean.cu``): one launch, in place; the threshold
    stays on the card."""
    if col.dtype not in _INT_DTYPES or prev_col.dtype != col.dtype:
        raise NotImplementedError(
            f"watermark cleaning on a {col.dtype} column is not ported to "
            "CUDA (integer event times are)")
    thr = torch.as_tensor(threshold, dtype=torch.int64,
                          device=col.device).reshape(1)
    valid_u8 = valid.view(torch.uint8)
    prev_u8 = prev_valid.view(torch.uint8)
    kernels.require_cuda("topn_clean", col, valid_u8, prev_col, prev_u8, thr)
    args = _CleanArgs(col.data_ptr(), valid_u8.data_ptr(),
                      prev_col.data_ptr(), prev_u8.data_ptr(),
                      thr.data_ptr(), col.element_size(), col.shape[0],
                      prev_col.shape[0])
    fn = kernels.entry("topn_clean", "rw_topn_clean",
                       [_CleanArgs, ctypes.c_void_p])
    kernels.count_launch("topn_clean")
    kernels.check(fn(args, kernels.stream_ptr(col.device)), "topn_clean")


def clean_below(col, valid, prev_col, prev_valid, threshold) -> None:
    """Drop the pool and band rows whose column is below ``threshold``
    (a device scalar or a number), in place; CUDA tensors launch K19a."""
    impl = clean_below_cuda if valid.device.type == "cuda" \
        else clean_below_plain
    impl(col, valid, prev_col, prev_valid, threshold)


# ---------------------------------------------------------------------------


class GroupTopNExecutor(Executor):
    """TOP N (+offset) per group over a changelog (plain TopN: no group).

    ``order_by``: (expr, descending) pairs evaluated on the input schema.
    Output = input columns; with ``rank_alias`` set, the 1-based absolute
    row_number is appended (a row whose rank shifts retracts its old
    (row, rank) pair and emits the new one).  With ``watermark_col_idx``
    set, a watermark (from source column ``watermark_src_col``, any when
    None) drops the rows whose column is below its value minus
    ``watermark_lag`` (no reference plan sets it; the over-window's
    ``on_watermark`` calls ``clean_below``)."""

    emits_on_apply = False
    emits_on_flush = True

    def __init__(
        self,
        in_schema: Schema,
        group_by: Sequence[Expr],
        order_by: Sequence[tuple[Expr, bool]],
        limit: int,
        offset: int = 0,
        pool_size: int = 4096,
        emit_capacity: int = 1024,
        watermark_col_idx: int | None = None,
        watermark_lag: int = 0,
        watermark_src_col: int | None = None,
        append_only: bool = False,
        rank_alias: str | None = None,
    ):
        super().__init__(in_schema)
        self.group_by = tuple(group_by)
        self.order_by = tuple(order_by)
        self.limit = limit
        self.offset = offset
        self.pool_size = pool_size
        self.emit_capacity = emit_capacity
        self.watermark_col_idx = watermark_col_idx
        self.watermark_lag = watermark_lag
        self.watermark_src_col = watermark_src_col
        #: append-only input: flush evicts the rows outside the band
        self.append_only = append_only
        self.rank_alias = rank_alias
        if rank_alias is not None:
            self._out_schema = Schema(tuple(in_schema) + (
                Field(rank_alias, DataType.INT64),))
        else:
            self._out_schema = in_schema
        #: the ``[2E]`` op column of the flush chunk, per device
        self._ops: dict = {}

    @property
    def out_schema(self) -> Schema:
        return self._out_schema

    def init_state(self, device) -> TopNState:
        protos = schema_protos(self.in_schema, device)
        protos_prev = protos + [torch.zeros(1, dtype=torch.int64,
                                            device=device)] \
            if self.rank_alias is not None else protos
        S, E = self.pool_size, self.emit_capacity
        z64 = dict(dtype=torch.int64, device=device)
        return TopNState(
            rows=tuple(_empty_like_col(p, S) for p in protos),
            valid=torch.zeros(S, dtype=torch.bool, device=device),
            row_hash=torch.zeros(S, **z64),
            prev_rows=tuple(_empty_like_col(p, E) for p in protos_prev),
            prev_valid=torch.zeros(E, dtype=torch.bool, device=device),
            prev_hash=torch.zeros(E, **z64),
            overflow=torch.zeros((), **z64),
            inconsistency=torch.zeros((), **z64),
        )

    def apply(self, state: TopNState, chunk: Chunk):
        pool_apply(state.rows, state.valid, state.row_hash, chunk,
                   self.pool_size, state.overflow, state.inconsistency)
        return state, None

    def cuda_refusal(self) -> str | None:
        """Why the card's kernels cannot run this top-N, or None."""
        n = schema_leaf_count(self.in_schema)
        if n > kernels.MAX_COLS:
            return (f"a top-N pool row of {n} column leaves (K16 takes "
                    f"{kernels.MAX_COLS})")
        return order_keys_cuda_refusal(self.order_by, self.in_schema)

    def band_inputs(self, state: TopNState):
        """(order-key columns, descending flags, group-key columns) of the
        pool, the inputs of ``band_mask``."""
        S = self.pool_size
        pool_chunk = Chunk(
            state.rows, torch.zeros(S, dtype=torch.int8,
                                    device=state.valid.device),
            state.valid, self.in_schema)
        return ([e.eval(pool_chunk) for e, _ in self.order_by],
                [d for _, d in self.order_by],
                [e.eval(pool_chunk) for e in self.group_by])

    def _band_mask(self, state: TopNState):
        """(band membership, 1-based absolute rank) per pool slot."""
        return band_mask(*self.band_inputs(state), state.valid, self.offset,
                         self.limit)

    def _ops_for(self, device) -> torch.Tensor:
        ops = self._ops.get(device)
        if ops is None:
            E = self.emit_capacity
            ops = torch.cat([
                torch.full((E,), OP_DELETE, dtype=torch.int8, device=device),
                torch.full((E,), OP_INSERT, dtype=torch.int8, device=device)])
            self._ops[device] = ops
        return ops

    def flush(self, state: TopNState, epoch):
        S, E = self.pool_size, self.emit_capacity
        band, ranks = self._band_mask(state)
        # compact the current band to [E] (K7)
        cur_idx = mask_indices(band, E, S)
        out_cols, out_valid, cur_rows, cur_live, cur_hash = band_diff(
            state.rows, state.row_hash,
            ranks if self.rank_alias is not None else None, cur_idx,
            state.prev_rows, state.prev_valid, state.prev_hash)
        out = Chunk(out_cols, self._ops_for(band.device), out_valid,
                    self.out_schema)
        if self.append_only:
            # rows outside the band can never re-enter: evict them
            state.valid.copy_(band)
        return TopNState(
            rows=state.rows,
            valid=state.valid,
            row_hash=state.row_hash,
            prev_rows=cur_rows,
            prev_valid=cur_live,
            prev_hash=cur_hash,
            overflow=state.overflow,
            inconsistency=state.inconsistency,
        ), out

    def on_watermark(self, state: TopNState, watermark):
        if self.watermark_col_idx is None:
            return state
        if (self.watermark_src_col is not None
                and watermark.col_idx != self.watermark_src_col):
            return state
        return self.clean_below(state, self.watermark_col_idx,
                                watermark.value - self.watermark_lag)

    def clean_below(self, state: TopNState, col_idx: int, threshold):
        """Watermark cleaning, in place: the pool and emitted rows whose
        column ``col_idx`` is below ``threshold`` leave (K19a)."""
        clean_below(state.rows[col_idx], state.valid,
                    state.prev_rows[col_idx], state.prev_valid, threshold)
        return state


# ---------------------------------------------------------------------------
# K19b: the append-only dedup


class DedupState(NamedTuple):
    table: HashTable
    overflow: torch.Tensor  # int64: rows wrongly dropped (the table filled)


class AppendOnlyDedupExecutor(Executor):
    """Drop rows whose key was already seen (the reference's, :441; ref
    dedup/append_only_dedup.rs).

    A ``HashTable`` of seen keys: the chunk keeps only the rows that
    freshly inserted their key (K1 and K3's ``lookup_or_insert``, which
    also drops a key's later rows within the chunk).  Overflowed rows are
    counted, and maintenance raises on them.  With ``watermark_key_idx``
    set, a watermark evicts the keys of closed windows through
    ``clear_where`` (the K4 sweep).  The reference's ``maybe_rehash`` is a
    ``lax.cond`` on the device tombstone count; here it is a threshold and
    one host read at maintenance (the port's rule for a ``lax.cond``), and
    the rebuild is ``HashTable.rehashed`` (K1 and K3 over the live keys:
    no value column moves, so K4's permute has nothing to do).  No planner
    builds it."""

    emits_on_apply = True
    emits_on_flush = False

    def __init__(self, in_schema: Schema, key_exprs: Sequence[Expr],
                 table_size: int = 1 << 16,
                 watermark_key_idx: int | None = None,
                 watermark_lag: int = 0,
                 watermark_src_col: int | None = None):
        super().__init__(in_schema)
        self.key_exprs = tuple(key_exprs)
        self.table_size = table_size
        self.watermark_key_idx = watermark_key_idx
        self.watermark_lag = watermark_lag
        self.watermark_src_col = watermark_src_col

    def init_state(self, device) -> DedupState:
        protos = []
        for e in self.key_exprs:
            f = e.return_field(self.in_schema)
            if f.data_type.is_string:
                protos.append(StrCol(
                    torch.zeros((1, f.str_width), dtype=torch.uint8,
                                device=device),
                    torch.zeros(1, dtype=torch.int32, device=device)))
            else:
                protos.append(torch.zeros(1, dtype=f.data_type.physical_dtype,
                                          device=device))
        return DedupState(HashTable.create(protos, self.table_size, device),
                          torch.zeros((), dtype=torch.int64, device=device))

    def apply(self, state: DedupState, chunk: Chunk):
        key_cols = [e.eval(chunk) for e in self.key_exprs]
        table, _, inserted, overflow = state.table.lookup_or_insert(
            key_cols, chunk.valid)
        n_over = (overflow & chunk.valid).sum(dtype=torch.int64)
        # only the rows that inserted a fresh key survive
        return DedupState(table, state.overflow + n_over), \
            chunk.mask(inserted)

    def on_watermark(self, state: DedupState, watermark):
        if self.watermark_key_idx is None:
            return state
        if (self.watermark_src_col is not None
                and watermark.col_idx != self.watermark_src_col):
            return state
        key = state.table.key_cols[self.watermark_key_idx]
        stale = state.table.occupied & (
            key < watermark.value - self.watermark_lag)
        return DedupState(state.table.clear_where(stale), state.overflow)

    def maybe_rehash(self, state: DedupState) -> DedupState:
        """Rebuild the table once tombstones exceed a quarter of it (one
        host read of the tombstone count)."""
        if int(state.table.tombstone_count()) <= self.table_size // 4:
            return state
        fresh, _ = state.table.rehashed()
        return DedupState(fresh, state.overflow)
