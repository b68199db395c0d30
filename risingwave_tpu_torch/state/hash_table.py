"""Open-addressing hash table on the device.

Port of ``HashTable`` from ``risingwave_tpu/state/hash_table.py``
(:152-385) and ``permute_dense`` (:115), which on the card is K4
(``csrc/permute.cu``, ``permute_rows``: every column of a table moves in
one entry; ``permute_rows_plain`` is its plain version).  State is a
dense table of ``size`` slots (a power of two):

- ``key_cols``: one ``[size]`` tensor per key column (``NCol`` for
  nullable keys, ``StrCol`` for strings);
- ``occupied`` / ``tombstone``: ``bool [size]``.

``lookup_or_insert`` resolves a whole chunk of keys at once with the
reference's round-based linear probe (``_probe``): the lowest row index
wins a contended empty slot, tombstones are skipped and never claimed,
and rows left after ``min(size + 2, 1024)`` rounds overflow.  String
keys compare as the reference's ``_keys_equal`` does: every byte of the
``[size, w]`` store, the padding past ``lens`` included, and ``lens``;
float keys compare with IEEE ``==``, subnormals as zero (the
reference's compares run with denormals-are-zero).  The slot
layout is identical to the reference's, so state tensors compare
element for element.  On the card the probe is kernel B
(``csrc/probe.cu``); ``_probe_plain`` is its plain PyTorch version.

``clear_where`` and ``clear_slots`` tombstone slots by a ``[size]``
predicate or a slot list; on the card both are the K4 sweep
(``csrc/table_sweep.cu``, ``table_sweep``, which ``TagTable`` shares);
``clear_where_plain`` and ``clear_slots_plain`` are the plain versions.

Unlike the reference's pure functions, the table is updated IN PLACE:
``lookup_or_insert``, ``clear_where`` and ``clear_slots`` write
``occupied``, ``tombstone`` and the key store of this table and return
it, which saves a copy of every table tensor per chunk.  Holders of an
older view (snapshots) keep clones.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from risingwave_tpu_torch import kernels
from risingwave_tpu_torch.common.chunk import NCol, StrCol
from risingwave_tpu_torch.common.hash import (
    daz,
    hash64_columns_cuda,
    hash64_columns_plain,
    key_leaves,
    leaf_width,
)


def gather_key(col, idx: torch.Tensor):
    """Key column values at ``idx`` (NCol/StrCol-aware)."""
    if isinstance(col, NCol):
        return NCol(gather_key(col.data, idx), col.null[idx])
    if isinstance(col, StrCol):
        return StrCol(col.data[idx], col.lens[idx])
    return col[idx]


def scatter_key_(col, idx: torch.Tensor, values) -> None:
    """In place: ``col[idx] = values`` (indices unique)."""
    if isinstance(col, NCol):
        scatter_key_(col.data, idx, values.data)
        col.null[idx] = values.null
    elif isinstance(col, StrCol):
        col.data[idx] = values.data
        col.lens[idx] = values.lens
    else:
        col[idx] = values


def keys_equal(a, b) -> torch.Tensor:
    """Rowwise grouping equality (NULL == NULL)."""
    if isinstance(a, NCol) or isinstance(b, NCol):
        ad, an = (a.data, a.null) if isinstance(a, NCol) else (a, None)
        bd, bn = (b.data, b.null) if isinstance(b, NCol) else (b, None)
        data_eq = keys_equal(ad, bd)
        if an is None:
            an = torch.zeros_like(bn)
        if bn is None:
            bn = torch.zeros_like(an)
        return (an & bn) | (~an & ~bn & data_eq)
    if isinstance(a, StrCol):
        return (a.data == b.data).all(dim=-1) & (a.lens == b.lens)
    if a.dtype.is_floating_point:
        # IEEE ==, subnormals as zero (the reference's compares run with
        # denormals-are-zero): -0.0 equals +0.0, NaN equals nothing
        return daz(a) == daz(b)
    return a == b


def _dense_op(arr, fn):
    if isinstance(arr, NCol):
        return NCol(_dense_op(arr.data, fn), _dense_op(arr.null, fn))
    if isinstance(arr, StrCol):
        return StrCol(_dense_op(arr.data, fn), _dense_op(arr.lens, fn))
    return fn(arr)


def _col_leaves(arr, init) -> list[tuple[torch.Tensor, object]]:
    """(tensor, init) of a column's leaves: as in the reference, the
    parts of an ``NCol`` / ``StrCol`` move with zero fill."""
    if isinstance(arr, (NCol, StrCol)):
        return [t for v in arr for t in _col_leaves(v, None)]
    return [(arr, init)]


def _rebuild_col(proto, it):
    if isinstance(proto, NCol):
        return NCol(_rebuild_col(proto.data, it), _rebuild_col(proto.null, it))
    if isinstance(proto, StrCol):
        return StrCol(_rebuild_col(proto.data, it),
                      _rebuild_col(proto.lens, it))
    return next(it)


def permute_dense_many(arrs, moved: torch.Tensor, init=None) -> list:
    """``permute_dense`` of several columns of one table (plain arrays,
    ``NCol``s, ``StrCol``s) by the same ``moved``; on the card one K4
    entry moves them all."""
    pairs = [p for a in arrs for p in _col_leaves(a, init)]
    out = iter(permute_rows([t for t, _ in pairs], moved,
                            [i for _, i in pairs]))
    return [_rebuild_col(a, out) for a in arrs]


def permute_dense(arr, moved: torch.Tensor, init=None):
    """``out[moved[old]] = arr[old]``; ``moved`` comes from
    ``HashTable.rehashed`` (dead slots carry the ``size`` sentinel);
    ``init`` fills untouched slots (zero when None)."""
    return permute_dense_many([arr], moved, init)[0]


def permute_rows(cols: list, moved: torch.Tensor, inits=None) -> list:
    """K4 (``csrc/permute.cu``): the row permutation of plain tensors
    sharing their leading dimension with ``moved``; ``inits`` gives each
    column's fill (None: zero).  The plain version serves CPU tensors
    only."""
    if not isinstance(inits, (list, tuple)):
        inits = [inits] * len(cols)
    if moved.device.type != "cuda":
        return [permute_rows_plain(c, moved, i)
                for c, i in zip(cols, inits)]
    moved = moved.to(torch.int32)
    size = moved.shape[0]
    outs = [torch.empty_like(c) for c in cols]
    kernels.require_cuda("permute_rows", moved, *cols, *outs)
    fn = kernels.entry("permute_rows", "rw_permute_rows", [
        ctypes.POINTER(_PermDesc), ctypes.c_void_p, ctypes.c_void_p])
    for lo in range(0, len(cols), kernels.MAX_COLS):
        d = _PermDesc()
        d.n_cols = min(kernels.MAX_COLS, len(cols) - lo)
        d.size = size
        hi = lo + kernels.MAX_COLS
        for k, (c, o, init) in enumerate(zip(cols[lo:hi], outs[lo:hi],
                                             inits[lo:hi])):
            if c.shape[0] != size:
                raise ValueError("permute_rows: columns must have "
                                 f"{size} rows, got {c.shape[0]}")
            col = d.col[k]
            col.in_, col.out = c.data_ptr(), o.data_ptr()
            col.row_bytes = c[0].numel() * c.element_size() if size else 0
            col.esize = c.element_size()
            col.init = _init_bits(c.dtype, init)
        kernels.count_launch("permute_rows")
        kernels.check(fn(ctypes.byref(d), moved.data_ptr(),
                         kernels.stream_ptr(moved.device)), "permute_rows")
    return outs


def _init_bits(dtype, init) -> int:
    """One element of ``init`` (zero when None) as an unsigned bit
    pattern of ``dtype``'s width."""
    if init is None:
        return 0
    t = torch.tensor(init, dtype=dtype).reshape(1)
    raw = t.view(torch.uint8).tolist()
    return int.from_bytes(bytes(raw), "little")


def permute_rows_plain(a: torch.Tensor, moved: torch.Tensor, init=None):
    """Plain version of one column of ``permute_rows``."""
    size = moved.shape[0]
    tgt = moved.to(torch.int64)
    out = torch.zeros((size + 1,) + a.shape[1:], dtype=a.dtype,
                      device=a.device)
    if init is not None:
        out.fill_(init)
    # live targets are unique; dead slots all land on the dump row
    out.index_put_((tgt,), a)
    return out[:size].contiguous()


class _PermCol(ctypes.Structure):
    """Mirror of ``struct PermCol`` in ``csrc/permute.cu``."""

    _fields_ = [("in_", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("row_bytes", ctypes.c_int), ("esize", ctypes.c_int),
                ("init", ctypes.c_ulonglong)]


class _PermDesc(ctypes.Structure):
    """Mirror of ``struct PermDesc`` (passed to the kernels by value)."""

    _fields_ = [("n_cols", ctypes.c_int), ("size", ctypes.c_int),
                ("col", _PermCol * kernels.MAX_COLS)]


class _SweepArgs(ctypes.Structure):
    """Mirror of ``struct TableSweepArgs`` in ``csrc/table_sweep.cu``."""

    _fields_ = [("occupied", ctypes.c_void_p),
                ("tombstone", ctypes.c_void_p), ("tags", ctypes.c_void_p),
                ("pred", ctypes.c_void_p), ("slots", ctypes.c_void_p),
                ("mask", ctypes.c_void_p), ("n", ctypes.c_int),
                ("size", ctypes.c_int)]


def table_sweep(size: int, *, occupied=None, tombstone=None, tags=None,
                pred=None, slots=None, mask=None) -> None:
    """The K4 sweep (``csrc/table_sweep.cu``), in place, on CUDA tensors:
    tombstone a HashTable's (``occupied``, ``tombstone``) planes or a
    TagTable's ``tags`` where ``pred [size]`` holds on an occupied slot,
    or at ``slots[mask]`` (sentinel slots dropped)."""
    planes = [tags] if tags is not None else [occupied.view(torch.uint8),
                                              tombstone.view(torch.uint8)]
    a = _SweepArgs()
    if tags is None:
        a.occupied, a.tombstone = planes[0].data_ptr(), planes[1].data_ptr()
    else:
        a.tags = tags.data_ptr()
    if pred is not None:
        flags = [pred.contiguous().view(torch.uint8)]
        if flags[0].shape[0] != size:
            raise ValueError(f"table_sweep: pred has {flags[0].shape[0]} "
                             f"entries, the table {size}")
        a.pred, a.n = flags[0].data_ptr(), size
    else:
        flags = [slots.to(torch.int32).contiguous(),
                 mask.contiguous().view(torch.uint8)]
        a.slots, a.mask = flags[0].data_ptr(), flags[1].data_ptr()
        a.n = flags[0].shape[0]
    a.size = size
    kernels.require_cuda("table_sweep", *planes, *flags)
    fn = kernels.entry("table_sweep", "rw_table_sweep",
                       [_SweepArgs, ctypes.c_void_p])
    kernels.count_launch("table_sweep")
    kernels.check(fn(a, kernels.stream_ptr(planes[0].device)), "table_sweep")


def _empty_key_col(proto, size: int, device):
    if isinstance(proto, NCol):
        return NCol(_empty_key_col(proto.data, size, device),
                    torch.zeros(size, dtype=torch.bool, device=device))
    if isinstance(proto, StrCol):
        return StrCol(
            torch.zeros((size, proto.data.shape[1]), dtype=torch.uint8,
                        device=device),
            torch.zeros(size, dtype=torch.int32, device=device),
        )
    return torch.zeros(size, dtype=proto.dtype, device=device)


def _probe_entry():
    return kernels.entry("probe", "rw_probe", [_ProbeArgs, ctypes.c_void_p])


class _ProbeArgs(ctypes.Structure):
    """Mirror of ``struct ProbeArgs`` in ``csrc/probe.cu``."""

    _fields_ = [
        ("keys", kernels.RwCols),
        ("start", ctypes.c_void_p), ("valid", ctypes.c_void_p),
        ("occupied", ctypes.c_void_p), ("tombstone", ctypes.c_void_p),
        ("slots", ctypes.c_void_p), ("inserted", ctypes.c_void_p),
        ("pending", ctypes.c_void_p), ("list", ctypes.c_void_p),
        ("cand", ctypes.c_void_p), ("claim", ctypes.c_void_p),
        ("ctl", ctypes.c_void_p), ("n_over", ctypes.c_void_p),
        ("cap", ctypes.c_int), ("size", ctypes.c_int),
        ("insert", ctypes.c_int), ("max_iters", ctypes.c_int),
        ("grid_only", ctypes.c_int),
    ]


_INT32_MAX = 2**31 - 1
#: the control words after the claim scratch, at their rest values
#: (``RW_CTL_*`` in ``csrc/rw_claim.cuh``): list lengths 0, next rounds and
#: the least entry round INT_MAX, the walk's overflow sum and ticket 0;
#: words 8-10 hold the last insert's claimants, grid rounds and one-block
#: rounds; K12's ranked insert (``tag_table``) shares the scratch: its last
#: resolving round and overflow count (words 11, 12) rest at 0, and words
#: 13-15 hold its last call's listed rows and rounds
_CTL_REST = (0, 0, _INT32_MAX, _INT32_MAX, _INT32_MAX, 0, 0, 0,
             0, 0, 0, 0, 0, 0, 0, 0)
#: (device, stream) -> int32 [4 * p + 16]: the probe's claim scratch at
#: its rest value (above every row index) and its control words, for
#: chunks of up to p rows (p a power of two, grown to the largest chunk
#: probed on that stream; the kernel uses the first 4 * cap entries).
#: Every call leaves it as it found it.  One a stream: two probes on
#: different streams must not share the control words.
_CLAIM_SCRATCH: dict = {}


def _claim_scratch(dev: torch.device, cap: int) -> torch.Tensor:
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    key = (dev, kernels.stream_ptr(dev))
    t = _CLAIM_SCRATCH.get(key)
    if t is None or t.numel() - len(_CTL_REST) < 4 * cap:
        p = 1 << max(cap - 1, 0).bit_length()
        t = torch.full((4 * p + len(_CTL_REST),), _INT32_MAX,
                       dtype=torch.int32, device=dev)
        t[4 * p:] = torch.tensor(_CTL_REST, dtype=torch.int32)
        _CLAIM_SCRATCH[key] = t
    return t


def probe_claim_stats(dev: torch.device) -> tuple[int, int, int]:
    """(claimants, grid rounds, one-block rounds) of the last insert on
    ``dev``'s current stream (a host read, for checks and reports)."""
    ctl = _claim_scratch(dev, 0)[-len(_CTL_REST):][8:11].tolist()
    return ctl[0], ctl[1], ctl[2]


class HashTable:
    """Keys + occupancy; value tensors live beside it in executor state."""

    __slots__ = ("key_cols", "occupied", "tombstone", "size")

    def __init__(self, key_cols: tuple, occupied: torch.Tensor,
                 tombstone: torch.Tensor, size: int):
        self.key_cols = tuple(key_cols)
        self.occupied = occupied
        self.tombstone = tombstone
        self.size = size

    @staticmethod
    def create(key_protos: Sequence, size: int, device) -> "HashTable":
        """Empty table; ``key_protos`` supply per-column dtype/width."""
        if size & (size - 1):
            raise ValueError(f"size {size} must be a power of two")
        return HashTable(
            tuple(_empty_key_col(p, size, device) for p in key_protos),
            torch.zeros(size, dtype=torch.bool, device=device),
            torch.zeros(size, dtype=torch.bool, device=device),
            size,
        )

    @property
    def device(self) -> torch.device:
        return self.occupied.device

    def tombstone_count(self) -> torch.Tensor:
        return (self.tombstone & ~self.occupied).sum(dtype=torch.int64)

    # ------------------------------------------------------------------
    def lookup(self, key_cols: Sequence, valid: torch.Tensor,
               hashes: torch.Tensor | None = None):
        """(slots int32 [cap], found bool [cap]) without inserting."""
        slots, found, _ = self.lookup_counted(key_cols, valid, hashes)
        return slots, found

    def lookup_counted(self, key_cols: Sequence, valid: torch.Tensor,
                       hashes: torch.Tensor | None = None):
        """``lookup`` plus the probe-bound overflow count (int64 scalar)."""
        _, slots, found, overflow, n_over = self._probe(
            key_cols, valid, insert=False, hashes=hashes)
        return slots, found, n_over

    def lookup_or_insert(self, key_cols: Sequence, valid: torch.Tensor,
                         hashes: torch.Tensor | None = None):
        """Find-or-claim slots for a chunk of keys, in place.

        Returns ``(self, slots int32 [cap], inserted bool [cap],
        overflow bool [cap])``; invalid and overflowed rows get the
        ``size`` sentinel slot."""
        table, slots, inserted, overflow, _ = self._probe(
            key_cols, valid, insert=True, hashes=hashes)
        return table, slots, inserted, overflow

    # ------------------------------------------------------------------
    def _probe(self, key_cols, valid, insert: bool, hashes=None):
        if valid.device.type == "cuda":
            return self._probe_cuda(key_cols, valid, insert, hashes)
        return self._probe_plain(key_cols, valid, insert, hashes)

    def _start(self, hashes: torch.Tensor) -> torch.Tensor:
        return (hashes & (self.size - 1)).to(torch.int32)

    def _probe_plain(self, key_cols, valid, insert: bool, hashes=None):
        """Plain PyTorch version of kernel B (``HashTable._probe``)."""
        size = self.size
        cap = valid.shape[0]
        dev = valid.device
        if hashes is None:
            hashes = hash64_columns_plain(key_cols)
        start = self._start(hashes)
        row_idx = torch.arange(cap, dtype=torch.int32, device=dev)
        slots = torch.full((cap,), size, dtype=torch.int32, device=dev)
        done = ~valid
        inserted = torch.zeros(cap, dtype=torch.bool, device=dev)
        off = torch.zeros(cap, dtype=torch.int32, device=dev)
        m = 4 * cap
        for it in range(min(size + 2, 1024)):
            if it > 0 and bool(done.all()):
                break
            cand = (start + off) & (size - 1)
            cand_l = cand.to(torch.int64)
            occ = self.occupied[cand_l]
            tomb = self.tombstone[cand_l] & ~occ
            match = occ.clone()
            for s, k in zip(self.key_cols, key_cols):
                match &= keys_equal(gather_key(s, cand_l), k)
            hit = ~done & match
            slots = torch.where(hit, cand, slots)
            done = done | hit
            if insert:
                want = ~done & ~occ & ~tomb
                sidx = (cand % m).to(torch.int64)
                claim = torch.full((m + 1,), cap, dtype=torch.int32,
                                   device=dev)
                claim.scatter_reduce_(
                    0, torch.where(want, sidx, torch.full_like(sidx, m)),
                    torch.where(want, row_idx, torch.full_like(row_idx, cap)),
                    reduce="amin")
                won = want & (claim[sidx] == row_idx)
                pos = cand_l[won]
                self.occupied[pos] = True
                for s, k in zip(self.key_cols, key_cols):
                    scatter_key_(s, pos, gather_key(k, won))
                slots = torch.where(won, cand, slots)
                inserted = inserted | won
                done = done | won
            else:
                done = done | (~done & ~occ & ~tomb)
            advance = (~done & occ & ~match) | (~done & tomb)
            off = torch.where(advance, off + 1, off)
        overflow = ~done
        n_over = (overflow & valid).sum(dtype=torch.int64)
        if insert:
            return self, slots, inserted, overflow, n_over
        found = valid & done & ~inserted & (slots < size)
        return self, slots, found, overflow, n_over

    def _probe_cuda(self, key_cols, valid, insert: bool, hashes=None,
                    grid_only: bool = False):
        """Kernel B (``csrc/probe.cu``): the walk, then (inserts) the
        claim rounds over the claimants; no host sync.  ``grid_only``
        keeps every claim round on the cooperative grid (for checks of
        that branch on short claimant lists)."""
        size = self.size
        cap = valid.shape[0]
        dev = valid.device
        if hashes is None:
            _, start = hash64_columns_cuda(key_cols, size)
        else:
            start = self._start(hashes)
        in_leaves = key_leaves(key_cols)
        st_leaves = key_leaves(self.key_cols)
        if len(in_leaves) != len(st_leaves):
            raise ValueError("key column count differs from the table's")
        args = _ProbeArgs()
        keys = args.keys
        keys.n = len(in_leaves)
        keep = []
        for k, ((d, nl, kind), (sd, snl, _)) in enumerate(
                zip(in_leaves, st_leaves)):
            d = d.contiguous()
            if d.dtype != sd.dtype or d.shape[1:] != sd.shape[1:]:
                raise ValueError(f"key column {k}: {d.dtype} chunk column "
                                 f"against a {sd.dtype} key store")
            if (nl is None) != (snl is None):
                raise ValueError(f"key column {k}: nullability differs")
            nu8 = None if nl is None else nl.contiguous().view(torch.uint8)
            snu8 = None if snl is None else snl.view(torch.uint8)
            keep += [t for t in (d, sd, nu8, snu8) if t is not None]
            keys.width[k] = leaf_width(d)
            keys.kind[k] = kind
            keys.in_data[k] = d.data_ptr()
            keys.st_data[k] = sd.data_ptr()
            keys.in_null[k] = kernels.ptr(nu8)
            keys.st_null[k] = kernels.ptr(snu8)
        valid_u8 = valid.contiguous().view(torch.uint8)
        start = start.contiguous()
        occ_u8 = self.occupied.view(torch.uint8)
        tomb_u8 = self.tombstone.view(torch.uint8)
        kernels.require_cuda("probe", valid_u8, start, occ_u8, tomb_u8, *keep)
        i32 = dict(dtype=torch.int32, device=dev)
        u8 = dict(dtype=torch.uint8, device=dev)
        slots = torch.empty(cap, **i32)
        inserted = torch.empty(cap, **u8)
        pending = torch.empty(cap, **u8)
        lists = torch.empty((2 * cap, 2), **i32)
        cand = torch.empty(cap, **i32)
        scratch = _claim_scratch(dev, cap)
        n_over = torch.empty((), dtype=torch.int64, device=dev)
        args.start, args.valid = start.data_ptr(), valid_u8.data_ptr()
        args.occupied, args.tombstone = occ_u8.data_ptr(), tomb_u8.data_ptr()
        args.slots, args.inserted = slots.data_ptr(), inserted.data_ptr()
        args.pending, args.list = pending.data_ptr(), lists.data_ptr()
        args.cand, args.claim = cand.data_ptr(), scratch.data_ptr()
        args.ctl = scratch[-len(_CTL_REST):].data_ptr()
        args.n_over = n_over.data_ptr()
        args.cap, args.size = cap, size
        args.insert = int(insert)
        args.max_iters = min(size + 2, 1024)
        args.grid_only = int(grid_only)
        kernels.count_launch("probe")
        rc = _probe_entry()(args, kernels.stream_ptr(dev))
        kernels.check(rc, "probe")
        inserted = inserted.view(torch.bool)
        overflow = pending.view(torch.bool)
        if insert:
            return self, slots, inserted, overflow, n_over
        found = valid & ~overflow & (slots < size)
        return self, slots, found, overflow, n_over

    # ------------------------------------------------------------------
    def clear_where(self, pred: torch.Tensor) -> "HashTable":
        """In place: tombstone the occupied slots where ``pred`` holds;
        CUDA tensors launch the K4 sweep."""
        if pred.device.type != "cuda":
            return self.clear_where_plain(pred)
        table_sweep(self.size, occupied=self.occupied,
                    tombstone=self.tombstone, pred=pred)
        return self

    def clear_where_plain(self, pred: torch.Tensor) -> "HashTable":
        """Plain PyTorch version of ``clear_where``."""
        dead = pred & self.occupied
        self.occupied &= ~dead
        self.tombstone |= dead
        return self

    def clear_slots(self, slots: torch.Tensor, mask: torch.Tensor) -> "HashTable":
        """In place: tombstone ``slots[mask]`` (sentinel slots dropped);
        CUDA tensors launch the K4 sweep."""
        if mask.device.type != "cuda":
            return self.clear_slots_plain(slots, mask)
        table_sweep(self.size, occupied=self.occupied,
                    tombstone=self.tombstone, slots=slots, mask=mask)
        return self

    def clear_slots_plain(self, slots: torch.Tensor,
                          mask: torch.Tensor) -> "HashTable":
        """Plain PyTorch version of ``clear_slots``."""
        pos = torch.where(mask, slots, torch.full_like(slots, self.size))
        occ = torch.cat([self.occupied, self.occupied.new_zeros(1)])
        tomb = torch.cat([self.tombstone, self.tombstone.new_zeros(1)])
        occ[pos.to(torch.int64)] = False
        tomb[pos.to(torch.int64)] = True
        self.occupied.copy_(occ[: self.size])
        self.tombstone.copy_(tomb[: self.size])
        return self

    def rehashed(self) -> tuple["HashTable", torch.Tensor]:
        """(fresh table without tombstones, moved int32 [size]) where
        ``moved`` maps old slot -> new slot (``size`` for dead slots)."""
        fresh = HashTable.create(
            tuple(gather_key(c, torch.arange(1, device=self.device))
                  for c in self.key_cols),
            self.size, self.device)
        fresh, new_slots, _, _ = fresh.lookup_or_insert(
            self.key_cols, self.occupied)
        return fresh, new_slots

    def gather_keys(self, slots: torch.Tensor) -> tuple:
        """Key values at ``slots`` (the ``size`` sentinel reads the last
        slot, as in the reference)."""
        safe = torch.clamp(slots, max=self.size - 1).to(torch.int64)
        return tuple(gather_key(c, safe) for c in self.key_cols)

    def clone(self) -> "HashTable":
        return HashTable(
            tuple(_dense_op(c, torch.clone) for c in self.key_cols),
            self.occupied.clone(), self.tombstone.clone(), self.size)
