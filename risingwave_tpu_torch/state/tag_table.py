"""The fused ``(key-hash, rank)`` tag table behind pool join sides.

Port of ``TagTable`` from ``risingwave_tpu/state/hash_table.py``
(:383-695): open addressing over ONE packed 64-bit tag per entry, with
``EMPTY_TAG`` (0) and ``TOMB_TAG`` (1) reserved.  The rank-r row of a
join key owns the entry for ``pair_tag(hash(key), r)``; the key's rank-0
entry is its HEAD, where the executor keeps the key's degree.

The reference's tags are uint64; the port keeps the same bit patterns in
int64 tensors (``tags.view(np.uint64)`` on the host gives the
reference's values).  So ``occupied`` is ``tag not in {0, 1}`` rather
than an unsigned ``>= 2``, and ``tag % size`` is ``tag & (size - 1)``
(sizes are powers of two, as ``create`` enforces).

Kernel K12 (``csrc/tag_probe.cu``) runs the probes on the card:

- ``tag_insert_ranked``: ``lookup_or_insert_ranked`` (:525) for a chunk
  of rows: a grid walk over the call-start table, then the reference's
  rounds over the rows that reach a true-empty slot (a cooperative grid,
  then one block), on the probe's claim scratch (``hash_table``'s
  ``_claim_scratch``);
- ``tag_probe``: ``_probe_tags`` (:450).  A lookup is one thread per
  row (a lookup never writes the table, so each row's own walk up to
  the round bound is the reference's result); an insert (``rehashed``,
  :686, which re-inserts every live tag of the table) is one
  cooperative grid that keeps the reference's rounds with grid-wide
  barriers.

``clear_where`` and ``clear_slots`` launch the K4 sweep
(``table_sweep``, ``csrc/table_sweep.cu``) on the card.  The ``*_plain``
methods are the plain PyTorch versions.  As in the
port's ``HashTable``, the table is updated IN PLACE by the inserts and
the clears; ``clone`` gives a snapshot.
"""

from __future__ import annotations

import ctypes

import torch

from risingwave_tpu_torch import kernels
from risingwave_tpu_torch.common.hash import (
    hash64_extend,
    hash64_finish,
    hash64_partial,
)
from risingwave_tpu_torch.state.hash_table import (
    _CTL_REST,
    _claim_scratch,
    table_sweep,
)

#: reserved tag values (the tag hash remaps into [2, 2^64))
EMPTY_TAG = 0
TOMB_TAG = 1


def finish_tag(state: torch.Tensor) -> torch.Tensor:
    """Finalize a partial hash into a tag: values 0 and 1 move up by 2
    (unsigned ``raw < 2`` is ``raw in {0, 1}`` on the bit pattern)."""
    raw = hash64_finish(state)
    return torch.where((raw == 0) | (raw == 1), raw + 2, raw)


def pair_tag(hashes: torch.Tensor, rank: torch.Tensor) -> torch.Tensor:
    """The 64-bit identity tag of a ``(key-hash, rank)`` pair."""
    return finish_tag(hash64_extend(hash64_partial([hashes]), rank))


def _occupied(tags: torch.Tensor) -> torch.Tensor:
    return (tags != EMPTY_TAG) & (tags != TOMB_TAG)


class _LookupArgs(ctypes.Structure):
    """Mirror of ``struct TagLookupArgs`` in ``csrc/tag_probe.cu``."""

    _fields_ = [
        ("keys", ctypes.c_void_p), ("ranks", ctypes.c_void_p),
        ("valid", ctypes.c_void_p), ("tags", ctypes.c_void_p),
        ("slots", ctypes.c_void_p), ("found", ctypes.c_void_p),
        ("overflow", ctypes.c_void_p), ("n_over", ctypes.c_void_p),
        ("cap", ctypes.c_int), ("size", ctypes.c_int),
        ("max_iters", ctypes.c_int),
    ]


class _InsertArgs(ctypes.Structure):
    """Mirror of ``struct TagInsertArgs`` in ``csrc/tag_probe.cu``."""

    _fields_ = [
        ("keys", ctypes.c_void_p), ("valid", ctypes.c_void_p),
        ("tags", ctypes.c_void_p), ("slots", ctypes.c_void_p),
        ("inserted", ctypes.c_void_p), ("pending", ctypes.c_void_p),
        ("off", ctypes.c_void_p), ("cand", ctypes.c_void_p),
        ("want", ctypes.c_void_p), ("claim", ctypes.c_void_p),
        ("counts", ctypes.c_void_p), ("n_over", ctypes.c_void_p),
        ("cap", ctypes.c_int), ("size", ctypes.c_int),
        ("max_iters", ctypes.c_int),
    ]


class _RankedArgs(ctypes.Structure):
    """Mirror of ``struct TagRankedArgs`` in ``csrc/tag_probe.cu``."""

    _fields_ = [
        ("hashes", ctypes.c_void_p), ("chunk_rank", ctypes.c_void_p),
        ("degree", ctypes.c_void_p), ("valid", ctypes.c_void_p),
        ("tags", ctypes.c_void_p), ("slots", ctypes.c_void_p),
        ("target", ctypes.c_void_p), ("head_slot", ctypes.c_void_p),
        ("inserted", ctypes.c_void_p), ("existed", ctypes.c_void_p),
        ("pending", ctypes.c_void_p), ("iters", ctypes.c_void_p),
        ("list", ctypes.c_void_p), ("cand", ctypes.c_void_p),
        ("claim", ctypes.c_void_p), ("ctl", ctypes.c_void_p),
        ("cap", ctypes.c_int), ("size", ctypes.c_int),
        ("max_iters", ctypes.c_int), ("grid_only", ctypes.c_int),
    ]


def ranked_claim_stats(dev: torch.device) -> tuple[int, int, int]:
    """(listed rows, grid rounds, one-block rounds) of the last ranked
    insert on ``dev``'s current stream (a host read, for checks and
    reports)."""
    ctl = _claim_scratch(dev, 0)[-len(_CTL_REST):][13:16].tolist()
    return ctl[0], ctl[1], ctl[2]


def _u8(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8)


class TagTable:
    """Open addressing over one int64 tag array (tag bit patterns)."""

    __slots__ = ("tags", "size")

    def __init__(self, tags: torch.Tensor, size: int):
        self.tags = tags
        self.size = size

    @staticmethod
    def create(size: int, device) -> "TagTable":
        if size & (size - 1):
            raise ValueError(f"size {size} must be a power of two")
        return TagTable(torch.zeros(size, dtype=torch.int64, device=device),
                        size)

    @property
    def device(self) -> torch.device:
        return self.tags.device

    def clone(self) -> "TagTable":
        return TagTable(self.tags.clone(), self.size)

    # -- occupancy ------------------------------------------------------
    @property
    def occupied(self) -> torch.Tensor:
        return _occupied(self.tags)

    def count(self) -> torch.Tensor:
        return self.occupied.sum(dtype=torch.int32)

    def tombstone_count(self) -> torch.Tensor:
        return (self.tags == TOMB_TAG).sum(dtype=torch.int32)

    # -- probes ---------------------------------------------------------
    def _probe_tags(self, tag_vals: torch.Tensor, valid: torch.Tensor,
                    insert: bool, ranks: torch.Tensor | None = None):
        """Find (or claim, when ``insert``) the entries of ``tag_vals``,
        or of ``pair_tag(tag_vals, ranks)`` when ``ranks`` is given.

        Returns ``(self, slots, found, overflow, inserted)``; an insert
        writes the claimed tags in place."""
        if valid.device.type == "cuda":
            if insert:
                if ranks is not None:
                    tag_vals = pair_tag(tag_vals, ranks)
                return self._insert_cuda(tag_vals, valid)
            slots, found, overflow, _ = self._lookup_cuda(tag_vals, ranks,
                                                          valid)
            return self, slots, found, overflow, torch.zeros_like(found)
        if ranks is not None:
            tag_vals = pair_tag(tag_vals, ranks)
        return self._probe_tags_plain(tag_vals, valid, insert)

    def _probe_tags_plain(self, tag_vals: torch.Tensor, valid: torch.Tensor,
                          insert: bool):
        """Plain PyTorch version of kernel K12's ``tag_probe``."""
        size = self.size
        cap = valid.shape[0]
        dev = valid.device
        row_idx = torch.arange(cap, dtype=torch.int32, device=dev)
        home = (tag_vals & (size - 1)).to(torch.int32)
        slots = torch.full((cap,), size, dtype=torch.int32, device=dev)
        done = ~valid
        inserted = torch.zeros(cap, dtype=torch.bool, device=dev)
        off = torch.zeros(cap, dtype=torch.int32, device=dev)
        m = 4 * cap
        for it in range(min(size + 2, 1024)):
            if it > 0 and bool(done.all()):
                break
            cand = (home + off) & (size - 1)
            cand_l = cand.to(torch.int64)
            t = self.tags[cand_l]
            tomb = t == TOMB_TAG
            empty = t == EMPTY_TAG
            match = t == tag_vals
            hit = ~done & match
            slots = torch.where(hit, cand, slots)
            done = done | hit
            if insert:
                want = ~done & empty
                sidx = (cand_l % m)
                claim = torch.full((m + 1,), cap, dtype=torch.int32,
                                   device=dev)
                claim.scatter_reduce_(
                    0, torch.where(want, sidx, torch.full_like(sidx, m)),
                    torch.where(want, row_idx, torch.full_like(row_idx, cap)),
                    reduce="amin")
                won = want & (claim[sidx] == row_idx)
                self.tags[cand_l[won]] = tag_vals[won]
                slots = torch.where(won, cand, slots)
                inserted = inserted | won
                done = done | won
            else:
                done = done | (~done & empty)
            advance = ~done & ((~empty & ~match) | tomb)
            off = torch.where(advance, off + 1, off)
        overflow = ~done
        found = valid & done & ~inserted & (slots < size)
        return self, slots, found, overflow, inserted

    def _lookup_cuda(self, keys: torch.Tensor, ranks: torch.Tensor | None,
                     valid: torch.Tensor):
        """K12 ``tag_probe``, lookup: one thread per row.  Returns
        ``(slots, found, overflow, n_over)``."""
        cap = valid.shape[0]
        dev = valid.device
        keys = keys.contiguous()
        valid_u8 = _u8(valid)
        tensors = [keys, valid_u8, self.tags]
        if ranks is not None:
            ranks = ranks.to(torch.int32).contiguous()
            tensors.append(ranks)
        kernels.require_cuda("tag_probe", *tensors)
        slots = torch.empty(cap, dtype=torch.int32, device=dev)
        found = torch.empty(cap, dtype=torch.uint8, device=dev)
        overflow = torch.empty(cap, dtype=torch.uint8, device=dev)
        n_over = torch.zeros((), dtype=torch.int64, device=dev)
        a = _LookupArgs()
        a.keys, a.ranks = keys.data_ptr(), kernels.ptr(ranks)
        a.valid, a.tags = valid_u8.data_ptr(), self.tags.data_ptr()
        a.slots, a.found = slots.data_ptr(), found.data_ptr()
        a.overflow, a.n_over = overflow.data_ptr(), n_over.data_ptr()
        a.cap, a.size = cap, self.size
        a.max_iters = min(self.size + 2, 1024)
        fn = kernels.entry("tag_probe", "rw_tag_lookup",
                           [_LookupArgs, ctypes.c_void_p])
        kernels.count_launch("tag_probe")
        kernels.check(fn(a, kernels.stream_ptr(dev)), "tag_probe")
        return slots, found.view(torch.bool), overflow.view(torch.bool), \
            n_over

    def _insert_cuda(self, tag_vals: torch.Tensor, valid: torch.Tensor):
        """K12 ``tag_probe``, insert: one cooperative grid, in place."""
        cap = valid.shape[0]
        size = self.size
        dev = valid.device
        tag_vals = tag_vals.contiguous()
        valid_u8 = _u8(valid)
        kernels.require_cuda("tag_probe", tag_vals, valid_u8, self.tags)
        i32 = dict(dtype=torch.int32, device=dev)
        u8 = dict(dtype=torch.uint8, device=dev)
        slots = torch.empty(cap, **i32)
        inserted = torch.empty(cap, **u8)
        pending = torch.empty(cap, **u8)
        off = torch.empty(cap, **i32)
        cand = torch.empty(cap, **i32)
        want = torch.empty(cap, **u8)
        # scratch entry of a candidate slot c is c % (4 * cap); when
        # 4 * cap >= size that is c itself, so size entries suffice
        claim = torch.empty(min(4 * cap, size), **i32)
        counts = torch.zeros(2, **i32)
        n_over = torch.zeros((), dtype=torch.int64, device=dev)
        a = _InsertArgs()
        a.keys, a.valid = tag_vals.data_ptr(), valid_u8.data_ptr()
        a.tags, a.slots = self.tags.data_ptr(), slots.data_ptr()
        a.inserted, a.pending = inserted.data_ptr(), pending.data_ptr()
        a.off, a.cand, a.want = off.data_ptr(), cand.data_ptr(), \
            want.data_ptr()
        a.claim, a.counts = claim.data_ptr(), counts.data_ptr()
        a.n_over = n_over.data_ptr()
        a.cap, a.size = cap, size
        a.max_iters = min(size + 2, 1024)
        fn = kernels.entry("tag_probe", "rw_tag_insert",
                           [_InsertArgs, ctypes.c_void_p])
        kernels.count_launch("tag_probe")
        kernels.check(fn(a, kernels.stream_ptr(dev)), "tag_probe")
        inserted = inserted.view(torch.bool)
        overflow = pending.view(torch.bool)
        found = valid & ~overflow & ~inserted & (slots < size)
        return self, slots, found, overflow, inserted

    def lookup_pair_counted(self, hashes: torch.Tensor, rank: torch.Tensor,
                            valid: torch.Tensor):
        """Find ``(hash, rank)`` entries: ``(slots, found, bound_count)``,
        the probe-bound overflow folded into an int64 device count."""
        if valid.device.type == "cuda":
            slots, found, _, n_over = self._lookup_cuda(hashes, rank, valid)
            return slots, found, n_over
        _, slots, found, overflow, _ = self._probe_tags(
            hashes, valid, insert=False, ranks=rank)
        return slots, found, (overflow & valid).sum(dtype=torch.int64)

    # -- the fused two-phase ranked insert ------------------------------
    def lookup_or_insert_ranked(self, hashes: torch.Tensor,
                                chunk_rank: torch.Tensor,
                                degree: torch.Tensor, valid: torch.Tensor):
        """Find-or-claim ``(hash, degree[head] + chunk_rank)`` per row, in
        place: each valid row resolves its key's head ``(hash, 0)``,
        reads the pre-chunk degree there (read only), switches its target
        to ``(hash, degree + chunk_rank)`` and finds or claims it, all in
        one loop of at most ``min(2 * size + 4, 1024)`` rounds.

        Returns ``(self, slots, target, head_slot, inserted, existed,
        overflow, iters)`` as the reference does (``iters`` an int32
        device scalar)."""
        if valid.device.type == "cuda":
            return self._ranked_cuda(hashes, chunk_rank, degree, valid)
        return self._ranked_plain(hashes, chunk_rank, degree, valid)

    def _ranked_plain(self, hashes, chunk_rank, degree, valid):
        """Plain PyTorch version of kernel K12's ``tag_insert_ranked``."""
        size = self.size
        cap = valid.shape[0]
        dev = valid.device
        row_idx = torch.arange(cap, dtype=torch.int32, device=dev)
        sentinel = size
        base = hash64_partial([hashes])

        def tag_of(r):
            return finish_tag(hash64_extend(base, r))

        chunk_rank = chunk_rank.to(torch.int32)
        slots = torch.full((cap,), sentinel, dtype=torch.int32, device=dev)
        done = ~valid
        inserted = torch.zeros(cap, dtype=torch.bool, device=dev)
        existed = torch.zeros(cap, dtype=torch.bool, device=dev)
        phase2 = torch.zeros(cap, dtype=torch.bool, device=dev)
        target = torch.zeros(cap, dtype=torch.int32, device=dev)
        target_tag = tag_of(target)
        head_slot = torch.full((cap,), sentinel, dtype=torch.int32,
                               device=dev)
        off = torch.zeros(cap, dtype=torch.int32, device=dev)
        m = 4 * cap
        max_iters = min(2 * size + 4, 1024)
        iters = 0
        while True:
            cand = ((target_tag & (size - 1)).to(torch.int32) + off) \
                & (size - 1)
            cand_l = cand.to(torch.int64)
            t = self.tags[cand_l]
            tomb = t == TOMB_TAG
            empty = t == EMPTY_TAG
            match = t == target_tag

            # phase 1: resolve the head (hash, 0)
            p1 = ~done & ~phase2
            head_hit = p1 & match
            d = degree[torch.where(head_hit, cand_l,
                                   torch.zeros_like(cand_l))]
            new_rank = (d + chunk_rank).to(torch.int32)
            head_slot = torch.where(head_hit, cand, head_slot)
            done_h = head_hit & (new_rank == 0)
            slots = torch.where(done_h, cand, slots)
            existed = existed | done_h
            done = done | done_h
            sw_hit = head_hit & (new_rank > 0)
            sw_empty = p1 & empty & (chunk_rank > 0)
            switched = sw_hit | sw_empty
            phase2 = phase2 | switched
            new_target = torch.where(sw_hit, new_rank, chunk_rank)
            target = torch.where(switched, new_target, target)
            target_tag = torch.where(switched, tag_of(new_target),
                                     target_tag)
            off = torch.where(switched, torch.zeros_like(off), off)

            # phase 2: find-or-claim (hash, target)
            hit2 = ~done & phase2 & ~switched & match
            slots = torch.where(hit2, cand, slots)
            existed = existed | hit2
            done = done | hit2

            want = ~done & ~switched & empty & (phase2 | (chunk_rank == 0))
            sidx = cand_l % m
            claim = torch.full((m + 1,), cap, dtype=torch.int32, device=dev)
            claim.scatter_reduce_(
                0, torch.where(want, sidx, torch.full_like(sidx, m)),
                torch.where(want, row_idx, torch.full_like(row_idx, cap)),
                reduce="amin")
            won = want & (claim[sidx] == row_idx)
            self.tags[cand_l[won]] = target_tag[won]
            slots = torch.where(won, cand, slots)
            head_slot = torch.where(won & (target == 0), cand, head_slot)
            inserted = inserted | won
            done = done | won
            advance = ~done & ~switched & ((~empty & ~match) | tomb)
            off = torch.where(advance, off + 1, off)
            iters += 1
            if iters >= max_iters or bool(done.all()):
                break
        overflow = ~done
        return (self, slots, target, head_slot, inserted, existed & valid,
                overflow, torch.tensor(iters, dtype=torch.int32, device=dev))

    def _ranked_cuda(self, hashes, chunk_rank, degree, valid,
                     grid_only: bool = False):
        """K12 ``tag_insert_ranked``: the walk, then the rounds over the
        rows that reach a true-empty slot; no host sync.  ``grid_only``
        keeps every listed round on the cooperative grid (for checks of
        that branch on short lists)."""
        cap = valid.shape[0]
        size = self.size
        dev = valid.device
        hashes = hashes.contiguous()
        chunk_rank = chunk_rank.to(torch.int32).contiguous()
        degree = degree.contiguous()
        if degree.dtype != torch.int32 or hashes.dtype != torch.int64:
            raise ValueError("tag_insert_ranked: int64 hashes and int32 "
                             "degree expected")
        valid_u8 = _u8(valid)
        kernels.require_cuda("tag_insert_ranked", hashes, chunk_rank, degree,
                             valid_u8, self.tags)
        i32 = dict(dtype=torch.int32, device=dev)
        u8 = dict(dtype=torch.uint8, device=dev)
        slots, target, head_slot = (torch.empty(cap, **i32)
                                    for _ in range(3))
        inserted, existed, pending = (torch.empty(cap, **u8)
                                      for _ in range(3))
        iters = torch.empty((), **i32)
        lists = torch.empty((2 * cap, 4), **i32)
        cand = torch.empty(cap, **i32)
        scratch = _claim_scratch(dev, cap)
        a = _RankedArgs()
        a.hashes, a.chunk_rank = hashes.data_ptr(), chunk_rank.data_ptr()
        a.degree, a.valid = degree.data_ptr(), valid_u8.data_ptr()
        a.tags, a.slots = self.tags.data_ptr(), slots.data_ptr()
        a.target, a.head_slot = target.data_ptr(), head_slot.data_ptr()
        a.inserted, a.existed = inserted.data_ptr(), existed.data_ptr()
        a.pending, a.iters = pending.data_ptr(), iters.data_ptr()
        a.list, a.cand = lists.data_ptr(), cand.data_ptr()
        a.claim = scratch.data_ptr()
        a.ctl = scratch[-len(_CTL_REST):].data_ptr()
        a.cap, a.size = cap, size
        a.max_iters = min(2 * size + 4, 1024)
        a.grid_only = int(grid_only)
        fn = kernels.entry("tag_insert_ranked", "rw_tag_insert_ranked",
                           [_RankedArgs, ctypes.c_void_p])
        kernels.count_launch("tag_insert_ranked")
        kernels.check(fn(a, kernels.stream_ptr(dev)), "tag_insert_ranked")
        return (self, slots, target, head_slot, inserted.view(torch.bool),
                existed.view(torch.bool), pending.view(torch.bool), iters)

    # -- maintenance ----------------------------------------------------
    def clear_where(self, pred: torch.Tensor) -> "TagTable":
        """In place: occupied slots where ``pred [size]`` holds become
        tombstones (probe chains stay intact); CUDA tensors launch the K4
        sweep."""
        if pred.device.type != "cuda":
            return self.clear_where_plain(pred)
        table_sweep(self.size, tags=self.tags, pred=pred)
        return self

    def clear_where_plain(self, pred: torch.Tensor) -> "TagTable":
        """Plain PyTorch version of ``clear_where``."""
        dead = pred & self.occupied
        self.tags.masked_fill_(dead, TOMB_TAG)
        return self

    def clear_slots(self, slots: torch.Tensor,
                    mask: torch.Tensor) -> "TagTable":
        """In place: tombstone ``slots[mask]`` (sentinel slots dropped);
        CUDA tensors launch the K4 sweep."""
        if mask.device.type != "cuda":
            return self.clear_slots_plain(slots, mask)
        table_sweep(self.size, tags=self.tags, slots=slots, mask=mask)
        return self

    def clear_slots_plain(self, slots: torch.Tensor,
                          mask: torch.Tensor) -> "TagTable":
        """Plain PyTorch version of ``clear_slots``."""
        pos = torch.where(mask, slots, torch.full_like(slots, self.size))
        ext = torch.cat([self.tags, self.tags.new_zeros(1)])
        ext[pos.to(torch.int64)] = TOMB_TAG
        self.tags.copy_(ext[: self.size])
        return self

    def rehashed(self) -> tuple["TagTable", torch.Tensor]:
        """(fresh table without tombstones, moved int32 [size]): ``moved``
        maps old slot -> new slot, ``size`` for dead slots."""
        fresh = TagTable.create(self.size, self.device)
        fresh, new_slots, _, _, _ = fresh._probe_tags(
            self.tags, self.occupied, insert=True)
        return fresh, new_slots
