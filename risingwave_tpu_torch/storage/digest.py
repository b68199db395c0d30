"""Block digests of state leaves (plain PyTorch).

Port of ``risingwave_tpu/storage/digest.py``: ``DEFAULT_BLOCK_ELEMS``,
``normalize_u64`` (:36), ``leaf_block_count`` (:63), ``_pack_words``
(:68), ``leaf_digest`` (:96), ``digest_leaves`` (:115) and the lane
variants ``lane_block_count`` (:122) and ``leaf_digest_lanes`` (:130).

A leaf is cut into blocks of ``block`` ELEMENTS.  Narrow dtypes pack
``64 / bits`` elements into one 64-bit word (element ``j`` of a word at
bit ``j * bits``), over the leaf's element stream zero-padded to
``nb * block``; 8-byte dtypes are one word per element (float64
through ``frexp``, with sentinels for nan and ±inf; -0.0 digests as
+0.0).  Word ``i`` of the padded stream mixes as
``_mix64(word ^ i * GOLD ^ GOLD)`` and a block's digest is the wrapping
sum of its words' mixes.

A leaf with a leading shard axis (a lane-stacked state, ``[rows, ...]``)
digests in ``rows`` LANES: the block grid restarts at every row, each row
is zero-padded to ``ceil(m / block)`` blocks (``m`` its elements) and the
word index ``i`` is row-local, so no block spans two rows.

Every value here is an int64 bit pattern (the reference computes in
uint64): shifts are logical through ``srl`` and products wrap, as in
the port's ``mix64``.  These are the plain versions: the CPU tests
compare them with the reference bit for bit.

On the card, K11 (``csrc/shadow_digest.cu``) computes the same digests
for a whole leaf list in one launch, fused with the shadow snapshot's
diff and dirty copy (``shadow_digest``), and packs a delta's dirty
blocks for the checkpoint store (``dirty_gather``).  A launch whose
leaves include a lane leaf goes through the lane entry points
(``shadow_digest_lanes``, ``dirty_gather_lanes``: the same kernels with
the row grid, counted apart).  The wrappers take their plain versions
(``shadow_digest_plain``, ``dirty_gather_plain``) only for CPU tensors;
on CUDA tensors they launch or raise.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from risingwave_tpu_torch import kernels
from risingwave_tpu_torch.common.hash import K1 as _GOLD, mix64

#: default block size in ELEMENTS (not bytes)
DEFAULT_BLOCK_ELEMS = 1 << 9

_NAN_WORD = -(2 ** 62)
_POSINF_WORD = 2 ** 62
_NEGINF_WORD = -(2 ** 62) + 1
_F64_TINY = 2.2250738585072014e-308


def _unsigned_bits(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(int64 tensor holding the zero-extended bit pattern, bits) of a
    narrow-dtype leaf."""
    if x.dtype == torch.bool:
        return x.to(torch.int64), 8
    if x.dtype == torch.float32:
        return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF, 32
    bits = 8 * x.element_size()
    v = x.view({1: torch.uint8, 2: torch.int16, 4: torch.int32}[
        x.element_size()]).to(torch.int64)
    return v & ((1 << bits) - 1), bits


def normalize_u64(x: torch.Tensor) -> torch.Tensor:
    """Change-faithful view of any leaf as flat int64 words (1:1
    elements)."""
    x = x.reshape(-1)
    if x.dtype == torch.float64:
        m, e = torch.frexp(x)
        # the reference's frexp scales subnormals with denormals
        # flushed, so every subnormal comes out as (±0.5, -1074)
        sub = (x != 0) & (x.abs() < _F64_TINY)
        m = torch.where(sub, torch.copysign(torch.full_like(x, 0.5), x), m)
        e = torch.where(sub, torch.full_like(e, -1074), e)
        m2 = (m * (2.0 ** 53)).to(torch.int64)
        m2 = torch.where(torch.isnan(x), torch.full_like(m2, _NAN_WORD), m2)
        m2 = torch.where(torch.isposinf(x),
                         torch.full_like(m2, _POSINF_WORD), m2)
        m2 = torch.where(torch.isneginf(x),
                         torch.full_like(m2, _NEGINF_WORD), m2)
        e = torch.where(torch.isfinite(x), e.to(torch.int64),
                        torch.zeros_like(m2))
        return m2 ^ (e << 53)
    if x.element_size() == 8:
        return x.view(torch.int64)
    return _unsigned_bits(x)[0]


def leaf_block_count(shape, block: int) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return max(1, -(-n // block))


def _pack_words(x: torch.Tensor, nb: int, block: int, rows: int = 1):
    """Narrow dtypes packed 8 bytes per word, ``[rows, nb * block / k]``
    (each of the ``rows`` rows zero-padded to ``nb`` blocks); None for
    dtypes that already fill a word."""
    if x.dtype != torch.bool and x.dtype != torch.float32 \
            and x.element_size() == 8:
        return None
    u, bits = _unsigned_bits(x.reshape(-1))
    k = 64 // bits
    u = u.reshape(rows, u.shape[0] // rows)
    pad = nb * block - u.shape[1]
    if pad:
        u = torch.cat([u, u.new_zeros(rows, pad)], dim=1)
    lanes = u.reshape(rows, -1, k)
    words = lanes[..., 0].clone()
    for j in range(1, k):
        words |= lanes[..., j] << (j * bits)
    return words


def _digest_rows(x: torch.Tensor, rows: int, nb: int,
                 block: int) -> torch.Tensor:
    """``nb`` block digests of each of the ``rows`` rows of ``x``, row by
    row (the word index restarts at every row)."""
    words = _pack_words(x, nb, block, rows)
    if words is None:
        words = normalize_u64(x)
        words = words.reshape(rows, words.shape[0] // rows)
        pad = nb * block - words.shape[1]
        if pad:
            words = torch.cat([words, words.new_zeros(rows, pad)], dim=1)
    wpb = words.shape[1] // nb
    idx = torch.arange(words.shape[1], dtype=torch.int64,
                       device=words.device)
    h = mix64(words ^ (idx * _GOLD) ^ _GOLD)
    return h.reshape(rows * nb, wpb).sum(dim=1, dtype=torch.int64)


def leaf_digest(x: torch.Tensor, nb: int, block: int) -> torch.Tensor:
    """Per-block digests of one leaf, int64 bit patterns ``[nb]``."""
    return _digest_rows(x, 1, nb, block)


def digest_leaves(leaves, nblocks, block: int) -> torch.Tensor:
    """Concatenated per-block digests of a leaf list."""
    return torch.cat([leaf_digest(x, nb, block)
                      for x, nb in zip(leaves, nblocks)])


def lane_block_count(shape, rows: int, block: int) -> int:
    """Blocks of a leaf digested as ``rows`` lanes: ``rows *
    ceil(row_elems / block)``, at least one a row."""
    n = 1
    for d in shape:
        n *= int(d)
    return rows * max(1, -(-(n // rows) // block))


def leaf_digest_lanes(x: torch.Tensor, rows: int,
                      block: int) -> torch.Tensor:
    """Per-block digests of one leaf in ``rows`` lanes, int64 bit
    patterns ``[lane_block_count]``, lane after lane."""
    return _digest_rows(x, rows, lane_block_count(x.shape, rows, block)
                        // rows, block)


def block_counts(shapes, lanes, block: int) -> list[int]:
    """Each leaf's block count: ``lanes[i]`` is leaf ``i``'s ``(rows,
    row_elems)`` or None (flat)."""
    return [lane_block_count(s, ln[0], block) if ln
            else leaf_block_count(s, block)
            for s, ln in zip(shapes, lanes)]


# -- K11: the fused digest / diff / dirty copy and the dirty gather --------

#: leaves of one launch (``SD_MAX_LEAVES`` in the kernel source)
SD_MAX_LEAVES = 64
_LADDER, _WHOLE, _F64 = 1, 2, 4
#: leaves at/below this many blocks copy whole (the reference's _SMALL_NB)
SMALL_NB = 8


class _SdLeaf(ctypes.Structure):
    """Mirror of ``struct SdLeaf`` in ``csrc/shadow_digest.cu``."""

    _fields_ = [("live", ctypes.c_void_p), ("shadow", ctypes.c_void_p),
                ("n", ctypes.c_longlong), ("blk0", ctypes.c_longlong),
                ("nb", ctypes.c_int), ("esize", ctypes.c_int),
                ("flags", ctypes.c_int), ("rows", ctypes.c_int)]


class _SdDesc(ctypes.Structure):
    """Mirror of ``struct SdDesc`` (passed to the kernel by value)."""

    _fields_ = [("n_leaves", ctypes.c_int), ("block", ctypes.c_int),
                ("total", ctypes.c_longlong),
                ("leaf", _SdLeaf * SD_MAX_LEAVES)]


def copies_whole(n: int, nb: int, block: int, rows: int = 1) -> bool:
    """A small leaf (``_copy_leaf``'s early return, and
    ``_copy_leaf_rows``' for a leaf of ``rows`` lanes): copied whole and
    never counted dirty."""
    return nb <= SMALL_NB or rows * ((n // rows) // block) < 2


def _rows_of(rows, n_leaves: int) -> list[int]:
    return [1] * n_leaves if rows is None else list(rows)


def _desc(src, dst, nblocks, block: int, rows) -> _SdDesc:
    if len(src) > SD_MAX_LEAVES:
        raise ValueError(f"K11 takes at most {SD_MAX_LEAVES} leaves per "
                         f"launch, got {len(src)}")
    d = _SdDesc()
    d.n_leaves = len(src)
    d.block = block
    off = 0
    for i, (x, nb, r) in enumerate(zip(src, nblocks, rows)):
        if x.data_ptr() % 8 and x.numel():
            raise ValueError("K11: leaves must be 8-byte aligned")
        n = x.numel()
        L = d.leaf[i]
        L.live = x.data_ptr()
        L.shadow = dst[i].data_ptr() if dst is not None else None
        L.n, L.blk0, L.nb, L.esize = n, off, nb, x.element_size()
        L.rows = r
        L.flags = (_WHOLE if copies_whole(n, nb, block, r) else _LADDER) \
            | (_F64 if x.dtype == torch.float64 else 0)
        off += nb
    d.total = off
    return d


def shadow_digest(live, shadow, digests: torch.Tensor,
                  dirty_count: torch.Tensor, nblocks, block: int,
                  update: bool, events=None, rows=None) -> None:
    """K11 update (``update=True``): digest every live leaf by blocks,
    diff with ``digests``, copy the dirty blocks into ``shadow`` (small
    leaves whole, ragged tails always), store the new digests and add
    the ladder leaves' dirty blocks to ``dirty_count``.  Init
    (``update=False``): digest and copy everything; ``shadow=None``
    digests only.  ``live`` / ``shadow`` are flat contiguous leaves,
    ``digests`` int64 ``[sum(nblocks)]``, ``dirty_count`` an int64
    scalar; ``rows[i]`` (default 1) is leaf ``i``'s lane count, and a
    launch with a lane leaf is K11 lanes (``shadow_digest_lanes``: the
    blocks of each row, a ragged tail a row).  ``events`` (two CUDA
    events) are recorded around the launches, after the host has built
    their descriptors."""
    rows = _rows_of(rows, len(live))
    if digests.device.type != "cuda":
        return shadow_digest_plain(live, shadow, digests, dirty_count,
                                   nblocks, block, update, rows)
    lanes = any(r > 1 for r in rows)
    name = "shadow_digest_lanes" if lanes else "shadow_digest"
    tensors = list(live) + list(shadow or ()) + [digests, dirty_count]
    kernels.require_cuda(name, *tensors)
    fn = kernels.entry(name, "rw_shadow_digest_lanes" if lanes
                       else "rw_shadow_digest", [
                           ctypes.POINTER(_SdDesc), ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    dev = digests.device
    descs = [(sum(nblocks[:lo]), _desc(
        live[lo:lo + SD_MAX_LEAVES],
        None if shadow is None else shadow[lo:lo + SD_MAX_LEAVES],
        nblocks[lo:lo + SD_MAX_LEAVES], block, rows[lo:lo + SD_MAX_LEAVES]))
        for lo in range(0, len(live), SD_MAX_LEAVES)]
    if events is not None:
        events[0].record()
    for off, d in descs:
        kernels.count_launch(name)
        kernels.check(fn(ctypes.byref(d), digests[off:].data_ptr(),
                         dirty_count.data_ptr(), int(update),
                         kernels.stream_ptr(dev)), name)
    if events is not None:
        events[1].record()


def shadow_digest_plain(live, shadow, digests, dirty_count, nblocks,
                        block: int, update: bool, rows=None) -> None:
    """Plain version of ``shadow_digest`` (same results, leaf by leaf)."""
    rows = _rows_of(rows, len(live))
    off = 0
    for i, (x, nb, r) in enumerate(zip(live, nblocks, rows)):
        d = _digest_rows(x, r, nb // r, block)
        n = x.numel()
        whole = copies_whole(n, nb, block, r)
        if update:
            dirty = d != digests[off:off + nb]
            if not whole:
                dirty_count += dirty.sum(dtype=torch.int64)
        else:
            dirty = torch.ones(nb, dtype=torch.bool, device=x.device)
        digests[off:off + nb] = d
        off += nb
        if shadow is None:
            continue
        sh = shadow[i]
        if whole or not update:
            sh.copy_(x)
            continue
        # each row's dirty full blocks, then each row's ragged tail
        m = n // r
        nbf = m // block
        full = dirty.view(r, nb // r)[:, :nbf]
        sh2, x2 = sh.view(r, m), x.view(r, m)
        sh2[:, :nbf * block].view(r, nbf, block)[full] = \
            x2[:, :nbf * block].view(r, nbf, block)[full]
        sh2[:, nbf * block:] = x2[:, nbf * block:]


def gather_plan(dirty: np.ndarray, nblocks, sizes, esizes, block: int,
                rows=None):
    """The dirty blocks of a delta as ``(entries int64 [m, 2], runs,
    staging bytes)``: ``entries[j] = (leaf << 32 | block, byte offset in
    the staging buffer)`` with every block 16-byte aligned there, and
    ``runs`` the reference's coalesced runs ``(leaf, start element, end
    element, staging byte offset)`` in leaf and block order.  A leaf of
    ``rows[i]`` lanes has its blocks row by row, and no run crosses a
    row."""
    blk0 = np.concatenate([[0], np.cumsum(nblocks)[:-1]]).astype(np.int64)
    g = np.flatnonzero(dirty).astype(np.int64)
    leaf = np.searchsorted(blk0, g, side="right") - 1
    b = g - blk0[leaf]
    sizes = np.asarray(sizes, np.int64)
    esizes = np.asarray(esizes, np.int64)
    nrows = np.asarray(_rows_of(rows, len(sizes)), np.int64)
    m = (sizes // nrows)[leaf]
    nb_row = (np.asarray(nblocks, np.int64) // nrows)[leaf]
    row, c = b // nb_row, b % nb_row
    start = row * m + c * block
    elems = np.clip(m - c * block, 0, block)
    nbytes = elems * esizes[leaf]
    padded = (nbytes + 15) // 16 * 16
    # (a delta with no dirty block has no entries: a barrier that
    # changed no state)
    dst = np.concatenate([[0], np.cumsum(padded)])[:len(g)].astype(np.int64)
    entries = np.stack([(leaf << 32) | b, dst], axis=1).astype(np.int64)
    runs = []
    if len(g):
        brk = np.flatnonzero((np.diff(g) != 1) | (np.diff(leaf) != 0)
                             | (np.diff(row) != 0)) + 1
        for s, e in zip(np.concatenate([[0], brk]),
                        np.concatenate([brk, [len(g)]])):
            li = int(leaf[s])
            runs.append((li, int(start[s]), int(start[e - 1] + elems[e - 1]),
                         int(dst[s])))
    total = int(dst[-1] + padded[-1]) if len(g) else 0
    return entries, runs, total


def dirty_gather(src, entries: torch.Tensor, staging: torch.Tensor,
                 nblocks, block: int, rows=None) -> None:
    """K11 gather: copy the listed blocks of the flat leaves ``src``
    into ``staging`` (uint8) at the offsets ``entries`` names (see
    ``gather_plan``); with a lane leaf (``rows``) it is K11 lanes'
    gather (``dirty_gather_lanes``)."""
    rows = _rows_of(rows, len(src))
    if staging.device.type != "cuda":
        return dirty_gather_plain(src, entries, staging, block, rows)
    lanes = any(r > 1 for r in rows)
    name = "dirty_gather_lanes" if lanes else "dirty_gather"
    kernels.require_cuda(name, *src, entries, staging)
    fn = kernels.entry(name, "rw_dirty_gather_lanes" if lanes
                       else "rw_dirty_gather", [
                           ctypes.POINTER(_SdDesc), ctypes.c_void_p,
                           ctypes.c_longlong, ctypes.c_void_p,
                           ctypes.c_void_p])
    if len(src) > SD_MAX_LEAVES:
        raise ValueError(f"K11 gather takes at most {SD_MAX_LEAVES} leaves")
    d = _desc(src, None, nblocks, block, rows)
    kernels.count_launch(name)
    kernels.check(fn(ctypes.byref(d), entries.data_ptr(),
                     entries.shape[0], staging.data_ptr(),
                     kernels.stream_ptr(staging.device)), name)


def dirty_gather_plain(src, entries: torch.Tensor, staging: torch.Tensor,
                       block: int, rows=None) -> None:
    """Plain version of ``dirty_gather`` (vectorized per leaf and row)."""
    rows = _rows_of(rows, len(src))
    keys, dst = entries[:, 0], entries[:, 1]
    for li in torch.unique(keys >> 32).tolist():
        sel = (keys >> 32) == li
        b, d = keys[sel] & 0xFFFFFFFF, dst[sel]
        leaf = src[li].reshape(-1)
        r = rows[li]
        m = leaf.numel() // r
        raw = leaf.view(torch.uint8).view(r, m * leaf.element_size())
        bb = block * leaf.element_size()
        nbf = m // block
        nb_row = max(1, -(-m // block))
        row, c = b // nb_row, b % nb_row
        full = c < nbf
        if full.any():
            blocks = raw[:, :nbf * bb].reshape(r, nbf, bb)[row[full],
                                                            c[full]]
            idx = d[full][:, None] + torch.arange(bb, device=raw.device)
            staging[idx.reshape(-1)] = blocks.reshape(-1)
        for rr, o in zip(row[~full].tolist(), d[~full].tolist()):
            tail = raw[rr, nbf * bb:]  # a row's ragged tail block
            staging[o:o + tail.numel()] = tail
