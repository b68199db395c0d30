"""Block digests of state leaves (plain PyTorch).

Port of ``risingwave_tpu/storage/digest.py``: ``DEFAULT_BLOCK_ELEMS``,
``normalize_u64`` (:36), ``leaf_block_count`` (:63), ``_pack_words``
(:68), ``leaf_digest`` (:96) and ``digest_leaves`` (:115).  The lane
variants (:122, :130) wait for the multi-GPU port.

A leaf is cut into blocks of ``block`` ELEMENTS.  Narrow dtypes pack
``64 / bits`` elements into one 64-bit word (element ``j`` of a word at
bit ``j * bits``), over the leaf's element stream zero-padded to
``nb * block``; 8-byte dtypes are one word per element (float64
through ``frexp``, with sentinels for nan and ±inf; -0.0 digests as
+0.0).  Word ``i`` of the padded stream mixes as
``_mix64(word ^ i * GOLD ^ GOLD)`` and a block's digest is the wrapping
sum of its words' mixes.

Every value here is an int64 bit pattern (the reference computes in
uint64): shifts are logical through ``srl`` and products wrap, as in
the port's ``mix64``.  These are the plain versions: the CPU tests
compare them with the reference bit for bit.

On the card, K11 (``csrc/shadow_digest.cu``) computes the same digests
for a whole leaf list in one launch, fused with the shadow snapshot's
diff and dirty copy (``shadow_digest``), and packs a delta's dirty
blocks for the checkpoint store (``dirty_gather``).  Both wrappers take
their plain versions (``shadow_digest_plain``, ``dirty_gather_plain``)
only for CPU tensors; on CUDA tensors they launch or raise.
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


def _pack_words(x: torch.Tensor, nb: int, block: int):
    """Narrow dtypes packed 8 bytes per word, ``[nb * block / k]``;
    None for dtypes that already fill a word."""
    if x.dtype != torch.bool and x.dtype != torch.float32 \
            and x.element_size() == 8:
        return None
    u, bits = _unsigned_bits(x.reshape(-1))
    k = 64 // bits
    pad = nb * block - u.shape[0]
    if pad:
        u = torch.cat([u, u.new_zeros(pad)])
    lanes = u.reshape(-1, k)
    words = lanes[:, 0].clone()
    for j in range(1, k):
        words |= lanes[:, j] << (j * bits)
    return words


def leaf_digest(x: torch.Tensor, nb: int, block: int) -> torch.Tensor:
    """Per-block digests of one leaf, int64 bit patterns ``[nb]``."""
    words = _pack_words(x, nb, block)
    if words is None:
        words = normalize_u64(x)
        pad = nb * block - words.shape[0]
        if pad:
            words = torch.cat([words, words.new_zeros(pad)])
    wpb = words.shape[0] // nb
    idx = torch.arange(words.shape[0], dtype=torch.int64,
                       device=words.device)
    h = mix64(words ^ (idx * _GOLD) ^ _GOLD)
    return h.reshape(nb, wpb).sum(dim=1, dtype=torch.int64)


def digest_leaves(leaves, nblocks, block: int) -> torch.Tensor:
    """Concatenated per-block digests of a leaf list."""
    return torch.cat([leaf_digest(x, nb, block)
                      for x, nb in zip(leaves, nblocks)])


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
                ("flags", ctypes.c_int)]


class _SdDesc(ctypes.Structure):
    """Mirror of ``struct SdDesc`` (passed to the kernel by value)."""

    _fields_ = [("n_leaves", ctypes.c_int), ("block", ctypes.c_int),
                ("total", ctypes.c_longlong),
                ("leaf", _SdLeaf * SD_MAX_LEAVES)]


def copies_whole(n: int, nb: int, block: int) -> bool:
    """A small leaf (``_copy_leaf``'s early return): copied whole and
    never counted dirty."""
    return nb <= SMALL_NB or n // block < 2


def _desc(src, dst, nblocks, block: int) -> _SdDesc:
    if len(src) > SD_MAX_LEAVES:
        raise ValueError(f"K11 takes at most {SD_MAX_LEAVES} leaves per "
                         f"launch, got {len(src)}")
    d = _SdDesc()
    d.n_leaves = len(src)
    d.block = block
    off = 0
    for i, (x, nb) in enumerate(zip(src, nblocks)):
        if x.data_ptr() % 8 and x.numel():
            raise ValueError("K11: leaves must be 8-byte aligned")
        n = x.numel()
        L = d.leaf[i]
        L.live = x.data_ptr()
        L.shadow = dst[i].data_ptr() if dst is not None else None
        L.n, L.blk0, L.nb, L.esize = n, off, nb, x.element_size()
        L.flags = (_WHOLE if copies_whole(n, nb, block) else _LADDER) \
            | (_F64 if x.dtype == torch.float64 else 0)
        off += nb
    d.total = off
    return d


def shadow_digest(live, shadow, digests: torch.Tensor,
                  dirty_count: torch.Tensor, nblocks, block: int,
                  update: bool, events=None) -> None:
    """K11 update (``update=True``): digest every live leaf by blocks,
    diff with ``digests``, copy the dirty blocks into ``shadow`` (small
    leaves whole, ragged tails always), store the new digests and add
    the ladder leaves' dirty blocks to ``dirty_count``.  Init
    (``update=False``): digest and copy everything; ``shadow=None``
    digests only.  ``live`` / ``shadow`` are flat contiguous leaves,
    ``digests`` int64 ``[sum(nblocks)]``, ``dirty_count`` an int64
    scalar.  ``events`` (two CUDA events) are recorded around the
    launches, after the host has built their descriptors."""
    if digests.device.type != "cuda":
        return shadow_digest_plain(live, shadow, digests, dirty_count,
                                   nblocks, block, update)
    tensors = list(live) + list(shadow or ()) + [digests, dirty_count]
    kernels.require_cuda("shadow_digest", *tensors)
    fn = kernels.entry("shadow_digest", "rw_shadow_digest", [
        ctypes.POINTER(_SdDesc), ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p])
    dev = digests.device
    descs = [(sum(nblocks[:lo]), _desc(
        live[lo:lo + SD_MAX_LEAVES],
        None if shadow is None else shadow[lo:lo + SD_MAX_LEAVES],
        nblocks[lo:lo + SD_MAX_LEAVES], block))
        for lo in range(0, len(live), SD_MAX_LEAVES)]
    if events is not None:
        events[0].record()
    for off, d in descs:
        kernels.count_launch("shadow_digest")
        kernels.check(fn(ctypes.byref(d), digests[off:].data_ptr(),
                         dirty_count.data_ptr(), int(update),
                         kernels.stream_ptr(dev)), "shadow_digest")
    if events is not None:
        events[1].record()


def shadow_digest_plain(live, shadow, digests, dirty_count, nblocks,
                        block: int, update: bool) -> None:
    """Plain version of ``shadow_digest`` (same results, leaf by leaf)."""
    off = 0
    for i, (x, nb) in enumerate(zip(live, nblocks)):
        d = leaf_digest(x, nb, block)
        n = x.numel()
        whole = copies_whole(n, nb, block)
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
        nbf = n // block
        full = dirty[:nbf]
        sh[:nbf * block].view(nbf, block)[full] = \
            x[:nbf * block].view(nbf, block)[full]
        sh[nbf * block:] = x[nbf * block:]


def gather_plan(dirty: np.ndarray, nblocks, sizes, esizes, block: int):
    """The dirty blocks of a delta as ``(entries int64 [m, 2], runs,
    staging bytes)``: ``entries[j] = (leaf << 32 | block, byte offset in
    the staging buffer)`` with every block 16-byte aligned there, and
    ``runs`` the reference's coalesced runs ``(leaf, start element, end
    element, staging byte offset)`` in leaf and block order."""
    blk0 = np.concatenate([[0], np.cumsum(nblocks)[:-1]]).astype(np.int64)
    g = np.flatnonzero(dirty).astype(np.int64)
    leaf = np.searchsorted(blk0, g, side="right") - 1
    b = g - blk0[leaf]
    sizes = np.asarray(sizes, np.int64)
    esizes = np.asarray(esizes, np.int64)
    start = b * block
    elems = np.clip(sizes[leaf] - start, 0, block)
    nbytes = elems * esizes[leaf]
    padded = (nbytes + 15) // 16 * 16
    # (a delta with no dirty block has no entries: a barrier that
    # changed no state)
    dst = np.concatenate([[0], np.cumsum(padded)])[:len(g)].astype(np.int64)
    entries = np.stack([(leaf << 32) | b, dst], axis=1).astype(np.int64)
    runs = []
    if len(g):
        brk = np.flatnonzero((np.diff(g) != 1) | (np.diff(leaf) != 0)) + 1
        for s, e in zip(np.concatenate([[0], brk]),
                        np.concatenate([brk, [len(g)]])):
            li = int(leaf[s])
            runs.append((li, int(start[s]), int(start[e - 1] + elems[e - 1]),
                         int(dst[s])))
    total = int(dst[-1] + padded[-1]) if len(g) else 0
    return entries, runs, total


def dirty_gather(src, entries: torch.Tensor, staging: torch.Tensor,
                 nblocks, block: int) -> None:
    """K11 gather: copy the listed blocks of the flat leaves ``src``
    into ``staging`` (uint8) at the offsets ``entries`` names (see
    ``gather_plan``)."""
    if staging.device.type != "cuda":
        return dirty_gather_plain(src, entries, staging, block)
    kernels.require_cuda("dirty_gather", *src, entries, staging)
    fn = kernels.entry("dirty_gather", "rw_dirty_gather", [
        ctypes.POINTER(_SdDesc), ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_void_p])
    if len(src) > SD_MAX_LEAVES:
        raise ValueError(f"K11 gather takes at most {SD_MAX_LEAVES} leaves")
    d = _desc(src, None, nblocks, block)
    kernels.count_launch("dirty_gather")
    kernels.check(fn(ctypes.byref(d), entries.data_ptr(),
                     entries.shape[0], staging.data_ptr(),
                     kernels.stream_ptr(staging.device)), "dirty_gather")


def dirty_gather_plain(src, entries: torch.Tensor, staging: torch.Tensor,
                       block: int) -> None:
    """Plain version of ``dirty_gather`` (vectorized per leaf)."""
    keys, dst = entries[:, 0], entries[:, 1]
    for li in torch.unique(keys >> 32).tolist():
        sel = (keys >> 32) == li
        b, d = keys[sel] & 0xFFFFFFFF, dst[sel]
        leaf = src[li].reshape(-1)
        raw = leaf.view(torch.uint8)
        bb = block * leaf.element_size()
        nbf = leaf.numel() // block
        full = b < nbf
        if full.any():
            rows = raw[:nbf * bb].view(nbf, bb)[b[full]]
            idx = d[full][:, None] + torch.arange(bb, device=raw.device)
            staging[idx.reshape(-1)] = rows.reshape(-1)
        if not full.all():  # the ragged tail block
            tail = raw[nbf * bb:]
            o = int(d[~full][0])
            staging[o:o + tail.numel()] = tail
