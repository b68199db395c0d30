"""Hash exchange: vnode partitioning and the all-to-all of a lane mesh.

Port of ``risingwave_tpu/parallel/exchange.py``: ``single_shard_keys``
(:81), ``shard_of_vnode`` (:92), ``_bucketize`` (:104), ``shuffle_chunk``
(:124) and its trace counters (``EXCHANGE_TRACE``).

The reference runs ``shuffle_chunk`` inside a ``shard_map``: each shard
scatters its chunk into ``n_shards`` buckets of ``cap`` rows by the
destination of each row's vnode, and one ``lax.all_to_all`` swaps bucket
``d`` of shard ``s`` to shard ``d``.  The port's mesh is ``n`` lanes on
one device (``stream/sharded.py``), so ``shuffle_chunk`` takes every
lane's chunk at once and returns every lane's received chunk: lane ``d``
gets ``n * cap`` rows, source ``s``'s rows for ``d`` at ``s * cap +
rank`` in their order, every other slot the reference's fill (zero
payload, NULL, op 0, not valid).  On the card this is K2 (the vnodes, one
launch a lane) and K24 (``csrc/exchange.cu``, three launches for all
lanes); ``shuffle_chunk_plain`` is K24's plain version: ``_bucketize`` per
source lane and the transpose of ``[src, dst, cap]``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from risingwave_tpu_torch import kernels
from risingwave_tpu_torch.common.chunk import Chunk, NCol, StrCol
from risingwave_tpu_torch.common.hash import VNODE_COUNT, compute_vnodes

#: shuffles run and the per-lane bytes they delivered (the reference counts
#: them per trace; the port, which runs eagerly, per call)
EXCHANGE_TRACE = {"calls": 0, "bytes": 0}

#: most lanes and leaves K24's descriptor holds (``X_MAX_*`` in the source)
MAX_LANES = 8
MAX_LEAVES = 24


def reset_exchange_trace() -> None:
    EXCHANGE_TRACE["calls"] = 0
    EXCHANGE_TRACE["bytes"] = 0


def single_shard_keys(chunk: Chunk) -> list:
    """A constant routing key: every row goes to the one lane that owns
    vnode(crc(0)) (the reference's singleton fragments)."""
    return [torch.zeros(chunk.capacity, dtype=torch.int64,
                        device=chunk.device)]


def shard_of_vnode(vnodes: torch.Tensor, n_shards: int,
                   vnode_count: int = VNODE_COUNT) -> torch.Tensor:
    """Contiguous-range vnode -> lane mapping, int32."""
    if n_shards > vnode_count:
        raise ValueError(
            f"n_shards={n_shards} exceeds vnode_count={vnode_count}; raise "
            "the job's vnode count")
    per = vnode_count // n_shards
    return torch.clamp(vnodes // per, max=n_shards - 1).to(torch.int32)


def _col_leaves(col) -> list[tuple[torch.Tensor, int]]:
    """A column's planes with the byte an unfilled bucket slot holds."""
    if isinstance(col, NCol):
        return _col_leaves(col.data) + [(col.null, 1)]
    if isinstance(col, StrCol):
        return [(col.data, 0), (col.lens, 0)]
    return [(col, 0)]


def _chunk_leaves(chunk: Chunk) -> list[tuple[torch.Tensor, int]]:
    leaves = []
    for c in chunk.columns:
        leaves += _col_leaves(c)
    return leaves + [(chunk.ops, 0), (chunk.valid, 0)]


def _rebuild_col(proto, it):
    if isinstance(proto, NCol):
        return NCol(_rebuild_col(proto.data, it), next(it))
    if isinstance(proto, StrCol):
        return StrCol(next(it), next(it))
    return next(it)


def _rebuild_chunk(proto: Chunk, leaves) -> Chunk:
    it = iter(leaves)
    cols = tuple(_rebuild_col(c, it) for c in proto.columns)
    ops, valid = next(it), next(it)
    return Chunk(cols, ops, valid, proto.schema)


def _dest_slot(valid: torch.Tensor, vnodes: torch.Tensor, n: int,
               cap: int, vnode_count: int) -> torch.Tensor:
    """Each row's bucket slot ``dest * cap + rank`` (``n * cap``: dropped),
    rank = the row's stable rank among the rows for its lane."""
    dest = shard_of_vnode(vnodes, n, vnode_count).to(torch.int64)
    dest = torch.where(valid, dest, torch.full_like(dest, n))
    onehot = torch.nn.functional.one_hot(dest, n + 1)
    rank = onehot.cumsum(0).gather(1, dest[:, None]).squeeze(1) - 1
    return torch.where(dest < n, dest * cap + rank,
                       torch.full_like(dest, n * cap))


def _bucketize(leaf: torch.Tensor, fill: int, dest_slot: torch.Tensor,
               n: int, cap: int) -> torch.Tensor:
    """Scatter a [cap] plane into the [n * cap] bucket-major layout (rows
    at ``n * cap`` are dropped)."""
    out = torch.full((n * cap + 1,) + tuple(leaf.shape[1:]), fill,
                     dtype=leaf.dtype, device=leaf.device)
    out[dest_slot] = leaf
    return out[:n * cap]


def shuffle_chunk_plain(chunks: Sequence[Chunk], vnodes: Sequence,
                        vnode_count: int = VNODE_COUNT) -> list[Chunk]:
    """Plain PyTorch version of K24: ``_bucketize`` on every source lane,
    then the all-to-all as the transpose of ``[src, dst, cap]``."""
    n = len(chunks)
    cap = chunks[0].capacity
    per_src = []
    for chunk, vn in zip(chunks, vnodes):
        slot = _dest_slot(chunk.valid, vn, n, cap, vnode_count)
        per_src.append([_bucketize(t, fill, slot, n, cap)
                        for t, fill in _chunk_leaves(chunk)])
    recv = []
    for k in range(len(per_src[0])):
        x = torch.stack([src[k] for src in per_src])  # [src, dst*cap, ...]
        rest = tuple(x.shape[2:])
        x = x.reshape((n, n, cap) + rest).transpose(0, 1)
        recv.append(x.reshape((n, n * cap) + rest))
    return [_rebuild_chunk(chunks[0], [r[d] for r in recv])
            for d in range(n)]


class _Exchange(ctypes.Structure):
    """Mirror of ``struct RwExchange`` in ``csrc/exchange.cu``."""

    _fields_ = [
        ("n_lanes", ctypes.c_int),
        ("n_leaves", ctypes.c_int),
        ("per", ctypes.c_int),
        ("cap", ctypes.c_longlong),
        ("vnode", ctypes.c_void_p * MAX_LANES),
        ("valid", ctypes.c_void_p * MAX_LANES),
        ("width", ctypes.c_int * MAX_LEAVES),
        ("fill", ctypes.c_int * MAX_LEAVES),
        ("src", (ctypes.c_void_p * MAX_LEAVES) * MAX_LANES),
        ("dst", ctypes.c_void_p * MAX_LEAVES),
    ]


def shuffle_chunk_cuda(chunks: Sequence[Chunk], vnodes: Sequence,
                       vnode_count: int = VNODE_COUNT) -> list[Chunk]:
    """K24: three launches for every lane; returns each lane's received
    chunk, views of one [n, n * cap] buffer per plane."""
    n = len(chunks)
    cap = chunks[0].capacity
    if n > MAX_LANES:
        raise ValueError(f"K24 takes at most {MAX_LANES} lanes (got {n})")
    leaves = [_chunk_leaves(c) for c in chunks]
    if len(leaves[0]) > MAX_LEAVES:
        raise ValueError(f"K24 takes at most {MAX_LEAVES} planes a chunk")
    dev = chunks[0].device
    x = _Exchange()
    x.n_lanes, x.n_leaves, x.cap = n, len(leaves[0]), cap
    x.per = vnode_count // n
    keep = []
    for s, (chunk, vn) in enumerate(zip(chunks, vnodes)):
        if chunk.capacity != cap:
            raise ValueError("K24: every lane's chunk needs one capacity")
        vn = vn.contiguous()
        valid = chunk.valid.contiguous().view(torch.uint8)
        keep += [vn, valid]
        x.vnode[s], x.valid[s] = vn.data_ptr(), valid.data_ptr()
        for k, (t, _) in enumerate(leaves[s]):
            t = t.contiguous()
            keep.append(t)
            x.src[s][k] = t.data_ptr()
    recv = []
    for k, (t, fill) in enumerate(leaves[0]):
        out = torch.empty((n, n * cap) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=dev)
        recv.append(out)
        x.width[k] = t.element_size() * (t[0].numel() if t.dim() > 1 else 1)
        x.fill[k] = fill
        x.dst[k] = out.data_ptr()
    nblk = (cap + 255) // 256
    scratch = torch.empty(2 * n * nblk * n + n * n, dtype=torch.int32,
                          device=dev)
    kernels.require_cuda("exchange", scratch, *keep, *recv)
    fn = kernels.entry("exchange", "rw_exchange",
                       [_Exchange, ctypes.c_void_p, ctypes.c_void_p])
    kernels.count_launch("exchange")
    kernels.check(fn(x, scratch.data_ptr(), kernels.stream_ptr(dev)),
                  "exchange")
    return [_rebuild_chunk(chunks[0], [r[d] for r in recv])
            for d in range(n)]


def shuffle_chunk(chunks: Sequence[Chunk], key_cols: Sequence,
                  vnode_count: int = VNODE_COUNT) -> list[Chunk]:
    """Exchange every lane's chunk to the lanes that own its rows' vnodes.

    ``chunks[s]`` is lane ``s``'s chunk and ``key_cols[s]`` its key
    columns; returns lane ``d``'s received chunk of capacity ``n * cap``
    for every ``d`` (worst-case skew safe: a lane may send all its rows to
    one lane).  CUDA tensors run K2 and K24, CPU tensors their plain
    versions."""
    n = len(chunks)
    if n > vnode_count:
        raise ValueError(f"n_shards={n} exceeds vnode_count={vnode_count}")
    vnodes = [compute_vnodes(k, vnode_count) for k in key_cols]
    if chunks[0].device.type == "cuda":
        out = shuffle_chunk_cuda(chunks, vnodes, vnode_count)
    else:
        out = shuffle_chunk_plain(chunks, vnodes, vnode_count)
    EXCHANGE_TRACE["calls"] += 1
    EXCHANGE_TRACE["bytes"] += sum(
        t.element_size() * t.numel() for t, _ in _chunk_leaves(out[0]))
    return out
