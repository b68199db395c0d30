"""The vnode keyspace: the vnode of a key, the map and its rebalance.

Port of ``risingwave_tpu/cluster/scale/vnode.py``.  ``_targets``,
``initial_map``, ``rebalance``, ``moved_vnodes`` and ``owned_vnodes`` are
a copy of the reference's pure functions (a plain ``list[int]`` of length
``n_vnodes`` whose entries are worker ids; sorted-worker order, index
order), so every process derives the same map from the same inputs.

``vnodes_of_ints`` and ``vnode_member_mask`` take and return tensors.  A
key's vnode is ``hash64_columns([key as int64]) % n_vnodes`` with the
modulo taken on the UNSIGNED 64-bit hash: the plain version computes it
on the int64 bit pattern as ``((srl(h, 1) % n) * 2 + (h & 1)) % n``,
exact for every ``n`` (the state tables' ``h & (size - 1)`` holds only
for powers of two).  On the card it is K25 (``csrc/vnode_gate.cu``,
``vnode_gate``) in its vnode-only form; the gate (``gate.py``) runs the
same launch with the membership gather and the update-pair degradation.
"""

from __future__ import annotations

import ctypes

import torch

from risingwave_tpu_torch import kernels
from risingwave_tpu_torch.common.hash import hash64_columns_plain, srl

#: the default ring size (the reference's: 64 keeps the per-vnode slices
#: chunky on small tables)
N_VNODES_DEFAULT = 64


def unsigned_mod(h: torch.Tensor, n: int) -> torch.Tensor:
    """``h mod n`` of the uint64 bit patterns in the int64 tensor ``h``."""
    return ((srl(h, 1) % n) * 2 + (h & 1)) % n


def vnodes_of_ints_plain(col: torch.Tensor, n_vnodes: int) -> torch.Tensor:
    """Plain version of K25's vnode form: ``int32 [cap]``."""
    h = hash64_columns_plain([col.to(torch.int64)])
    return unsigned_mod(h, n_vnodes).to(torch.int32)


def vnodes_of_ints(col: torch.Tensor, n_vnodes: int) -> torch.Tensor:
    """``int32 [cap]`` vnode of each value of an integer key column (the
    reference's :29).  CPU tensors take the plain version; CUDA tensors
    launch K25."""
    if col.device.type != "cuda":
        return vnodes_of_ints_plain(col, n_vnodes)
    vn = torch.empty(col.shape[0], dtype=torch.int32, device=col.device)
    vnode_gate_cuda(col, n_vnodes, vnode=vn)
    return vn


def vnode_member_mask(vnodes, n_vnodes: int, device=None) -> torch.Tensor:
    """``bool [n_vnodes]`` membership mask of a vnode set."""
    mask = torch.zeros(n_vnodes, dtype=torch.bool, device=device)
    vn = sorted(int(v) for v in vnodes)
    if vn:
        mask[torch.tensor(vn, dtype=torch.int64, device=device)] = True
    return mask


class _GateArgs(ctypes.Structure):
    """Mirror of ``struct VnodeGateArgs`` in ``csrc/vnode_gate.cu``."""

    _fields_ = [
        ("key", ctypes.c_void_p), ("key_width", ctypes.c_int),
        ("cap", ctypes.c_int), ("n_vnodes", ctypes.c_int),
        ("vnode", ctypes.c_void_p), ("member", ctypes.c_void_p),
        ("valid", ctypes.c_void_p), ("ops", ctypes.c_void_p),
        ("ops_out", ctypes.c_void_p), ("keep_out", ctypes.c_void_p),
        ("dropped", ctypes.c_void_p),
    ]


def vnode_gate_cuda(key: torch.Tensor, n_vnodes: int, *, vnode=None,
                    member=None, valid=None, ops=None, ops_out=None,
                    keep_out=None, dropped=None) -> None:
    """One K25 launch on CUDA tensors.  With ``vnode`` it writes each
    row's vnode; with ``member`` (``bool [n_vnodes]``) it writes
    ``keep = member[vnode] & valid`` into ``keep_out``, the degraded ops
    into ``ops_out`` and adds the dropped rows into ``dropped`` (int64
    scalar, in place)."""
    if key.dtype.is_floating_point or key.dtype == torch.bool:
        raise ValueError(f"vnode_gate: integer key expected, got {key.dtype}")
    key = key.contiguous()
    cap = key.shape[0]
    a = _GateArgs()
    a.key, a.key_width = key.data_ptr(), key.element_size()
    a.cap, a.n_vnodes = cap, n_vnodes
    tensors = [key]
    if vnode is not None:
        tensors.append(vnode)
        a.vnode = vnode.data_ptr()
    if member is not None:
        if member.shape != (n_vnodes,) or valid.shape != (cap,) \
                or ops.shape != (cap,) or ops_out.shape != (cap,) \
                or keep_out.shape != (cap,) or dropped.dtype != torch.int64:
            raise ValueError(
                f"vnode_gate: a {tuple(member.shape)} mask for {n_vnodes} "
                f"vnodes and {cap}-row planes expected")
        flags = [member.contiguous().view(torch.uint8),
                 valid.contiguous().view(torch.uint8), ops.contiguous(),
                 ops_out, keep_out.view(torch.uint8), dropped]
        tensors += flags
        (a.member, a.valid, a.ops, a.ops_out, a.keep_out,
         a.dropped) = [t.data_ptr() for t in flags]
    kernels.require_cuda("vnode_gate", *tensors)
    fn = kernels.entry("vnode_gate", "rw_vnode_gate",
                       [_GateArgs, ctypes.c_void_p])
    kernels.count_launch("vnode_gate")
    kernels.check(fn(a, kernels.stream_ptr(key.device)), "vnode_gate")


def _targets(workers: list[int], n_vnodes: int) -> dict[int, int]:
    """Per-worker vnode quota: floor(n/W) (+1 for the first ``n mod W``
    workers in ascending id order)."""
    ws = sorted(workers)
    base, extra = divmod(n_vnodes, len(ws))
    return {w: base + (1 if i < extra else 0) for i, w in enumerate(ws)}


def initial_map(workers: list[int], n_vnodes: int) -> list[int]:
    """First assignment: round-robin over sorted workers."""
    ws = sorted(workers)
    return [ws[v % len(ws)] for v in range(n_vnodes)]


def rebalance(old: list[int] | None, workers: list[int],
              n_vnodes: int) -> list[int]:
    """Remap the ring onto ``workers`` moving the minimal vnode set: each
    surviving worker keeps its vnodes up to its new quota (in index
    order); the excess and every vnode whose owner left go, in index
    order, to the first under-quota worker in ascending id order."""
    if not workers:
        raise ValueError("rebalance needs at least one worker")
    if old is None:
        return initial_map(workers, n_vnodes)
    if len(old) != n_vnodes:
        raise ValueError(
            f"map has {len(old)} vnodes, expected {n_vnodes}"
        )
    quota = _targets(workers, n_vnodes)
    kept: dict[int, int] = {w: 0 for w in quota}
    new = list(old)
    pending: list[int] = []
    for v, w in enumerate(old):
        if w in quota and kept[w] < quota[w]:
            kept[w] += 1
        else:
            pending.append(v)
    order = sorted(quota)
    for v in pending:
        for w in order:
            if kept[w] < quota[w]:
                new[v] = w
                kept[w] += 1
                break
    return new


def moved_vnodes(old: list[int],
                 new: list[int]) -> dict[tuple[int, int], list[int]]:
    """``{(src_worker, dst_worker): [vnode, ...]}`` of every vnode that
    changed owner (the handover work list)."""
    out: dict[tuple[int, int], list[int]] = {}
    for v, (a, b) in enumerate(zip(old, new)):
        if a != b:
            out.setdefault((a, b), []).append(v)
    return out


def owned_vnodes(vmap: list[int], worker_id: int) -> list[int]:
    return [v for v, w in enumerate(vmap) if w == worker_id]
