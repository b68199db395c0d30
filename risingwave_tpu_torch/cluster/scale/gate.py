"""VnodeGateExecutor: the per-partition row filter.

Port of ``risingwave_tpu/cluster/scale/gate.py`` (:57-116).  A partition
of a streaming job is a full replica of the job's fragment fed by the
whole source (replicate mode); the gate sits before the keyed executor
and narrows the validity mask to the rows whose distribution-key vnode
the partition owns.  The owned set is the executor's STATE, a ``bool
[n_vnodes]`` mask, so a scale step swaps a tensor and nothing replans.

State has two forms, as in the reference: a bare mask, or the ``(mask,
dropped)`` pair the partitioned runtime threads, whose ``dropped`` (int64
scalar) counts the valid rows the gate masked out over the partition's
life.

On the card ``apply`` is one K25 launch (``csrc/vnode_gate.cu``,
``vnode_gate``): hash, membership gather, the update-pair degradation and
the dropped count, added into ``dropped`` in place.  ``gate_apply_plain``
is its plain version, used for CPU tensors.  The degradation follows the
reference's ``jnp.roll``: a U- at row ``i`` looks at ``keep[(i + 1) %
cap]`` and a U+ at ``keep[(i - 1) % cap]``, wrapping around the chunk's
capacity.
"""

from __future__ import annotations

import torch

from risingwave_tpu_torch.cluster.scale.vnode import (
    vnode_gate_cuda,
    vnode_member_mask,
    vnodes_of_ints_plain,
)
from risingwave_tpu_torch.common.chunk import (
    Chunk,
    OP_DELETE,
    OP_INSERT,
    OP_UPDATE_DELETE,
    OP_UPDATE_INSERT,
    split_col,
)
from risingwave_tpu_torch.common.types import Schema
from risingwave_tpu_torch.expr.node import Expr
from risingwave_tpu_torch.stream.executor import Executor


def gate_apply_plain(key: torch.Tensor, mask: torch.Tensor,
                     valid: torch.Tensor, ops: torch.Tensor,
                     n_vnodes: int):
    """Plain version of K25's gate form: ``(keep, ops, dropped rows)``."""
    vn = vnodes_of_ints_plain(key, n_vnodes)
    keep = mask[vn.to(torch.int64)] & valid
    is_ud = ops == OP_UPDATE_DELETE
    is_ui = ops == OP_UPDATE_INSERT
    out = torch.where(is_ud & keep & ~torch.roll(keep, -1),
                      torch.full_like(ops, OP_DELETE), ops)
    out = torch.where(is_ui & keep & ~torch.roll(keep, 1),
                      torch.full_like(ops, OP_INSERT), out)
    dropped = (valid & ~keep).sum(dtype=torch.int64)
    return keep, out, dropped


class VnodeGateExecutor(Executor):
    """Mask rows to the partition's owned vnodes (state = the mask)."""

    emits_on_apply = True
    emits_on_flush = False

    def __init__(self, in_schema: Schema, key_expr, n_vnodes: int):
        super().__init__(in_schema)
        # one routing key, or a join side's equi keys: the vnode is the
        # hash of the FIRST
        exprs = key_expr if isinstance(key_expr, (list, tuple)) \
            else [key_expr]
        self.key_exprs: tuple[Expr, ...] = tuple(exprs)
        self.key_expr = self.key_exprs[0]
        self.n_vnodes = n_vnodes

    def init_state(self, device):
        # owns everything until the control plane narrows it
        return (torch.ones(self.n_vnodes, dtype=torch.bool, device=device),
                torch.zeros((), dtype=torch.int64, device=device))

    def make_mask(self, vnodes, device=None):
        """Membership mask for ``set_job_vnodes`` state swaps."""
        return vnode_member_mask(vnodes, self.n_vnodes, device)

    def apply(self, state, chunk: Chunk):
        if isinstance(state, tuple):
            mask, dropped = state
        else:
            mask, dropped = state, None
        key, _ = split_col(self.key_expr.eval(chunk))
        if chunk.device.type == "cuda":
            cap = chunk.capacity
            keep = torch.empty(cap, dtype=torch.bool, device=chunk.device)
            ops = torch.empty_like(chunk.ops)
            sink = dropped if dropped is not None else torch.zeros(
                (), dtype=torch.int64, device=chunk.device)
            vnode_gate_cuda(key, self.n_vnodes, member=mask,
                            valid=chunk.valid, ops=chunk.ops, ops_out=ops,
                            keep_out=keep, dropped=sink)
        else:
            keep, ops, n_drop = gate_apply_plain(
                key.to(torch.int64), mask, chunk.valid, chunk.ops,
                self.n_vnodes)
            if dropped is not None:
                dropped = dropped + n_drop
        out = Chunk(chunk.columns, ops, keep, chunk.schema)
        if dropped is None:
            return mask, out
        return (mask, dropped), out

    def __repr__(self) -> str:
        return f"VnodeGateExecutor(n={self.n_vnodes})"
