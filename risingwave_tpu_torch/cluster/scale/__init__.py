"""The elastic vnode scale plane (port of ``risingwave_tpu/cluster/scale``).

- ``vnode``: the vnode keyspace, the vnode -> worker map and its minimal
  rebalance (pure functions, a copy of the reference's), and the vnode of
  an integer key on tensors (K25's hash);
- ``gate``: ``VnodeGateExecutor``, the per-partition row filter (K25);
- ``handover``: per-vnode checkpoint slices, the clear of gained vnodes
  (K26) and the transplant of donor slices into live state (K27).
"""

from risingwave_tpu_torch.cluster.scale.vnode import (  # noqa: F401
    N_VNODES_DEFAULT,
    initial_map,
    moved_vnodes,
    owned_vnodes,
    rebalance,
    vnode_member_mask,
    vnodes_of_ints,
)
