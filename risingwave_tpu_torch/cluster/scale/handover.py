"""Online state handover: per-vnode checkpoint slices and the transplant.

Port of ``risingwave_tpu/cluster/scale/handover.py``.  When a vnode moves,
the state behind it moves with it, anchored at a durable checkpoint epoch
(``Engine.repartition_job`` drives the steps):

1. the recipient loads each donor partition's checkpoint at the handover
   epoch from the shared ``CheckpointStore`` (CPU tensors);
2. ``slice_job_states`` extracts exactly the moved vnodes' entries: a
   host gather over the loaded tree, as in the reference
   (``slice_partition_states`` :104, ``_slice_join_side`` :270);
3. ``clear_job_vnodes`` tombstones whatever the recipient still holds in
   the gained vnodes (``clear_vnodes`` :153, ``_clear_join_side`` :286):
   on the card one K26 launch per table (``csrc/vnode_sweep.cu``,
   ``vnode_sweep``), which also zeroes the slot-aligned leaves and counts
   the cleared slots;
4. ``transplant_job`` claims a slot for every moved key with the probe
   kernel's ``lookup_or_insert`` and scatters the donor rows into every
   slot-aligned leaf at the claimed slots (``transplant`` :387,
   ``_transplant_join_side`` :298): on the card one K27 launch per slice
   (``csrc/vnode_transplant.cu``, ``vnode_transplant``).

The live tables are updated IN PLACE, as everywhere in the port; the
functions still return the state tree (with the replaced leaves) and the
counts.  ``vnode_sweep_plain`` and ``transplant_rows_plain`` are the plain
versions of K26 and K27, used for CPU tensors.

Eligible state: ``HashAggExecutor`` (everything slot-aligned), the
``MaterializeExecutor`` (pk table + dense value columns) and dense hash-join
sides (key table + ``[size, B]`` buckets + per-key counts, moved as whole
key entries, so the bucket layout and the emission order are preserved).
A DISTINCT aggregation, rows in a spill ring, a pool join side and a
transplant that overflows the recipient's table raise, in the reference's
words.
"""

from __future__ import annotations

import ctypes

import torch

from risingwave_tpu_torch import kernels
from risingwave_tpu_torch.cluster.scale.vnode import (
    vnode_member_mask,
    vnodes_of_ints,
)
from risingwave_tpu_torch.common.chunk import NCol, StrCol
from risingwave_tpu_torch.state.hash_table import HashTable, gather_key
from risingwave_tpu_torch.stream.hash_agg import HashAggExecutor
from risingwave_tpu_torch.stream.materialize import (
    MaterializeExecutor,
    MvState,
)

#: most leaves one K26 / K27 descriptor holds (``RW_SWEEP_LEAVES``,
#: ``RW_TRANSPLANT_LEAVES``)
MAX_LEAVES = 48


def _leaves(col) -> list[torch.Tensor]:
    """The plain tensors of a column (NCol/StrCol aware), in order."""
    if isinstance(col, (NCol, StrCol)):
        return [t for part in col for t in _leaves(part)]
    return [col]


def _to_dev(col, device):
    """A host slice column on ``device`` (NCol/StrCol aware)."""
    if isinstance(col, NCol):
        return NCol(_to_dev(col.data, device), col.null.to(device))
    if isinstance(col, StrCol):
        return StrCol(col.data.to(device), col.lens.to(device))
    return col.to(device)


def _dist_payload(col):
    """Raw integer payload of the distribution key column (eligibility
    guarantees a NOT NULL integer-family column)."""
    return col.data if isinstance(col, NCol) else col


def _entry_mask(table, vnodes, n_vnodes) -> torch.Tensor:
    """``bool [size]`` on the host: occupied slots whose key falls in the
    vnode set."""
    occ = table.occupied.cpu()
    vn = vnodes_of_ints(_dist_payload(table.key_cols[0]).cpu(), n_vnodes)
    member = vnode_member_mask(vnodes, n_vnodes)
    return occ & member[vn.to(torch.int64)]


def _assert_plain_agg(state) -> None:
    if state.distinct_tables:
        raise RuntimeError(
            "vnode handover over a DISTINCT aggregation (dedup tables "
            "are not sliceable): not scale-eligible"
        )
    spill = getattr(state, "spill_count", ())
    if not isinstance(spill, tuple) and int(spill) != 0:
        raise RuntimeError(
            "vnode handover with rows in the spill ring — drain first"
        )


# -- K26 -----------------------------------------------------------------
class _SweepArgs(ctypes.Structure):
    """Mirror of ``struct VnodeSweepArgs`` in ``csrc/vnode_sweep.cu``."""

    _fields_ = [
        ("key0", ctypes.c_void_p), ("key_width", ctypes.c_int),
        ("size", ctypes.c_int), ("n_vnodes", ctypes.c_int),
        ("member", ctypes.c_void_p), ("occupied", ctypes.c_void_p),
        ("tombstone", ctypes.c_void_p), ("occ_out", ctypes.c_void_p),
        ("count", ctypes.c_void_p), ("n_leaves", ctypes.c_int),
        ("leaf", ctypes.c_void_p * MAX_LEAVES),
        ("row_bytes", ctypes.c_longlong * MAX_LEAVES),
    ]


def _row_bytes(t: torch.Tensor) -> int:
    return (t[0].numel() if t.shape[0] else 0) * t.element_size()


def vnode_sweep_plain(table: HashTable, member: torch.Tensor, n_vnodes: int,
                      leaves=(), read: bool = False):
    """Plain version of K26.  The clear form tombstones the stale slots,
    zeroes their rows in ``leaves`` (in place) and returns the count
    (int64 scalar); the read form returns the narrowed occupancy."""
    vn = vnodes_of_ints(_dist_payload(table.key_cols[0]), n_vnodes)
    stale = table.occupied & member[vn.to(torch.int64)]
    if read:
        return stale
    table.clear_where_plain(stale)
    for leaf in leaves:
        leaf[stale] = 0
    return stale.sum(dtype=torch.int64)


def vnode_sweep(table: HashTable, member: torch.Tensor, n_vnodes: int,
                leaves=(), read: bool = False):
    """K26 (``csrc/vnode_sweep.cu``) on a table's CUDA tensors: the clear
    form returns the cleared count (int64 scalar, on the device), the read
    form the narrowed occupancy.  CPU tensors take the plain version."""
    if table.occupied.device.type != "cuda":
        return vnode_sweep_plain(table, member, n_vnodes, leaves, read)
    leaves = list(leaves)
    if len(leaves) > MAX_LEAVES:
        raise ValueError(f"vnode_sweep: {len(leaves)} leaves, at most "
                         f"{MAX_LEAVES}")
    if member.shape != (n_vnodes,):
        raise ValueError(f"vnode_sweep: a {tuple(member.shape)} mask for "
                         f"{n_vnodes} vnodes")
    dev = table.occupied.device
    key0 = _dist_payload(table.key_cols[0]).contiguous()
    member = member.contiguous().view(torch.uint8)
    occ = table.occupied.view(torch.uint8)
    a = _SweepArgs()
    a.key0, a.key_width = key0.data_ptr(), key0.element_size()
    a.size, a.n_vnodes = table.size, n_vnodes
    a.member, a.occupied = member.data_ptr(), occ.data_ptr()
    tensors = [key0, member, occ]
    if read:
        out = torch.empty(table.size, dtype=torch.bool, device=dev)
        a.occ_out = out.view(torch.uint8).data_ptr()
        tensors.append(out)
    else:
        out = torch.zeros((), dtype=torch.int64, device=dev)
        tomb = table.tombstone.view(torch.uint8)
        a.tombstone, a.count = tomb.data_ptr(), out.data_ptr()
        tensors += [tomb, out]
        a.n_leaves = len(leaves)
        for k, leaf in enumerate(leaves):
            if leaf.shape[0] != table.size:
                raise ValueError("vnode_sweep: leaves must have "
                                 f"{table.size} rows, got {leaf.shape[0]}")
            a.leaf[k], a.row_bytes[k] = leaf.data_ptr(), _row_bytes(leaf)
        tensors += leaves
    kernels.require_cuda("vnode_sweep", *tensors)
    fn = kernels.entry("vnode_sweep", "rw_vnode_sweep",
                       [ctypes.POINTER(_SweepArgs), ctypes.c_void_p])
    kernels.count_launch("vnode_sweep")
    kernels.check(fn(ctypes.byref(a), kernels.stream_ptr(dev)),
                  "vnode_sweep")
    return out


# -- K27 -----------------------------------------------------------------
class _TransplantArgs(ctypes.Structure):
    """Mirror of ``struct TransplantArgs`` in ``csrc/vnode_transplant.cu``."""

    _fields_ = [
        ("slots", ctypes.c_void_p), ("n", ctypes.c_int),
        ("size", ctypes.c_int), ("n_leaves", ctypes.c_int),
        ("src", ctypes.c_void_p * MAX_LEAVES),
        ("dst", ctypes.c_void_p * MAX_LEAVES),
        ("row_bytes", ctypes.c_longlong * MAX_LEAVES),
    ]


def transplant_rows_plain(stores, srcs, slots: torch.Tensor,
                          size: int) -> None:
    """Plain version of K27: ``store[slots[r]] = src[r]`` in place for
    every leaf pair, slots >= size dropped."""
    keep = (slots >= 0) & (slots < size)
    pos = slots[keep].to(torch.int64)
    for store, src in zip(stores, srcs):
        store[pos] = src[keep]


def transplant_rows(stores, srcs, slots: torch.Tensor, size: int) -> None:
    """K27 (``csrc/vnode_transplant.cu``): one launch over every leaf
    pair; CPU tensors take the plain version."""
    stores, srcs = list(stores), list(srcs)
    if slots.device.type != "cuda":
        return transplant_rows_plain(stores, srcs, slots, size)
    if len(stores) > MAX_LEAVES:
        raise ValueError(f"vnode_transplant: {len(stores)} leaves, at "
                         f"most {MAX_LEAVES}")
    slots = slots.to(torch.int32).contiguous()
    n = slots.shape[0]
    srcs = [s.contiguous() for s in srcs]
    a = _TransplantArgs()
    a.slots, a.n, a.size, a.n_leaves = slots.data_ptr(), n, size, len(stores)
    for k, (dst, src) in enumerate(zip(stores, srcs)):
        if dst.dtype != src.dtype or dst.shape[1:] != src.shape[1:] \
                or src.shape[0] != n:
            raise ValueError(
                f"vnode_transplant: leaf {k}: {tuple(src.shape)} "
                f"{src.dtype} rows into a {tuple(dst.shape)} {dst.dtype} "
                "store")
        a.src[k], a.dst[k] = src.data_ptr(), dst.data_ptr()
        a.row_bytes[k] = _row_bytes(dst)
    kernels.require_cuda("vnode_transplant", slots, *stores, *srcs)
    fn = kernels.entry("vnode_transplant", "rw_vnode_transplant",
                       [ctypes.POINTER(_TransplantArgs), ctypes.c_void_p])
    kernels.count_launch("vnode_transplant")
    kernels.check(fn(ctypes.byref(a), kernels.stream_ptr(slots.device)),
                  "vnode_transplant")
    return None


# -- slice (donor checkpoint -> moved entries) ----------------------------
def slice_partition_states(executors, states, vnodes,
                           n_vnodes: int) -> dict[int, dict]:
    """The moved vnodes' entries of a (host) checkpoint state tree:
    ``{executor_idx: slice}`` for every keyed executor (the reference's
    :104)."""
    out: dict[int, dict] = {}
    for i, ex in enumerate(executors):
        st = states[i]
        if isinstance(ex, HashAggExecutor):
            _assert_plain_agg(st)
            idx = torch.nonzero(_entry_mask(st.table, vnodes,
                                            n_vnodes)).flatten()
            out[i] = {
                "kind": "agg",
                "n": int(idx.shape[0]),
                "keys": [gather_key(_to_dev(c, "cpu"), idx)
                         for c in st.table.key_cols],
                "prims": [p.cpu()[idx] for p in st.prims],
                "prev_prims": [p.cpu()[idx] for p in st.prev_prims],
                "row_count": st.row_count.cpu()[idx],
                "prev_row_count": st.prev_row_count.cpu()[idx],
                "dirty": st.dirty.cpu()[idx],
                "emitted": st.emitted.cpu()[idx],
                "minput_vals": [v.cpu()[idx] for v in st.minput_vals],
                "minput_occ": [o.cpu()[idx] for o in st.minput_occ],
            }
        elif isinstance(ex, MaterializeExecutor):
            idx = torch.nonzero(_entry_mask(st.table, vnodes,
                                            n_vnodes)).flatten()
            out[i] = {
                "kind": "mv",
                "n": int(idx.shape[0]),
                "keys": [gather_key(_to_dev(c, "cpu"), idx)
                         for c in st.table.key_cols],
                "values": [gather_key(_to_dev(v, "cpu"), idx)
                           for v in st.values],
            }
    return out


# -- clear (recipient live state: evict stale entries in the gained set) --
def _clear_state(ex, st, member, n_vnodes: int):
    """``(state, cleared count as a device scalar)`` of one keyed
    executor: one K26 launch over its table (in place) and, for an
    aggregation, its slot-aligned leaves."""
    leaves = [st.row_count, st.prev_row_count, st.dirty, st.emitted,
              *st.minput_occ] if isinstance(ex, HashAggExecutor) else []
    return st, vnode_sweep(st.table, member, n_vnodes, leaves)


def clear_vnodes(executors, states, vnodes, n_vnodes: int):
    """Tombstone every live entry in the vnode set (stale state of an
    earlier ownership must never shadow the donor's slice).  Returns
    ``(states', cleared entries)``."""
    new_states = list(states)
    counts = []
    for i, ex in enumerate(executors):
        if isinstance(ex, (HashAggExecutor, MaterializeExecutor)):
            member = vnode_member_mask(vnodes, n_vnodes,
                                       states[i].table.device)
            new_states[i], n = _clear_state(ex, states[i], member, n_vnodes)
            counts.append(n)
    return tuple(new_states), _read_sum(counts)


def _read_sum(counts) -> int:
    """One host read of the summed device counts."""
    return int(torch.stack(counts).sum()) if counts else 0


# -- DagJob partitions: joins ---------------------------------------------
def partition_sites(job) -> list[tuple]:
    """Every sliceable keyed state of a partitioned job as ``(path, kind,
    executor)``: ``(i,)`` for a linear job's executor, ``(node, exec)``
    for a DagJob fragment's executor, ``(node,)`` for a join node."""
    from risingwave_tpu_torch.stream.dag import DagJob, JoinNode, SideNode

    sites: list[tuple] = []
    if not isinstance(job, DagJob):
        for i, ex in enumerate(job.fragment.executors):
            if isinstance(ex, (HashAggExecutor, MaterializeExecutor)):
                sites.append(((i,), "agg" if isinstance(
                    ex, HashAggExecutor) else "mv", ex))
        return sites
    for ni, node in enumerate(job.nodes):
        if node is None:
            continue
        if isinstance(node, JoinNode) and not isinstance(node, SideNode):
            sites.append(((ni,), "join", node.join))
            continue
        if isinstance(node, SideNode):
            continue
        for ei, ex in enumerate(node.fragment.executors):
            if isinstance(ex, HashAggExecutor):
                sites.append(((ni, ei), "agg", ex))
            elif isinstance(ex, MaterializeExecutor):
                sites.append(((ni, ei), "mv", ex))
    return sites


def _tree_get(states, path):
    st = states
    for i in path:
        st = st[i]
    return st


def _tree_set(states, path, value):
    if not path:
        return value
    lst = list(states)
    lst[path[0]] = _tree_set(states[path[0]], path[1:], value)
    return tuple(lst)


def _assert_dense_join(st) -> None:
    from risingwave_tpu_torch.stream.hash_join import SideState

    for side_name in ("left", "right"):
        if not isinstance(getattr(st, side_name), SideState):
            raise RuntimeError(
                "vnode handover over a pool-storage join side "
                "(append-only pools are not sliceable): not "
                "scale-eligible"
            )


def _slice_join_side(side, vnodes, n_vnodes: int) -> dict:
    """Whole key entries (key + bucket rows + degree) whose FIRST
    join-key column's vnode moved."""
    idx = torch.nonzero(_entry_mask(side.key_table, vnodes,
                                    n_vnodes)).flatten()
    return {
        "n": int(idx.shape[0]),
        "keys": [gather_key(_to_dev(c, "cpu"), idx)
                 for c in side.key_table.key_cols],
        "rows": [gather_key(_to_dev(r, "cpu"), idx) for r in side.rows],
        "occupied": side.occupied.cpu()[idx],
        "count": side.count.cpu()[idx],
    }


def _clear_join_side(side, member, n_vnodes: int):
    """``(side, cleared count as a device scalar)``."""
    n = vnode_sweep(side.key_table, member, n_vnodes,
                    [side.occupied, side.count])
    return side, n


def _claim(table: HashTable, keys, what: str):
    """Find-or-claim a slot for every moved key (the probe kernel's
    ``lookup_or_insert``); raises before any value moves when the
    table cannot hold them."""
    n = _leaves(keys[0])[0].shape[0]
    valid = torch.ones(n, dtype=torch.bool, device=table.device)
    table, slots, _, overflow = table.lookup_or_insert(keys, valid)
    if bool((overflow & valid).any()):
        raise RuntimeError(
            f"vnode transplant overflowed {what} ({n} entries) — "
            "increase table capacity"
        )
    return table, slots


def _transplant_join_side(side, sl: dict):
    n = sl["n"]
    if n == 0:
        return side, 0
    dev = side.occupied.device
    keys = [_to_dev(c, dev) for c in sl["keys"]]
    table, slots = _claim(side.key_table, keys, "a join key table")
    stores = [t for r in side.rows for t in _leaves(r)] \
        + [side.occupied, side.count]
    srcs = [t.to(dev) for r in sl["rows"] for t in _leaves(r)] \
        + [sl["occupied"].to(dev), sl["count"].to(dev)]
    transplant_rows(stores, srcs, slots, table.size)
    return side._replace(key_table=table), n


def slice_job_states(job, states, vnodes, n_vnodes: int) -> dict:
    """``slice_partition_states`` over a partitioned job's (possibly
    nested) state tree; keys are state PATHS."""
    out: dict[tuple, dict] = {}
    for path, kind, ex in partition_sites(job):
        st = _tree_get(states, path)
        if kind == "join":
            _assert_dense_join(st)
            left = _slice_join_side(st.left, vnodes, n_vnodes)
            right = _slice_join_side(st.right, vnodes, n_vnodes)
            out[path] = {"kind": "join", "left": left, "right": right,
                         "n": left["n"] + right["n"]}
        else:
            out[path] = slice_partition_states([ex], (st,), vnodes,
                                               n_vnodes)[0]
    return out


def clear_job_vnodes(job, states, vnodes, n_vnodes: int):
    """``clear_vnodes`` over a partitioned job's state tree: one K26
    launch per table, one host read of the summed counts."""
    counts = []
    member = None
    for path, kind, ex in partition_sites(job):
        st = _tree_get(states, path)
        if kind == "join":
            _assert_dense_join(st)
            dev = st.left.occupied.device
        else:
            dev = st.table.device
        if member is None:
            member = vnode_member_mask(vnodes, n_vnodes, dev)
        if kind == "join":
            left, c1 = _clear_join_side(st.left, member, n_vnodes)
            right, c2 = _clear_join_side(st.right, member, n_vnodes)
            states = _tree_set(states, path,
                               st._replace(left=left, right=right))
            counts += [c1, c2]
        else:
            new, c = _clear_state(ex, st, member, n_vnodes)
            states = _tree_set(states, path, new)
            counts.append(c)
    return states, _read_sum(counts)


def transplant_job(job, states, slices: dict):
    """``transplant`` over a partitioned job's state tree (slices keyed
    by state path, as ``slice_job_states`` returns them)."""
    sites = {path: (kind, ex) for path, kind, ex in partition_sites(job)}
    moved = 0
    for path, sl in slices.items():
        path = tuple(path)
        _, ex = sites[path]
        st = _tree_get(states, path)
        if sl.get("kind") == "join":
            left, n1 = _transplant_join_side(st.left, sl["left"])
            right, n2 = _transplant_join_side(st.right, sl["right"])
            states = _tree_set(states, path,
                               st._replace(left=left, right=right))
            moved += n1 + n2
        else:
            new, n = transplant([ex], (st,), {0: sl})
            states = _tree_set(states, path, new[0])
            moved += n
    return states, moved


# -- transplant (moved entries -> recipient live state) -------------------
def transplant(executors, states, slices: dict[int, dict]):
    """Merge donor slices into the live state tree; returns ``(states',
    entries moved)``.  Raises when the recipient's table cannot claim a
    slot for every moved key."""
    new_states = list(states)
    moved = 0
    for i, sl in slices.items():
        st = states[i]
        n = sl["n"]
        if n == 0:
            continue
        dev = st.table.device
        keys = [_to_dev(c, dev) for c in sl["keys"]]
        table, slots = _claim(st.table, keys, f"executor {i}'s table")
        if sl["kind"] == "agg":
            stores = [*st.prims, *st.prev_prims, st.row_count,
                      st.prev_row_count, st.dirty, st.emitted,
                      *st.minput_vals, *st.minput_occ]
            srcs = [*sl["prims"], *sl["prev_prims"], sl["row_count"],
                    sl["prev_row_count"], sl["dirty"], sl["emitted"],
                    *sl["minput_vals"], *sl["minput_occ"]]
            transplant_rows(stores, [s.to(dev) for s in srcs], slots,
                            table.size)
            new_states[i] = st._replace(table=table)
        else:
            stores = [t for v in st.values for t in _leaves(v)]
            srcs = [t.to(dev) for v in sl["values"] for t in _leaves(v)]
            transplant_rows(stores, srcs, slots, table.size)
            new_states[i] = MvState(table, st.values, st.overflow)
        moved += n
    return tuple(new_states), moved
