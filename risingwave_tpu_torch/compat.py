"""Carry executor state between the JAX reference and the port.

``state_from_numpy(tree)`` turns a reference executor state fetched to
the host (``jax.device_get``: its ``AggState``, ``MvState``,
``RingState``, ``HashTable``, ``WmState``, ``TagTable``,
``PoolSideState``, ``SideState``, ``JoinState``, ``TopNState``,
``DynFilterState``, ``TjState``, ``NCol`` and ``StrCol`` nodes with numpy leaves) into the port's state types with torch tensors
on ``device``; ``state_to_numpy`` maps a port state to the same node types
of the port with numpy leaves; ``state_mismatches`` compares the two
element for element.  Nodes are recognised by class name and fields,
so this module imports nothing of the reference package.

The reference's ``TagTable`` tags and ``TopNState`` row hashes are
uint64; the port's are the same bit patterns in int64, so every uint64
leaf converts with ``view`` (never a value cast) both ways and compares
by bit pattern.

``leaf_paths(tree)`` names every leaf of a reference host tree or a
port tree by its path (``[2].left.table.tags``), in flatten order, so
checkpoint payloads and digests of the two are matched leaf by leaf by
path rather than by index.

Every state of the ported plans converts: q7's agg, q5's pane agg,
retractable final agg and MV, q1's ring (``tests/test_torch_preagg.py``
carries them into a running port engine), q8's join with pool
storage on both sides (``tests/test_torch_dag.py``), the group top-N
of q19 and q18 (``tests/test_torch_top_n.py``) and the over-window, a
``TopNState`` whose emitted rows carry float64 window outputs
(``tests/test_torch_over_window_sql.py``), and q101's aggregation with
its spill ring, pool and dense join sides and MV
(``tests/test_torch_join_sql.py``), and q102's aggregation over the
join with its DISTINCT dedup tables and counts and its dynamic filter
(``tests/test_torch_q102_sql.py``), and q13's temporal join with its
build table (``tests/test_torch_table_sql.py``), and q5_max's
retractable final aggregation with its materialized-input buckets
(``minput_vals``, ``minput_occ``) and the EOWC sort's pool
(``tests/test_torch_minput.py``, ``tests/test_torch_eowc.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from risingwave_tpu_torch.common.chunk import NCol, StrCol
from risingwave_tpu_torch.state.hash_table import HashTable
from risingwave_tpu_torch.state.tag_table import TagTable
from risingwave_tpu_torch.stream.dynamic_filter import DynFilterState
from risingwave_tpu_torch.stream.hash_agg import AggState
from risingwave_tpu_torch.stream.hash_join import (
    JoinState,
    PoolSideState,
    SideState,
)
from risingwave_tpu_torch.stream.materialize import MvState, RingState
from risingwave_tpu_torch.stream.temporal_join import TjState
from risingwave_tpu_torch.stream.top_n import TopNState
from risingwave_tpu_torch.stream.watermark import EowcSortState, WmState

_STATE_TYPES = {cls.__name__: cls
                for cls in (AggState, MvState, RingState, WmState, NCol,
                            StrCol, PoolSideState, SideState, JoinState,
                            TopNState, DynFilterState, TjState,
                            EowcSortState)}


def state_from_numpy(tree, device="cpu"):
    """Reference state (numpy leaves) -> port state on ``device``."""
    name = type(tree).__name__
    if name == "TagTable":
        tags = np.asarray(tree.tags).view(np.int64)
        return TagTable(torch.from_numpy(tags.copy()).to(device), tree.size)
    if name == "HashTable":
        return HashTable(
            tuple(state_from_numpy(c, device) for c in tree.key_cols),
            state_from_numpy(tree.occupied, device),
            state_from_numpy(tree.tombstone, device), tree.size)
    if name in _STATE_TYPES and hasattr(tree, "_fields"):
        cls = _STATE_TYPES[name]
        return cls(*(state_from_numpy(getattr(tree, f), device)
                     for f in cls._fields))
    if isinstance(tree, tuple):
        return tuple(state_from_numpy(v, device) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype == np.uint64:
        arr = arr.view(np.int64)
    return torch.from_numpy(arr.copy()).to(device)


def state_to_numpy(tree):
    """Port state -> the same node types with numpy leaves."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, TagTable):
        return TagTable(state_to_numpy(tree.tags), tree.size)
    if isinstance(tree, HashTable):
        return HashTable(tuple(state_to_numpy(c) for c in tree.key_cols),
                         state_to_numpy(tree.occupied),
                         state_to_numpy(tree.tombstone), tree.size)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(state_to_numpy(v) for v in tree))
    if isinstance(tree, tuple):
        return tuple(state_to_numpy(v) for v in tree)
    return tree


def leaf_paths(tree, path: str = "") -> list[tuple[str, object]]:
    """``[(path, leaf)]`` of a reference host tree (numpy leaves) or a
    port tree, in the order both packages flatten them."""
    name = type(tree).__name__
    if isinstance(tree, (torch.Tensor, np.ndarray, np.generic)):
        return [(path, tree)]
    if name == "TagTable":
        return leaf_paths(tree.tags, f"{path}.tags")
    if name == "HashTable":
        return (leaf_paths(tuple(tree.key_cols), f"{path}.key_cols")
                + leaf_paths(tree.occupied, f"{path}.occupied")
                + leaf_paths(tree.tombstone, f"{path}.tombstone"))
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = []
        for f in tree._fields:
            out += leaf_paths(getattr(tree, f), f"{path}.{f}")
        return out
    if isinstance(tree, tuple):
        out = []
        for i, v in enumerate(tree):
            out += leaf_paths(v, f"{path}[{i}]")
        return out
    if tree is None:
        return []
    return [(path, np.asarray(tree))]


def state_mismatches(ref, port, path: str = "state") -> list[str]:
    """Paths where a reference state (numpy leaves) and a port state
    differ, element for element; empty when they are equal.  Walks the
    port's tree and reads the reference's fields of the same names."""
    if isinstance(port, torch.Tensor):
        port = state_to_numpy(port)
    if isinstance(port, TagTable):
        ref_tags = np.asarray(ref.tags).view(np.int64)
        return state_mismatches(ref_tags, port.tags, f"{path}.tags")
    if isinstance(port, HashTable):
        return (state_mismatches(ref.key_cols, port.key_cols, f"{path}.key")
                + state_mismatches(ref.occupied, port.occupied,
                                   f"{path}.occupied")
                + state_mismatches(ref.tombstone, port.tombstone,
                                   f"{path}.tombstone"))
    if isinstance(port, tuple) and hasattr(port, "_fields"):
        out = []
        for f in port._fields:
            out += state_mismatches(getattr(ref, f), getattr(port, f),
                                    f"{path}.{f}")
        return out
    if isinstance(port, tuple):
        if len(ref) != len(port):
            return [f"{path} (length {len(ref)} vs {len(port)})"]
        out = []
        for i, (r, p) in enumerate(zip(ref, port)):
            out += state_mismatches(r, p, f"{path}[{i}]")
        return out
    r = np.asarray(ref)
    if r.dtype == np.uint64 and port.dtype == np.int64:
        r = r.view(np.int64)
    if r.shape != port.shape or r.dtype != port.dtype \
            or not np.array_equal(r, port):
        return [path]
    return []
