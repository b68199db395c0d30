"""Flatten and rebuild executor state trees.

The port's stand-in for ``jax.tree.flatten`` / ``jax.tree.unflatten``
over the state types the reference registers as pytrees.  The leaf
order is the reference's:

- NamedTuples in field order, plain tuples in order (an empty tuple, a
  reference-only ``AggState`` field that defaults to ``()``, adds no
  leaf);
- ``HashTable`` as ``(key_cols, occupied, tombstone)``
  (``risingwave_tpu/state/hash_table.py:169``), its ``size`` static;
- ``TagTable`` as ``(tags,)`` (:425), its ``size`` static;
- ``NCol`` / ``StrCol`` in field order (they are NamedTuples).

For the states of q7 and q8 the leaf lists match the reference's one
for one, in order, shape and dtype, except that a ``TagTable``'s tags
are int64 here and uint64 there (the same bit patterns): 23 leaves for
q7 and 42 for q8 at any size.  ``tests/test_torch_checkpoint_store.py``
matches them by path (``compat.leaf_paths``).

``flatten`` returns the leaves and a ``TreeSpec``: a picklable
description of the node types, their static fields and every leaf's
shape and dtype.  The checkpoint store pickles the spec beside an
epoch's payload (the reference pickles a JAX treedef there).
"""

from __future__ import annotations

import importlib
from dataclasses import dataclass

import numpy as np
import torch

#: node kinds of a spec
_TENSOR, _NONE, _TUPLE, _NAMED, _HASH, _TAG = range(6)


@dataclass(frozen=True)
class TreeSpec:
    """The structure of a state tree.  ``node`` is a nested tuple:
    ``(kind, static, children)``; ``leaves`` holds ``(dtype name,
    shape)`` per leaf in flatten order."""

    node: tuple
    leaves: tuple

    @property
    def shapes(self) -> list[tuple]:
        return [s for _, s in self.leaves]


def _table_types():
    from risingwave_tpu_torch.state.hash_table import HashTable
    from risingwave_tpu_torch.state.tag_table import TagTable

    return HashTable, TagTable


def _build(x, leaves: list, meta: list) -> tuple:
    HashTable, TagTable = _table_types()
    if isinstance(x, torch.Tensor):
        leaves.append(x)
        meta.append((str(x.dtype).replace("torch.", ""), tuple(x.shape)))
        return (_TENSOR, None, ())
    if x is None:
        return (_NONE, None, ())
    if isinstance(x, HashTable):
        return (_HASH, x.size, (
            _build(tuple(x.key_cols), leaves, meta),
            _build(x.occupied, leaves, meta),
            _build(x.tombstone, leaves, meta)))
    if isinstance(x, TagTable):
        return (_TAG, x.size, (_build(x.tags, leaves, meta),))
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        cls = type(x)
        if not cls.__module__.startswith("risingwave_tpu_torch."):
            raise TypeError(f"state node {cls!r} is not a port type")
        return (_NAMED, (cls.__module__, cls.__qualname__),
                tuple(_build(v, leaves, meta) for v in x))
    if isinstance(x, tuple):
        return (_TUPLE, None, tuple(_build(v, leaves, meta) for v in x))
    raise TypeError(f"unsupported state node {type(x).__name__}")


def flatten(tree) -> tuple[list[torch.Tensor], TreeSpec]:
    """(leaves in the reference's order, spec)."""
    leaves: list = []
    meta: list = []
    node = _build(tree, leaves, meta)
    return leaves, TreeSpec(node, tuple(meta))


def _named_class(static):
    module, qualname = static
    if not module.startswith("risingwave_tpu_torch."):
        raise TypeError(f"refusing to rebuild node type {module}.{qualname}")
    obj = importlib.import_module(module)
    for part in qualname.split("."):
        obj = getattr(obj, part)
    return obj


def unflatten(spec: TreeSpec, leaves) -> object:
    """Rebuild a tree of ``spec`` from ``leaves`` (tensors, or numpy
    arrays, which become CPU tensors)."""
    HashTable, TagTable = _table_types()
    it = iter(leaves)

    def rebuild(node):
        kind, static, children = node
        if kind == _TENSOR:
            v = next(it)
            if isinstance(v, np.ndarray):
                # (np.ascontiguousarray would turn a 0-d array 1-d)
                return torch.from_numpy(
                    v if v.flags.c_contiguous else v.copy())
            return v
        if kind == _NONE:
            return None
        kids = [rebuild(c) for c in children]
        if kind == _HASH:
            return HashTable(kids[0], kids[1], kids[2], static)
        if kind == _TAG:
            return TagTable(kids[0], static)
        if kind == _NAMED:
            return _named_class(static)(*kids)
        return tuple(kids)

    out = rebuild(spec.node)
    if next(it, None) is not None:
        raise ValueError("more leaves than the spec holds")
    return out


def tree_map(fn, tree):
    """``unflatten(spec, [fn(leaf) ...])``."""
    leaves, spec = flatten(tree)
    return unflatten(spec, [fn(x) for x in leaves])
