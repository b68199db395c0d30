"""Vnode sharding over a mesh of lanes.

Port of ``risingwave_tpu/parallel``: the hash exchange
(``exchange.shuffle_chunk``, K2 and K24) between the two halves of a
sharded job (``stream/sharded.py``).
"""

from risingwave_tpu_torch.parallel.exchange import (
    shard_of_vnode,
    shuffle_chunk,
)

__all__ = ["shard_of_vnode", "shuffle_chunk"]
