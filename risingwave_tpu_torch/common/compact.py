"""Fixed-size mask compaction.

Port of ``mask_indices`` from ``risingwave_tpu/common/compact.py``
(:32): the indices of up to ``k`` set bits of a mask, ascending, with
``fill`` for the rest.  Computed with a cumulative sum and a scatter
(no ``nonzero``, so the output shape never depends on the data and the
host never synchronises).
"""

from __future__ import annotations

import torch


def mask_indices(mask: torch.Tensor, k: int, fill: int) -> torch.Tensor:
    """int32 [k]: ascending indices of set bits of ``mask``, ``fill``
    past the last one."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int32), 0) - 1
    keep = mask & (pos < k)
    out = torch.full((k + 1,), fill, dtype=torch.int32, device=mask.device)
    # kept positions are unique; every other row lands on the dump slot k
    tgt = torch.where(keep, pos, torch.full_like(pos, k)).to(torch.int64)
    out.scatter_(0, tgt, torch.arange(n, dtype=torch.int32,
                                      device=mask.device))
    return out[:k]
