"""Mask compaction and segment primitives.

Port of ``risingwave_tpu/common/compact.py``:

- ``accel_tuned`` (:26): the reference picks the accelerator tunings
  per process from JAX's default backend; here the branch follows the
  device of the data, so ``device.type == "cuda"`` takes it.
- ``mask_indices`` (:32): the indices of up to ``k`` set bits of a
  mask, ascending, ``fill`` for the rest.  On the card this is kernel
  K7 (``csrc/compact.cu``, ``rw_mask_indices``); the plain version is a
  cumulative sum and a scatter.  Neither reads anything back to the
  host, and the output shape never depends on the data.
- ``segment_starts``, ``segment_start_positions``, ``segmented_sum``
  and ``segmented_minmax_at_ends`` (:46-110): the building blocks of
  the agg's pre-aggregation branch, as plain versions (the card runs
  them fused in kernel K5, ``csrc/agg_preagg.cu``).
"""

from __future__ import annotations

import ctypes

import torch

from risingwave_tpu_torch import kernels


def accel_tuned(device) -> bool:
    """True when the data lives on the card (accelerator tunings)."""
    return torch.device(device).type == "cuda"


def mask_indices_plain(mask: torch.Tensor, k: int, fill: int) -> torch.Tensor:
    """Plain PyTorch version of kernel K7: int32 [k]."""
    n = mask.shape[0]
    pos = torch.cumsum(mask.to(torch.int32), 0) - 1
    keep = mask & (pos < k)
    out = torch.full((k + 1,), fill, dtype=torch.int32, device=mask.device)
    # kept positions are unique; every other row lands on the dump slot k
    tgt = torch.where(keep, pos, torch.full_like(pos, k)).to(torch.int64)
    out.scatter_(0, tgt, torch.arange(n, dtype=torch.int32,
                                      device=mask.device))
    return out[:k]


#: mask bytes per block of ``rw_mask_indices`` (MI_TILE in compact.cu)
_MI_TILE = 1024


def mask_indices_cuda(mask: torch.Tensor, k: int, fill: int) -> torch.Tensor:
    """Kernel K7 (``csrc/compact.cu``): two passes, one wrapper launch."""
    m = mask.contiguous().view(torch.uint8)
    kernels.require_cuda("mask_indices", m)
    n = m.shape[0]
    out = torch.empty(k, dtype=torch.int32, device=m.device)
    counts = torch.empty(max(1, -(-n // _MI_TILE)), dtype=torch.int32,
                         device=m.device)
    fn = kernels.entry("mask_indices", "rw_mask_indices", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    kernels.count_launch("mask_indices")
    kernels.check(fn(m.data_ptr(), n, k, fill, out.data_ptr(),
                     counts.data_ptr(), kernels.stream_ptr(m.device)),
                  "mask_indices")
    return out


def mask_indices(mask: torch.Tensor, k: int, fill: int) -> torch.Tensor:
    """int32 [k]: ascending indices of set bits of ``mask``, ``fill``
    past the last one.  CUDA tensors launch kernel K7."""
    if mask.device.type == "cuda":
        return mask_indices_cuda(mask, k, fill)
    return mask_indices_plain(mask, k, fill)


def segment_starts(sorted_neq: torch.Tensor) -> torch.Tensor:
    """[n-1] adjacent inequality -> [n] is-segment-start mask."""
    return torch.cat([torch.ones(1, dtype=torch.bool,
                                 device=sorted_neq.device), sorted_neq])


def segment_start_positions(starts: torch.Tensor) -> torch.Tensor:
    """Index of each row's segment start (int32 [n]), a running max."""
    idx = torch.arange(starts.shape[0], dtype=torch.int32,
                       device=starts.device)
    return torch.cummax(torch.where(starts, idx, torch.zeros_like(idx)),
                        0).values


def segmented_sum(values: torch.Tensor,
                  start_pos: torch.Tensor) -> torch.Tensor:
    """Inclusive segmented running sum (cumsum minus the prefix before
    the segment); the value at each segment's END is its total."""
    c = torch.cumsum(values, 0, dtype=values.dtype)
    prev = torch.clamp(start_pos - 1, min=0).to(torch.int64)
    base = torch.where(start_pos > 0, c[prev], torch.zeros_like(c))
    return c - base


def segmented_minmax_at_ends(seg_id: torch.Tensor, values: torch.Tensor,
                             start_pos: torch.Tensor, mode: str):
    """Per-segment min or max of ``values``, right at least at each
    segment's END row.  One two-key sort by (segment id, value) — two
    stable sorts, the minor key first — puts the segment's min on its
    start row and its max on its end row."""
    by_value = torch.sort(values, stable=True).indices
    order = by_value[torch.sort(seg_id[by_value], stable=True).indices]
    sorted_v = values[order]
    if mode == "min":
        return sorted_v[start_pos.to(torch.int64)]
    if mode == "max":
        return sorted_v
    raise ValueError(mode)
