"""TroublemakerExecutor: deterministic op corruption between executors.

Port of ``risingwave_tpu/stream/troublemaker.py`` (:32-57): a counter-based
hash (seeded, fully deterministic) flips about one Insert in ``ratio`` to a
Delete, which downstream stateful executors must surface through their
``inconsistency`` counters.

State is the chunk counter, a uint64 scalar held as its int64 bit
pattern.  On the card ``apply`` is one K28 launch (``csrc/troublemaker.cu``,
``troublemaker``), which also writes the advanced counter;
``troublemaker_plain`` is its plain version on int64 bit patterns (wrapping
multiplies, ``srl`` for the logical shifts, the exact unsigned modulo of
``cluster.scale.vnode.unsigned_mod``).
"""

from __future__ import annotations

import ctypes

import torch

from risingwave_tpu_torch import kernels
from risingwave_tpu_torch.cluster.scale.vnode import unsigned_mod
from risingwave_tpu_torch.common.chunk import Chunk, OP_DELETE, OP_INSERT
from risingwave_tpu_torch.common.hash import K1, K2, _signed, srl
from risingwave_tpu_torch.common.types import Schema
from risingwave_tpu_torch.stream.executor import Executor


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = (x ^ srl(x, 30)) * K2
    return x ^ srl(x, 31)


def troublemaker_plain(counter: torch.Tensor, valid: torch.Tensor,
                       ops: torch.Tensor, seed: int, ratio: int):
    """Plain version of K28: ``(counter + 1, ops)``."""
    row = torch.arange(valid.shape[0], dtype=torch.int64,
                       device=valid.device)
    h = _mix(row * K1 ^ counter * K2 ^ _signed(seed % (1 << 64)))
    flip = (unsigned_mod(h, ratio) == 0) & valid & (ops == OP_INSERT)
    return counter + 1, torch.where(flip, torch.full_like(ops, OP_DELETE),
                                    ops)


class _TmArgs(ctypes.Structure):
    """Mirror of ``struct TroublemakerArgs`` in ``csrc/troublemaker.cu``."""

    _fields_ = [
        ("valid", ctypes.c_void_p), ("ops", ctypes.c_void_p),
        ("ops_out", ctypes.c_void_p), ("counter", ctypes.c_void_p),
        ("counter_out", ctypes.c_void_p), ("seed", ctypes.c_ulonglong),
        ("ratio", ctypes.c_ulonglong), ("cap", ctypes.c_int),
    ]


def troublemaker_cuda(counter: torch.Tensor, valid: torch.Tensor,
                      ops: torch.Tensor, seed: int, ratio: int):
    """K28 on CUDA tensors: ``(counter + 1, ops)``, new tensors."""
    if ops.shape != valid.shape or counter.shape != ():
        raise ValueError("troublemaker: ops and valid of one chunk and a "
                         "scalar counter expected")
    valid_u8 = valid.contiguous().view(torch.uint8)
    ops = ops.contiguous()
    ops_out = torch.empty_like(ops)
    counter_out = torch.empty_like(counter)
    kernels.require_cuda("troublemaker", valid_u8, ops, ops_out, counter,
                         counter_out)
    a = _TmArgs()
    a.valid, a.ops, a.ops_out = (valid_u8.data_ptr(), ops.data_ptr(),
                                 ops_out.data_ptr())
    a.counter, a.counter_out = counter.data_ptr(), counter_out.data_ptr()
    a.seed, a.ratio = seed % (1 << 64), ratio
    a.cap = valid.shape[0]
    fn = kernels.entry("troublemaker", "rw_troublemaker",
                       [_TmArgs, ctypes.c_void_p])
    kernels.count_launch("troublemaker")
    kernels.check(fn(a, kernels.stream_ptr(valid.device)), "troublemaker")
    return counter_out, ops_out


class TroublemakerExecutor(Executor):
    """Flip ~1/ratio of Insert ops to Delete (deterministic by seed)."""

    emits_on_apply = True
    emits_on_flush = False

    def __init__(self, in_schema: Schema, seed: int = 0, ratio: int = 16):
        super().__init__(in_schema)
        if ratio < 1:
            raise ValueError(f"troublemaker ratio must be >= 1, got {ratio}")
        self.seed = seed
        self.ratio = ratio

    def init_state(self, device):
        return torch.zeros((), dtype=torch.int64, device=device)

    def apply(self, state, chunk: Chunk):
        fn = troublemaker_cuda if chunk.device.type == "cuda" \
            else troublemaker_plain
        state, ops = fn(state, chunk.valid, chunk.ops, self.seed, self.ratio)
        return state, Chunk(chunk.columns, ops, chunk.valid, chunk.schema)
