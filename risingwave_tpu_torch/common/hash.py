"""64-bit key hashing for state-table slot selection.

Port of the ``hash64_columns`` part of ``risingwave_tpu/common/hash.py``
(``hash64_columns`` :183, ``_mix64`` :160, ``normalize_null_col`` :32)
and of its split form ``hash64_partial`` / ``hash64_extend`` /
``hash64_finish`` (:203-232), which the join's tag table uses to fold a
key hash once and finish it with a varying rank.
Kernel A (``csrc/hash64.cu``) computes it on the card, string and
float keys included;
``hash64_columns_plain`` is its plain PyTorch version, used for CPU
tensors and as the card-side reference.

Float keys follow the reference's ``_key_words`` (:72) as XLA's CPU
runtime computes it, with denormals-are-zero and flush-to-zero set:
-0.0, +0.0 and every subnormal fold as +0.0 and every NaN as one NaN;
a float32 folds its bits; a float64 folds two float32 words,
``hi = f32(x)`` and ``lo = f32(x - f64(hi))``, each rounded to nearest
with a subnormal result flushed to a zero of its sign (an infinite x
has the narrowed default NaN of ``inf - inf`` as ``lo``).

K2 (``csrc/crc32.cu``) is the vnode hash of the reference's
``crc32_columns`` (:94) and ``compute_vnodes`` (:137): a zlib-equal CRC32
over each row's little-endian key words (the same canonical words as the
64-bit hash: a bool and the null flag widen to 8 bytes, int32 gives 4,
int16 2, a float32 its 4-byte word, a float64 its two; a string its bytes
up to ``lens``), and vnode = crc % ``VNODE_COUNT``.  ``compute_vnodes_plain``
is its plain version; the CRC state is carried in int64 masked to 32 bits
(torch has no unsigned ``>>``).

Hashes are returned as ``int64`` tensors holding the uint64 bit
pattern (``.view(np.uint64)`` on the host gives the reference's
values).  PyTorch's uint64 tensors lack ``>>``, ``%`` and ``<``, so the
plain version computes in int64: a logical right shift is
``(x >> k) & ((1 << (64 - k)) - 1)``, multiplies wrap, and ``h % size``
becomes ``h & (size - 1)`` for the power-of-two table sizes the hash
table enforces.  The reference's ``~0 -> ~1`` remap is ``-1 -> -2`` on
the int64 pattern.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from risingwave_tpu_torch import kernels
from risingwave_tpu_torch.common.chunk import NCol, StrCol

_MIX_K1 = 0x9E3779B97F4A7C15
_MIX_K2 = 0xBF58476D1CE4E5B9
_MIX_K3 = 0x94D049BB133111EB


def _signed(c: int) -> int:
    """A uint64 constant as the int64 with the same bit pattern."""
    return c - (1 << 64) if c >= 1 << 63 else c


K1 = _signed(_MIX_K1)
K2 = _signed(_MIX_K2)
K3 = _signed(_MIX_K3)


def srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of an int64 tensor's bit pattern."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer on int64 bit patterns (``_mix64``)."""
    x = (x ^ srl(x, 30)) * K2
    x = (x ^ srl(x, 27)) * K3
    return x ^ srl(x, 31)


def normalize_null_col(col) -> list:
    """An ``NCol`` becomes [payload-with-nulls-zeroed, null-flag], so
    equal values (NULL == NULL included) hash equally."""
    if not isinstance(col, NCol):
        return [col]
    data, null = col.data, col.null
    if isinstance(data, StrCol):
        zeroed = StrCol(
            torch.where(null[:, None], torch.zeros_like(data.data), data.data),
            torch.where(null, torch.zeros_like(data.lens), data.lens),
        )
    else:
        zeroed = torch.where(null, torch.zeros_like(data), data)
    return [zeroed, null]


_UNSIGNED_MASK = {torch.int16: 0xFFFF, torch.int32: 0xFFFFFFFF,
                  torch.uint8: 0xFF}


F32_NAN_BITS = 0x7FC00000
#: the narrowed x86 default NaN (``inf - inf``): an infinity's lo word
F32_DEFAULT_NAN_BITS = 0xFFC00000


def _f32_bits(x32: torch.Tensor) -> torch.Tensor:
    """A float32 tensor's bits as int64 in [0, 2^32)."""
    return x32.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _ftz_bits(bits: torch.Tensor) -> torch.Tensor:
    """float32 bits with a subnormal flushed to a zero of its sign."""
    return torch.where((bits & 0x7F800000) == 0, bits & 0x80000000, bits)


def daz(col: torch.Tensor) -> torch.Tensor:
    """A float column with subnormals read as +0.0 (the reference's
    compares run with denormals-are-zero)."""
    tiny = torch.finfo(col.dtype).tiny
    return torch.where(col.abs() < tiny, torch.zeros_like(col), col)


def float_key_words(col: torch.Tensor) -> list[torch.Tensor]:
    """A float32 or float64 key column as its int64 words (see the
    module docstring)."""
    if col.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(f"hash of {col.dtype} keys")
    nan = torch.isnan(col)
    col = daz(col)
    if col.dtype == torch.float32:
        return [torch.where(nan, F32_NAN_BITS, _f32_bits(col))]
    hi = _ftz_bits(_f32_bits(col.to(torch.float32)))
    hi_f = hi.to(torch.int32).view(torch.float32).to(torch.float64)
    lo = _ftz_bits(_f32_bits((col - hi_f).to(torch.float32)))
    lo = torch.where(torch.isinf(col), F32_DEFAULT_NAN_BITS, lo)
    return [torch.where(nan, F32_NAN_BITS, hi),
            torch.where(nan, F32_NAN_BITS, lo)]


def _key_words(col: torch.Tensor) -> list[torch.Tensor]:
    """One fixed-width key column as int64 words: bool -> 0/1, narrower
    ints zero-extended (the reference views them unsigned first), floats
    through ``float_key_words``."""
    if col.dtype == torch.bool:
        return [col.to(torch.int64)]
    if col.dtype == torch.int64:
        return [col]
    if col.dtype in _UNSIGNED_MASK:
        return [col.to(torch.int64) & _UNSIGNED_MASK[col.dtype]]
    return float_key_words(col)


def _fold_str(col: StrCol, state: torch.Tensor) -> torch.Tensor:
    cap, width = col.data.shape
    words = width // 8 + (1 if width % 8 else 0)
    padded = torch.zeros((cap, words * 8), dtype=torch.int64,
                         device=col.data.device)
    padded[:, :width] = col.data.to(torch.int64)
    byte_idx = torch.arange(words * 8, device=col.data.device)
    masked = torch.where(byte_idx[None, :] < col.lens[:, None].to(torch.int64),
                         padded, torch.zeros_like(padded))
    shifts = torch.arange(8, device=col.data.device, dtype=torch.int64) * 8
    w64 = masked.reshape(cap, words, 8) << shifts[None, None, :]
    folded = w64.sum(dim=-1)  # disjoint bytes: sum == or
    for k in range(words):
        state = mix64(state ^ (folded[:, k] * K1))
    return mix64(state ^ col.lens.to(torch.int64))


def hash64_columns_plain(columns: Sequence) -> torch.Tensor:
    """Plain PyTorch version of kernel A; int64 [cap] bit patterns."""
    return hash64_finish(hash64_partial(columns))


def _fold_plain(col, state: torch.Tensor | None) -> torch.Tensor:
    """Fold one normalized column into the mix state (seed 0)."""
    ref = col.lens if isinstance(col, StrCol) else col
    if state is None:
        state = torch.full(ref.shape[:1], K1, dtype=torch.int64,
                           device=ref.device)
    if isinstance(col, StrCol):
        return _fold_str(col, state)
    for w in _key_words(col):
        state = mix64(state ^ (w * K1))
    return state


def hash64_partial(columns: Sequence) -> torch.Tensor:
    """The unfinalized mix state after folding ``columns`` (int64 bit
    patterns).  ``hash64_finish(hash64_extend(hash64_partial([a]), b))``
    equals ``hash64_columns([a, b])``."""
    state = None
    for raw in columns:
        for col in normalize_null_col(raw):
            state = _fold_plain(col, state)
    if state is None:
        raise ValueError("no key columns")
    return state


def hash64_extend(state: torch.Tensor, col) -> torch.Tensor:
    """Fold one more column into a ``hash64_partial`` state."""
    for c in normalize_null_col(col):
        state = _fold_plain(c, state)
    return state


def hash64_finish(state: torch.Tensor) -> torch.Tensor:
    """Finalize a partial state: the all-ones remap of hash64_columns."""
    return torch.where(state == -1, torch.full_like(state, -2), state)


_FLOAT_KINDS = {torch.float32: kernels.KIND_F32,
                torch.float64: kernels.KIND_F64}


def key_leaves(columns: Sequence) -> list[tuple]:
    """Flatten key columns into fixed-width ``(data, null-or-None, kind)``
    leaves for the kernels' column descriptors: a ``StrCol`` becomes its
    ``[cap, w]`` bytes (``KIND_STR``) and its lens (``KIND_LENS``), both
    with the column's null plane; float32 and float64 columns are
    ``KIND_F32`` and ``KIND_F64``."""
    leaves = []
    for col in columns:
        data, null = (col.data, col.null) if isinstance(col, NCol) \
            else (col, None)
        if isinstance(data, StrCol):
            leaves += [(data.data, null, kernels.KIND_STR),
                       (data.lens, null, kernels.KIND_LENS)]
        elif data.dtype.is_floating_point:
            if data.dtype not in _FLOAT_KINDS:
                raise NotImplementedError(f"hash of {data.dtype} keys")
            leaves.append((data, null, _FLOAT_KINDS[data.dtype]))
        else:
            leaves.append((data, null, kernels.KIND_WORD))
    if not leaves:
        raise ValueError("no key columns")
    if len(leaves) > kernels.MAX_COLS:
        raise ValueError(f"more than {kernels.MAX_COLS} key leaves")
    return leaves


def leaf_width(t: torch.Tensor) -> int:
    """Bytes per row of a leaf (a ``[cap, w]`` byte matrix: ``w``)."""
    return t.element_size() * (t[0].numel() if t.dim() > 1 else 1)


def _null_u8(null: torch.Tensor | None) -> torch.Tensor | None:
    return None if null is None else null.contiguous().view(torch.uint8)


def hash64_columns_cuda(columns: Sequence, size: int | None = None):
    """Kernel A: (hashes int64 [cap], first slot int32 [cap] or None)."""
    leaves = key_leaves(columns)
    cols = kernels.RwCols()
    cols.n = len(leaves)
    tensors = []
    for k, (data, null, kind) in enumerate(leaves):
        data = data.contiguous()
        nu8 = _null_u8(null)
        tensors += [data] + ([nu8] if nu8 is not None else [])
        cols.width[k] = leaf_width(data)
        cols.in_data[k] = data.data_ptr()
        cols.in_null[k] = kernels.ptr(nu8)
        cols.kind[k] = kind
    kernels.require_cuda("hash64", *tensors)
    n = leaves[0][0].shape[0]
    dev = leaves[0][0].device
    out = torch.empty(n, dtype=torch.int64, device=dev)
    slot = None
    if size is not None:
        if size & (size - 1):
            raise ValueError(f"size {size} must be a power of two")
        slot = torch.empty(n, dtype=torch.int32, device=dev)
    fn = kernels.entry("hash64", "rw_hash64", [
        kernels.RwCols, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_ulonglong,
        ctypes.c_void_p])
    kernels.count_launch("hash64")
    rc = fn(cols, n, out.data_ptr(), kernels.ptr(slot),
            (size - 1) if size is not None else 0, kernels.stream_ptr(dev))
    kernels.check(rc, "hash64")
    return out, slot


def hash64_columns(columns: Sequence) -> torch.Tensor:
    """64-bit mix hash of key columns, int64 [cap] (uint64 bit pattern).

    CPU tensors take the plain version; CUDA tensors launch kernel A."""
    first = columns[0].data if isinstance(columns[0], NCol) else columns[0]
    first = first.lens if isinstance(first, StrCol) else first
    if first.device.type == "cuda":
        return hash64_columns_cuda(columns)[0]
    return hash64_columns_plain(columns)



#: Default number of virtual nodes (the reference's ``VNODE_COUNT`` :52)
VNODE_COUNT = 256

_CRC_POLY = 0xEDB88320
_crc_tables: dict = {}


def _crc32_table(device) -> torch.Tensor:
    """The reflected CRC32 table as int64 [256] on ``device``."""
    t = _crc_tables.get(device)
    if t is None:
        vals = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (_CRC_POLY ^ (c >> 1)) if c & 1 else (c >> 1)
            vals.append(c)
        t = torch.tensor(vals, dtype=torch.int64, device=device)
        _crc_tables[device] = t
    return t


def _crc_step(state: torch.Tensor, byte: torch.Tensor,
              table: torch.Tensor) -> torch.Tensor:
    """One byte into the CRC state (int64 in [0, 2^32))."""
    return (state >> 8) ^ table[(state ^ byte) & 0xFF]


#: bytes a row of an integer key feeds the CRC: the reference views the
#: column unsigned (a bool widened to int64 first)
_CRC_BYTES = {torch.bool: 8, torch.int64: 8, torch.int32: 4, torch.int16: 2,
              torch.uint8: 1}


def _crc_words(col: torch.Tensor) -> list[tuple[torch.Tensor, int]]:
    """(int64 word, bytes it feeds) per word of one fixed-width key."""
    if col.dtype.is_floating_point:
        return [(w, 4) for w in float_key_words(col)]
    if col.dtype not in _CRC_BYTES:
        raise NotImplementedError(f"vnode hash of {col.dtype} keys")
    return [(_key_words(col)[0], _CRC_BYTES[col.dtype])]


def crc32_columns_plain(columns: Sequence,
                        init: int = 0xFFFFFFFF) -> torch.Tensor:
    """CRC32 over the little-endian bytes of each row's (normalized) key
    columns, the reference's ``crc32_columns``; int64 [cap] in
    [0, 2^32).  A ``StrCol`` feeds its bytes below ``lens`` only."""
    state = None
    table = None
    for col in columns:
        ref = col.lens if isinstance(col, StrCol) else col
        if state is None:
            table = _crc32_table(ref.device)
            state = torch.full(ref.shape[:1], init, dtype=torch.int64,
                               device=ref.device)
        if isinstance(col, StrCol):
            lens = col.lens.to(torch.int64)
            data = col.data.to(torch.int64)
            for k in range(col.data.shape[1]):
                stepped = _crc_step(state, data[:, k], table)
                state = torch.where(k < lens, stepped, state)
            continue
        for w, nbytes in _crc_words(col):
            for k in range(nbytes):
                state = _crc_step(state, (w >> (8 * k)) & 0xFF, table)
    if state is None:
        raise ValueError("no key columns")
    return state ^ 0xFFFFFFFF


def compute_vnodes_plain(key_columns: Sequence,
                         vnode_count: int = VNODE_COUNT) -> torch.Tensor:
    """Plain PyTorch version of K2: ``crc32 % vnode_count``, int32 [cap];
    a nullable key hashes as [payload-with-nulls-zeroed, null flag]."""
    flat: list = []
    for c in key_columns:
        flat.extend(normalize_null_col(c))
    return (crc32_columns_plain(flat) % vnode_count).to(torch.int32)


class _CrcCols(ctypes.Structure):
    """Mirror of ``struct RwCrcCols`` in ``csrc/crc32.cu``."""

    _fields_ = [
        ("n", ctypes.c_int),
        ("width", ctypes.c_int * kernels.MAX_COLS),
        ("nbytes", ctypes.c_int * kernels.MAX_COLS),
        ("kind", ctypes.c_int * kernels.MAX_COLS),
        ("data", ctypes.c_void_p * kernels.MAX_COLS),
        ("null", ctypes.c_void_p * kernels.MAX_COLS),
    ]


def compute_vnodes_cuda(key_columns: Sequence,
                        vnode_count: int = VNODE_COUNT,
                        with_crc: bool = False):
    """K2: one launch; (vnodes int32 [cap], crc int64 [cap] or None)."""
    leaves = key_leaves(key_columns)
    cols = _CrcCols()
    cols.n = len(leaves)
    tensors = []
    for k, (data, null, kind) in enumerate(leaves):
        if kind == kernels.KIND_WORD and data.dtype not in _CRC_BYTES:
            raise NotImplementedError(f"vnode hash of {data.dtype} keys")
        data = data.contiguous()
        nu8 = _null_u8(null)
        tensors += [data] + ([nu8] if nu8 is not None else [])
        cols.width[k] = leaf_width(data)
        cols.nbytes[k] = _CRC_BYTES.get(data.dtype, 0)
        cols.kind[k] = kind
        cols.data[k] = data.data_ptr()
        cols.null[k] = kernels.ptr(nu8)
    kernels.require_cuda("crc32", *tensors)
    n = leaves[0][0].shape[0]
    dev = leaves[0][0].device
    vnodes = torch.empty(n, dtype=torch.int32, device=dev)
    crc = torch.empty(n, dtype=torch.int64, device=dev) if with_crc else None
    fn = kernels.entry("crc32", "rw_crc32_vnodes", [
        _CrcCols, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p])
    kernels.count_launch("crc32")
    kernels.check(fn(cols, n, vnode_count, kernels.ptr(crc),
                     vnodes.data_ptr(), kernels.stream_ptr(dev)), "crc32")
    return vnodes, crc


def crc32_columns(columns: Sequence) -> torch.Tensor:
    """CRC32 of each row's (normalized) key columns, int64 [cap] in
    [0, 2^32): K2 on CUDA tensors (a bool column, the null flag of a
    normalized key, feeds 8 bytes there too), the plain version on CPU
    tensors."""
    first = columns[0].lens if isinstance(columns[0], StrCol) else columns[0]
    if first.device.type == "cuda":
        return compute_vnodes_cuda(columns, with_crc=True)[1]
    return crc32_columns_plain(columns)


def compute_vnodes(key_columns: Sequence,
                   vnode_count: int = VNODE_COUNT) -> torch.Tensor:
    """vnode = crc32(distribution key) % ``vnode_count``, int32 [cap]:
    K2 on CUDA tensors, the plain version on CPU tensors."""
    first = key_columns[0].data if isinstance(key_columns[0], NCol) \
        else key_columns[0]
    first = first.lens if isinstance(first, StrCol) else first
    if first.device.type == "cuda":
        return compute_vnodes_cuda(key_columns, vnode_count)[0]
    return compute_vnodes_plain(key_columns, vnode_count)
