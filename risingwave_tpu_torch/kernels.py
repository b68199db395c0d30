"""Build, load and count the hand-written CUDA kernels.

The sources live in ``risingwave_tpu_torch/csrc``: one ``.cu`` file per
kernel plus the shared headers ``rw_common.cuh``, ``rw_join.cuh``,
``nexmark_common.cuh``, ``rw_str.cuh`` (the string kernels' row readers
and writers and their greedy match walk), ``rw_cal.cuh`` (the calendar
of ``to_char.cu`` and ``calendar.cu``), ``rw_probe.cuh`` (the probe
walk of ``probe.cu`` and ``temporal_probe.cu``), ``rw_bucket.cuh`` (the
bucket multi-map's annihilation and walk, of ``join_dense.cu`` and
``agg_minput.cu``), ``rw_compact.cuh`` (the mask compaction of
``compact.cu``, ``agg_eowc.cu`` and ``sink_ring.cu``) and ``rw_claim.cuh``
(the claim rounds' scratch layout and helpers, of ``probe.cu`` and
``tag_probe.cu``), and one host routine,
``crc32c.cpp`` (the checkpoint store's checksum, ``crc32c``).  Each
source compiles with ``nvcc`` into its own shared library with a plain
C interface, named by a hash of its source, the headers and the flags,
under ``build/kernels`` at the root of the checkout.  All missing
libraries build at once (one ``nvcc`` process per source), at first
use.  The wrappers call the C entry points through ``ctypes``: tensors
pass as ``data_ptr()`` integers, the stream is PyTorch's current
stream, and every entry returns ``cudaGetLastError()``, which
``check`` turns into an exception.

``KERNELS`` names each kernel entry point with the source it is built
from (``compact.cu``, ``nexmark_events.cu``, ``tag_probe.cu``,
``str_cmp.cu`` and ``agg_minput.cu`` hold two each, ``shadow_digest.cu``
four: K11 and its lane grid; ``topn_band.cu``,
``topn_flush.cu``, ``join_dense.cu``, ``dyn_filter.cu`` and
``str_match.cu`` two C entries each, all counted), and ``LAUNCHES``
counts, per kernel, the
wrapper calls that launched it on the card.  Nothing here runs at
import time: a CPU-only process imports the package without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
HEADERS = ("rw_common.cuh", "rw_join.cuh", "nexmark_common.cuh",
           "rw_str.cuh", "rw_cal.cuh", "rw_probe.cuh", "rw_bucket.cuh",
           "rw_compact.cuh", "rw_claim.cuh", "rw_rowcopy.cuh")
#: library name -> source file
SOURCES = {
    "hash64": "hash64.cu",
    "probe": "probe.cu",
    "agg_scatter": "agg_scatter.cu",
    "mv_upsert": "mv_upsert.cu",
    "agg_preagg": "agg_preagg.cu",
    "compact": "compact.cu",
    "nexmark_bids": "nexmark_bids.cu",
    "hop_window": "hop_window.cu",
    "nexmark_events": "nexmark_events.cu",
    "tag_probe": "tag_probe.cu",
    "join_update": "join_update.cu",
    "join_emit": "join_emit.cu",
    "join_clean": "join_clean.cu",
    "shadow_digest": "shadow_digest.cu",
    "permute": "permute.cu",
    "topn_pool": "topn_pool.cu",
    "topn_band": "topn_band.cu",
    "topn_flush": "topn_flush.cu",
    "topn_clean": "topn_clean.cu",
    "over_window": "over_window.cu",
    "join_dense": "join_dense.cu",
    "agg_spill": "agg_spill.cu",
    "table_sweep": "table_sweep.cu",
    "agg_distinct": "agg_distinct.cu",
    "dyn_filter": "dyn_filter.cu",
    "str_split": "str_split.cu",
    "to_char": "to_char.cu",
    "str_regexp": "str_regexp.cu",
    "str_cmp": "str_cmp.cu",
    "temporal_probe": "temporal_probe.cu",
    "str_replace": "str_replace.cu",
    "str_match": "str_match.cu",
    "str_window": "str_window.cu",
    "calendar": "calendar.cu",
    "agg_minput": "agg_minput.cu",
    "agg_eowc": "agg_eowc.cu",
    "sink_ring": "sink_ring.cu",
    "crc32": "crc32.cu",
    "exchange": "exchange.cu",
    "partial_agg": "partial_agg.cu",
    "vnode_gate": "vnode_gate.cu",
    "vnode_sweep": "vnode_sweep.cu",
    "vnode_transplant": "vnode_transplant.cu",
    "troublemaker": "troublemaker.cu",
    # a host routine (the checkpoint store's crc32c), no kernel
    "crc32c": "crc32c.cpp",
}
#: kernel (one wrapper, one launch counter) -> library it lives in
KERNELS = {
    "hash64": "hash64",
    "probe": "probe",
    "agg_scatter": "agg_scatter",
    "mv_upsert": "mv_upsert",
    "agg_preagg": "agg_preagg",
    "mask_indices": "compact",
    "ring_append": "compact",
    "nexmark_bids": "nexmark_bids",
    "hop_window": "hop_window",
    "nexmark_auctions": "nexmark_events",
    "nexmark_persons": "nexmark_events",
    "tag_insert_ranked": "tag_probe",
    "tag_probe": "tag_probe",
    "join_update": "join_update",
    "join_emit": "join_emit",
    "join_clean": "join_clean",
    "shadow_digest": "shadow_digest",
    "dirty_gather": "shadow_digest",
    # K11 lanes: the same kernels over a lane-stacked tree's row grid
    "shadow_digest_lanes": "shadow_digest",
    "dirty_gather_lanes": "shadow_digest",
    "permute_rows": "permute",
    "topn_pool": "topn_pool",
    "topn_band": "topn_band",
    "topn_flush": "topn_flush",
    "topn_clean": "topn_clean",
    "over_window": "over_window",
    "join_dense": "join_dense",
    "agg_spill": "agg_spill",
    "table_sweep": "table_sweep",
    "agg_distinct": "agg_distinct",
    "dyn_filter": "dyn_filter",
    "str_split_part": "str_split",
    "to_char": "to_char",
    "regexp_group": "str_regexp",
    "str_cmp": "str_cmp",
    "str_case_map": "str_cmp",
    "temporal_probe": "temporal_probe",
    "str_replace": "str_replace",
    "str_match": "str_match",
    "str_window": "str_window",
    "calendar": "calendar",
    "agg_minput": "agg_minput",
    "minput_refresh": "agg_minput",
    "agg_eowc": "agg_eowc",
    "sink_ring": "sink_ring",
    "crc32": "crc32",
    "exchange": "exchange",
    "partial_agg": "partial_agg",
    "vnode_gate": "vnode_gate",
    "vnode_sweep": "vnode_sweep",
    "vnode_transplant": "vnode_transplant",
    "troublemaker": "troublemaker",
}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

#: wrapper launches per kernel (reset with ``reset_launches``)
LAUNCHES = {name: 0 for name in KERNELS}

#: max columns in one column descriptor (``RW_MAX_COLS`` in the header)
MAX_COLS = 16
#: column kinds of a descriptor (``RW_KIND_*`` in the header)
KIND_WORD, KIND_STR, KIND_LENS, KIND_F32, KIND_F64 = 0, 1, 2, 3, 4

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


class RwCols(ctypes.Structure):
    """Mirror of ``struct RwCols`` in ``rw_common.cuh``: up to
    ``MAX_COLS`` fixed-width columns, each with an input side, a store
    side, optional null planes (uint8) and a kind for the hash and the
    key compare (``KIND_STR`` on a string's bytes, ``KIND_LENS`` on its
    lengths, ``KIND_F32`` / ``KIND_F64`` on floats)."""

    _fields_ = [
        ("n", ctypes.c_int),
        ("width", ctypes.c_int * MAX_COLS),
        ("in_data", ctypes.c_void_p * MAX_COLS),
        ("in_null", ctypes.c_void_p * MAX_COLS),
        ("st_data", ctypes.c_void_p * MAX_COLS),
        ("st_null", ctypes.c_void_p * MAX_COLS),
        ("kind", ctypes.c_int * MAX_COLS),
    ]


#: most leaves one join descriptor holds (``RW_JOIN_LEAVES``)
MAX_JOIN_LEAVES = 32


class JoinCols(ctypes.Structure):
    """Mirror of ``struct JoinCols`` in ``rw_join.cuh``: up to
    ``MAX_JOIN_LEAVES`` fixed-width leaves (payloads, a string's bytes
    and lengths, null planes), each moved from ``src`` to ``dst``;
    ``from_probe`` and ``pad`` are read by the join's emission only."""

    _fields_ = [
        ("n", ctypes.c_int),
        ("width", ctypes.c_int * MAX_JOIN_LEAVES),
        ("from_probe", ctypes.c_int * MAX_JOIN_LEAVES),
        ("pad", ctypes.c_int * MAX_JOIN_LEAVES),
        ("src", ctypes.c_void_p * MAX_JOIN_LEAVES),
        ("dst", ctypes.c_void_p * MAX_JOIN_LEAVES),
    ]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or NVCC)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in (SOURCES[name],) + HEADERS:
        h.update((CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(verbose: bool = False) -> float:
    """Compile every kernel library that is not built yet, all in
    parallel; returns the seconds spent.  Raises with nvcc's output on
    failure."""
    todo = [n for n in SOURCES if not _lib_path(n).exists()]
    t0 = time.perf_counter()
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = []
        for name in todo:
            out = _lib_path(name)
            tmp = Path(f"{out}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC),
                   "-o", str(tmp), str(CSRC / SOURCES[name])]
            procs.append((name, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for name, out, tmp, p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                errors.append(f"{name}: nvcc exit {p.returncode}\n{log}")
                continue
            os.replace(tmp, out)
            if verbose:
                print(f"[build] {name}:\n{log.strip()}")
        if errors:
            raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library ``name`` of ``SOURCES`` (built on first
    use)."""
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                build_all()
                lib = ctypes.CDLL(str(_lib_path(name)))
                _libs[name] = lib
    return lib


def entry(name: str, symbol: str, argtypes: list):
    """A C entry point of kernel ``name`` with its ctypes signature."""
    fn = getattr(library(KERNELS[name]), symbol)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def crc32c(data) -> int:
    """crc32c of a bytes-like object through ``csrc/crc32c.cpp``."""
    lib = library("crc32c")
    fn = lib.rw_crc32c
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_char_p, ctypes.c_longlong]
        fn.restype = ctypes.c_uint32
    buf = bytes(data) if not isinstance(data, bytes) else data
    return int(fn(buf, len(buf)))


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def lookback_scratch(cache: dict, dev: torch.device, n: int, epochs: int,
                     make) -> tuple:
    """The scratch of a look-back kernel, cached in ``cache`` per (device,
    stream): two calls on different streams could overlap.  ``make(size,
    dev)`` builds its tensors for ``size`` (a power of two, at least
    ``n``) with their status words zeroed and their tickets at rest; the
    kernel tags the words with the call's epoch, so no call resets them.
    The scratch is built anew, larger, when ``n`` outgrows it, and zeroed
    before the epoch reaches ``epochs``.  Returns (the tensors, this call's
    epoch)."""
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    key = (dev, stream_ptr(dev))
    e = cache.get(key)
    if e is None or e[0] < n or e[2] + 1 >= epochs:
        size = 1 << max(n - 1, 0).bit_length()
        if e is not None:
            size = max(size, e[0])
        e = [size, make(size, dev), 0]
        cache[key] = e
    e[2] += 1
    return e[1], e[2]


def check(rc: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a launch."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {rc})")


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Check that every tensor is a contiguous CUDA tensor on one card."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{name}: tensors must share one CUDA device "
                             f"(got {t.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")


def ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()
