"""Typed corruption errors, crc32c and quarantine notes.

The part of ``risingwave_tpu/storage/integrity.py`` the checkpoint
store uses: ``IntegrityError``, ``CheckpointCorruption``, ``crc32c``,
``quarantine`` and ``record_integrity_error``, plus
``verify_checkpoint_store`` for ``CheckpointStore.verify_job``.  The SST
verifiers wait for the port's storage layer.

``crc32c`` must equal the reference's (``storage/codec.py:203``, the
reflected Castagnoli CRC).  With ``native=True`` it runs the port's own
copy of the C routine (``csrc/crc32c.cpp``, built like the kernels):
the store takes it whenever its engine runs on the card.  The plain
version below (the same table, lane-parallel in numpy for large
buffers) serves the CPU tests only.
"""

from __future__ import annotations

import functools
import json
import time

import numpy as np

QUARANTINE_PREFIX = "quarantine/"


class IntegrityError(Exception):
    """Base of the corruption taxonomy; ``key`` names the object."""

    kind = "integrity"

    def __init__(self, message: str, *, key: str = ""):
        super().__init__(message)
        self.key = key


class CheckpointCorruption(IntegrityError):
    """A checkpoint epoch object's bytes mismatch the crc recorded in
    the checkpoint manifest."""

    kind = "checkpoint"


def _table() -> list[int]:
    out = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (0x82F63B78 ^ (c >> 1)) if c & 1 else (c >> 1)
        out.append(c)
    return out


_TABLE = _table()
_TABLE_NP = np.array(_TABLE, dtype=np.uint32)
#: bytes per lane of the lane-parallel plain crc
_LANE = 8192


def _crc_bytes(c: int, data: bytes) -> int:
    """The raw CRC register after ``data`` from register ``c``."""
    table = _TABLE
    for b in data:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c


@functools.lru_cache(maxsize=4)
def _zeros_operator(n: int) -> tuple[int, ...]:
    """Images of the 32 register bits after ``n`` zero bytes (the CRC
    register update is linear over GF(2))."""
    regs = np.array([1 << j for j in range(32)], dtype=np.uint32)
    for _ in range(n):
        regs = _TABLE_NP[regs & 0xFF] ^ (regs >> 8)
    return tuple(int(r) for r in regs)


def crc32c_plain(data) -> int:
    """crc32c in Python and numpy (the CPU tests' version).  A large
    buffer is cut into lanes of ``_LANE`` bytes whose raw CRCs advance
    together, one byte of every lane per numpy step; they then combine
    in order, since the register after a lane is the register carried
    into it shifted over the lane's zero bytes, xor the lane's own raw
    CRC."""
    buf = np.frombuffer(bytes(data), dtype=np.uint8)
    n_lanes = buf.size // _LANE
    if n_lanes < 8:
        return _crc_bytes(0xFFFFFFFF, buf.tobytes()) ^ 0xFFFFFFFF
    cols = np.ascontiguousarray(
        buf[:n_lanes * _LANE].reshape(n_lanes, _LANE).T)
    regs = np.zeros(n_lanes, dtype=np.uint32)
    for j in range(_LANE):
        regs = _TABLE_NP[(regs ^ cols[j]) & 0xFF] ^ (regs >> 8)
    shift = _zeros_operator(_LANE)
    c = 0xFFFFFFFF
    for r in regs.tolist():
        x = 0
        for j in range(32):
            if c >> j & 1:
                x ^= shift[j]
        c = x ^ r
    c = _crc_bytes(c, buf[n_lanes * _LANE:].tobytes())
    return c ^ 0xFFFFFFFF


def crc32c(data, native: bool = False) -> int:
    if native:
        from risingwave_tpu_torch import kernels

        return kernels.crc32c(data)
    return crc32c_plain(data)


def quarantine_key(object_key: str) -> str:
    return QUARANTINE_PREFIX + object_key.replace("/", "__") + ".json"


def quarantine(store, object_key: str, reason: str, by: str = "",
               metrics=None) -> bool:
    """Write one durable quarantine note for ``object_key`` (the first
    detection wins); True when this call wrote it."""
    qk = quarantine_key(object_key)
    fresh = not store.exists(qk)
    if fresh:
        store.put(qk, json.dumps({"key": object_key, "reason": reason,
                                  "by": by, "at": time.time()}).encode())
    if metrics is not None:
        metrics.set_gauge("quarantined_objects",
                          len(store.list(QUARANTINE_PREFIX)))
    return fresh


def record_integrity_error(metrics, err: IntegrityError) -> None:
    if metrics is not None:
        metrics.inc("integrity_errors_total", kind=err.kind)


def verify_checkpoint_store(store, manifest_key: str = "MANIFEST.json",
                            jobs=None, native: bool = False) -> dict:
    """Every retained checkpoint epoch object against the crcs the
    manifest records (bytes and crc only).  Returns ``{"verified": n,
    "corrupt": [(job, epoch, key)], "skipped": n}``."""
    report = {"verified": 0, "corrupt": [], "skipped": 0}
    if not store.exists(manifest_key):
        return report
    m = json.loads(store.get(manifest_key))
    for job_name, job in m.get("jobs", {}).items():
        if jobs is not None and job_name not in jobs:
            continue
        crcs = job.get("crc", {})
        for epoch in job.get("epochs", []):
            rec = crcs.get(str(epoch))
            if rec is None:
                report["skipped"] += 1
                continue
            for suffix in ("npz", "meta"):
                key = f"{job_name}/epoch_{epoch}.{suffix}"
                try:
                    data = store.get(key)
                except Exception:  # noqa: BLE001 — missing = corrupt chain
                    report["corrupt"].append((job_name, epoch, key))
                    continue
                if crc32c(data, native) != int(rec[suffix]):
                    report["corrupt"].append((job_name, epoch, key))
                else:
                    report["verified"] += 1
    return report
