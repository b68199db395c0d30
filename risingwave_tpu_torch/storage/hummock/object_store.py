"""Object-store seam under the checkpoint store.

A copy of ``risingwave_tpu/storage/hummock/object_store.py`` without
the process-global fault fabric and the corrupting fault modes: the
``ObjectStore`` interface, the dict-backed ``InMemObjectStore`` the
tests use and the filesystem ``LocalFsObjectStore`` (atomic put through
a temporary file and a rename), with the per-store deterministic fault
schedule ``StoreFaults`` (the Nth matching put/get/delete raises
``ObjectError``, before the operation lands or after).  It imports no
JAX; the port keeps its own copy instead of importing the reference.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field


class ObjectError(IOError):
    """An object-store operation failed (injected or real)."""


@dataclass
class _FaultRule:
    op: str               # "put" | "get" | "delete"
    substr: str           # only keys containing this match
    after: int            # skip this many matching ops first
    mode: str             # "before" (op lost) | "after" (op durable)
    times: int            # how many firings before the rule retires
    hits: int = 0
    seen: int = 0


@dataclass
class StoreFaults:
    """Injectable error schedule shared by both stores."""

    rules: list[_FaultRule] = field(default_factory=list)
    injected_errors: int = 0

    def fail(self, op: str, substr: str = "", after: int = 0,
             mode: str = "before", times: int = 1) -> None:
        """Arm one deterministic failure: the ``after``-th matching op
        (0-based) raises ``ObjectError``; with ``mode='after'`` the
        store mutation still lands first (crash-after-upload)."""
        assert op in ("put", "get", "delete") \
            and mode in ("before", "after")
        self.rules.append(_FaultRule(op, substr, after, mode, times))

    def _match(self, op: str, key: str) -> "_FaultRule | None":
        for r in self.rules:
            if r.op != op or r.substr not in key or r.hits >= r.times:
                continue
            r.seen += 1
            if r.seen > r.after:
                r.hits += 1
                return r
        return None

    def before(self, op: str, key: str) -> "_FaultRule | None":
        r = self._match(op, key)
        if r is not None and r.mode == "before":
            self.injected_errors += 1
            raise ObjectError(f"injected {op} fault (lost): {key}")
        return r

    def after(self, rule: "_FaultRule | None", op: str, key: str) -> None:
        if rule is not None and rule.mode == "after":
            self.injected_errors += 1
            raise ObjectError(f"injected {op} fault (durable): {key}")


class ObjectStore:
    """Key -> immutable bytes.  ``put`` is atomic (no torn reads)."""

    faults: StoreFaults | None = None

    def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    def get(self, key: str) -> bytes:
        raise NotImplementedError

    def delete(self, key: str) -> None:
        raise NotImplementedError

    def exists(self, key: str) -> bool:
        raise NotImplementedError

    def list(self, prefix: str = "") -> list[str]:
        raise NotImplementedError

    def size(self, key: str) -> int:
        raise NotImplementedError

    def _pre(self, op: str, key: str):
        return self.faults.before(op, key) if self.faults else None

    def _post(self, rule, op: str, key: str) -> None:
        if self.faults:
            self.faults.after(rule, op, key)


class InMemObjectStore(ObjectStore):
    """Dict-backed store for tests."""

    def __init__(self, faults: StoreFaults | None = None):
        self._d: dict[str, bytes] = {}
        self._lock = threading.Lock()
        self.faults = faults

    def put(self, key: str, data: bytes) -> None:
        rule = self._pre("put", key)
        with self._lock:
            self._d[key] = bytes(data)
        self._post(rule, "put", key)

    def get(self, key: str) -> bytes:
        rule = self._pre("get", key)
        with self._lock:
            if key not in self._d:
                raise ObjectError(f"no such object: {key}")
            data = self._d[key]
        self._post(rule, "get", key)
        return data

    def delete(self, key: str) -> None:
        rule = self._pre("delete", key)
        with self._lock:
            self._d.pop(key, None)
        self._post(rule, "delete", key)

    def exists(self, key: str) -> bool:
        with self._lock:
            return key in self._d

    def list(self, prefix: str = "") -> list[str]:
        with self._lock:
            return sorted(k for k in self._d if k.startswith(prefix))

    def size(self, key: str) -> int:
        with self._lock:
            if key not in self._d:
                raise ObjectError(f"no such object: {key}")
            return len(self._d[key])


class LocalFsObjectStore(ObjectStore):
    """Filesystem-backed store; atomic put via tmp + rename."""

    def __init__(self, root: str, faults: StoreFaults | None = None):
        self.root = root
        self.faults = faults
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        assert ".." not in key.split("/"), key
        return os.path.join(self.root, key)

    def put(self, key: str, data: bytes) -> None:
        rule = self._pre("put", key)
        path = self._path(key)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)
        self._post(rule, "put", key)

    def get(self, key: str) -> bytes:
        rule = self._pre("get", key)
        try:
            with open(self._path(key), "rb") as f:
                data = f.read()
        except FileNotFoundError as e:
            raise ObjectError(f"no such object: {key}") from e
        self._post(rule, "get", key)
        return data

    def delete(self, key: str) -> None:
        rule = self._pre("delete", key)
        try:
            os.remove(self._path(key))
        except FileNotFoundError:
            pass
        self._post(rule, "delete", key)

    def exists(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def list(self, prefix: str = "") -> list[str]:
        out = []
        for dirpath, _, files in os.walk(self.root):
            rel = os.path.relpath(dirpath, self.root)
            rel = "" if rel == "." else rel + "/"
            for name in files:
                if name.endswith(".tmp"):
                    continue  # torn put, never visible
                key = rel + name
                if key.startswith(prefix):
                    out.append(key)
        return sorted(out)

    def size(self, key: str) -> int:
        try:
            return os.path.getsize(self._path(key))
        except FileNotFoundError as e:
            raise ObjectError(f"no such object: {key}") from e
