"""External storage abstraction for backup artifacts.

Counterpart of tidb_tpu/storage/external.py.

Reference: br/pkg/storage's ExternalStorage interface (local/S3/GCS/azure
backends behind WriteFile/ReadFile/WalkDir). Backups address a storage
by URI; the engine never touches the filesystem directly, so a cloud
backend is one subclass away — the `memory://` backend stands in for
object stores in tests and demonstrates the non-POSIX contract:
no partial writes, no rename, list-by-prefix only.

URIs: `local:///abs/path` or a bare path -> LocalStorage;
`memory://bucket` -> a process-global in-memory bucket.
"""

from __future__ import annotations

import io
import os
from typing import Dict, List

from tidb_tpu_torch.utils import racecheck


class ExternalStorage:
    """Flat object namespace: names are /-separated keys."""

    def write_file(self, name: str, data: bytes) -> None:
        raise NotImplementedError

    def read_file(self, name: str) -> bytes:
        raise NotImplementedError

    def exists(self, name: str) -> bool:
        raise NotImplementedError

    def list(self, prefix: str = "") -> List[str]:
        raise NotImplementedError

    def delete(self, name: str) -> None:
        raise NotImplementedError

    # numpy convenience (the npz segment/backup format)
    def write_npz(self, name: str, **arrays) -> None:
        import numpy as np

        buf = io.BytesIO()
        np.savez_compressed(buf, **arrays)
        self.write_file(name, buf.getvalue())

    def read_npz(self, name: str):
        import numpy as np

        return np.load(io.BytesIO(self.read_file(name)))


class LocalStorage(ExternalStorage):
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _p(self, name: str) -> str:
        p = os.path.normpath(os.path.join(self.root, name))
        root = os.path.normpath(self.root)
        # commonpath, not startswith: '/data/bk-x' startswith '/data/bk'
        if os.path.commonpath([p, root]) != root:
            raise ValueError(f"path escapes storage root: {name!r}")
        return p

    def write_file(self, name: str, data: bytes) -> None:
        p = self._p(name)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        tmp = p + ".tmp"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, p)  # atomic publish: readers never see partials

    def read_file(self, name: str) -> bytes:
        with open(self._p(name), "rb") as f:
            return f.read()

    def exists(self, name: str) -> bool:
        return os.path.exists(self._p(name))

    def list(self, prefix: str = "") -> List[str]:
        out = []
        for dirpath, _dirs, files in os.walk(self.root):
            for fn in files:
                if fn.endswith(".tmp"):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, fn), self.root)
                rel = rel.replace(os.sep, "/")
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)

    def delete(self, name: str) -> None:
        if self.exists(name):
            os.remove(self._p(name))


_MEM_BUCKETS: Dict[str, Dict[str, bytes]] = {}
_MEM_LOCK = racecheck.make_lock("storage.external")


class MemStorage(ExternalStorage):
    """Process-global in-memory bucket: the object-store stand-in. The
    whole-object write/read contract matches S3 semantics (no appends,
    last write wins, list by prefix)."""

    def __init__(self, bucket: str):
        with _MEM_LOCK:
            self._store = _MEM_BUCKETS.setdefault(bucket, {})

    def write_file(self, name: str, data: bytes) -> None:
        with _MEM_LOCK:
            self._store[name] = bytes(data)

    def read_file(self, name: str) -> bytes:
        with _MEM_LOCK:
            if name not in self._store:
                raise FileNotFoundError(name)
            return self._store[name]

    def exists(self, name: str) -> bool:
        with _MEM_LOCK:
            return name in self._store

    def list(self, prefix: str = "") -> List[str]:
        with _MEM_LOCK:
            return sorted(k for k in self._store if k.startswith(prefix))

    def delete(self, name: str) -> None:
        with _MEM_LOCK:
            self._store.pop(name, None)


def open_storage(uri: str) -> ExternalStorage:
    """URI -> backend. Bare paths mean local (the br CLI default)."""
    if uri.startswith("memory://"):
        return MemStorage(uri[len("memory://"):])
    if uri.startswith("local://"):
        return LocalStorage(uri[len("local://"):])
    if "://" in uri:
        scheme = uri.split("://", 1)[0]
        raise ValueError(
            f"unsupported storage scheme {scheme!r} (supported: local, memory)"
        )
    return LocalStorage(uri)
