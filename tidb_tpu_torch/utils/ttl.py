"""TTL table expiry.

Counterpart of tidb_tpu/utils/ttl.py. Reference: pkg/ttl, the scan and
delete job manager over TTL-attributed tables (ttlworker/job_manager.go,
scan.go, del.go). A sweep compares each TTL table's column with
NOW() - INTERVAL on the host (numpy over the blocks: expiry is data
management, not device work) and drops the expired rows in one step
(``Table.purge_expired``). A month is 30 days, as in the JAX package.

Where the JAX package clears the whole scan cache after a purge, the port
drops only the purged table's cached columns (``scan.invalidate``): the
cache keys by version, and a global clear would copy every other table's
columns to the card again. It does so under the device's statement lock,
since statements read the cache. Purged rows count in
``tidbtpu_ttl_expired_rows_total``, failed sweeps of a table in
``tidbtpu_ttl_errors_total``.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from tidb_tpu_torch.chunk import resolve_device
from tidb_tpu_torch.dtypes import US_PER_SECOND, Kind
from tidb_tpu_torch.storage import scan as _scan
from tidb_tpu_torch.utils import racecheck
from tidb_tpu_torch.utils.metrics import REGISTRY

_log = logging.getLogger(__name__)

_UNIT_SECONDS = {
    "second": 1,
    "minute": 60,
    "hour": 3600,
    "day": 86400,
    "week": 7 * 86400,
    "month": 30 * 86400,
}


def expire_table(table, now_unix: Optional[float] = None, device=None) -> int:
    """Delete the rows whose TTL column is older than now - interval
    (NULLs never expire). `device`: whose statement lock guards the scan
    cache (CUDA unless named). Returns the number of rows removed."""
    if table.ttl is None:
        return 0
    col, iv, unit = table.ttl
    now_unix = time.time() if now_unix is None else now_unix
    cutoff_s = now_unix - iv * _UNIT_SECONDS[unit]
    typ = table.schema.types.get(col)
    if typ is None:
        return 0
    if typ.kind == Kind.DATE:
        cutoff = int(cutoff_s // 86400)
    elif typ.kind == Kind.DATETIME:
        cutoff = int(cutoff_s * US_PER_SECOND)
    else:
        return 0
    removed = table.purge_expired(col, cutoff)
    if removed:
        from tidb_tpu_torch.session.session import statement_lock

        with statement_lock(resolve_device(device)):
            _scan.invalidate(table)
        REGISTRY.counter("tidbtpu_ttl_expired_rows_total", "rows purged by TTL").inc(removed)
    return removed


class TTLWorker:
    """Background expiry sweep over a catalog (the pkg/ttl job manager)."""

    def __init__(self, catalog, interval_s: float = 60.0, device=None):
        self.catalog = catalog
        self.interval_s = interval_s
        self.device = resolve_device(device)
        self._stop = threading.Event()
        self._guard = racecheck.make_lock("ttl.worker")
        self._thread: Optional[threading.Thread] = None

    def tick(self, now_unix: Optional[float] = None) -> int:
        """One sweep of every user table; returns the rows removed. A
        table dropped mid-sweep is skipped; one whose purge raises is
        logged and skipped."""
        n = 0
        for db in list(self.catalog.databases()):
            if db.startswith("_") or db == "information_schema":
                continue
            for name in list(self.catalog.tables(db)):
                try:
                    t = self.catalog.table(db, name)
                except (KeyError, ValueError):
                    continue
                try:
                    n += expire_table(t, now_unix, self.device)
                except Exception:
                    # one table's failure must not end the sweep or the loop
                    _log.exception("TTL expiry of %s.%s failed", db, name)
                    REGISTRY.counter("tidbtpu_ttl_errors_total", "failed TTL sweeps").inc()
        return n

    def start(self) -> None:
        """Start the sweep loop (once; again after ``stop``). The thread is
        published only once it runs, so a concurrent ``stop`` joins a
        started thread or finds none."""
        with self._guard:
            if self._thread is not None:
                return
            self._stop.clear()

            def loop():
                while not self._stop.wait(self.interval_s):
                    self.tick()

            th = threading.Thread(target=loop, name="ttl-worker", daemon=True)
            th.start()
            self._thread = th

    def stop(self) -> None:
        with self._guard:
            self._stop.set()
            th, self._thread = self._thread, None
        if th is not None:
            th.join(timeout=5)
