"""Auto-analyze: at the statement boundary and in the background.

Counterpart of tidb_tpu/stats/handle.py. After a committed DML statement
the session re-analyzes a table whose rows changed since its last
ANALYZE by more than ``tidb_auto_analyze_ratio`` of its size
(``maybe_auto_analyze``; reference: pkg/statistics/handle/autoanalyze).
Without it the two packages' statistics, and so their join orders, drift
apart after writes. ``StatsHandle`` is the background worker (the
reference's stats owner loop): each tick sweeps the catalog with the
same rule, honouring the global ``tidb_enable_auto_analyze`` and
``tidb_auto_analyze_ratio``. Its ANALYZE runs on the card from the
worker's thread, so each one holds the device's statement lock: the port
runs one statement's device work at a time per device. Each automatic
ANALYZE counts in ``tidbtpu_stats_auto_analyze_total``.
"""

from __future__ import annotations

import logging
import threading
from typing import Optional

from tidb_tpu_torch.chunk import resolve_device
from tidb_tpu_torch.stats.collect import analyze_table
from tidb_tpu_torch.utils import racecheck
from tidb_tpu_torch.utils.metrics import REGISTRY

_log = logging.getLogger(__name__)

#: tables smaller than this are not auto-analyzed before a first ANALYZE
MIN_AUTO_ANALYZE_ROWS = 64


def needs_analyze(table, ratio: float) -> bool:
    changed = table.modify_count - table.analyzed_modify
    if changed <= 0:
        return False
    if not table.stats:
        # never analyzed: wait for a non-trivial table
        return table.nrows >= MIN_AUTO_ANALYZE_ROWS
    # analyzed before: refresh whenever the ratio trips, shrinking to
    # empty included
    return changed > ratio * max(table.nrows, 1)


def maybe_auto_analyze(table, ratio: float = 0.5, device=None) -> bool:
    """Analyze `table` on `device` if its modify ratio crossed the
    threshold. Returns True when an analyze ran."""
    if not needs_analyze(table, ratio):
        return False
    analyze_table(table, device=device)
    REGISTRY.counter("tidbtpu_stats_auto_analyze_total", "auto-analyze runs").inc()
    return True


class StatsHandle:
    """Background auto-analyze worker over a catalog. Start one per
    process; ``stop`` on shutdown. Runs its ANALYZEs on `device` (CUDA
    unless named)."""

    def __init__(self, catalog, interval_s: float = 30.0, ratio: float = 0.5, device=None):
        self.catalog = catalog
        self.interval_s = interval_s
        self.ratio = ratio
        self.device = resolve_device(device)
        self._stop = threading.Event()
        self._guard = racecheck.make_lock("stats.handle")
        self._thread: Optional[threading.Thread] = None

    def _sysvar(self, name, default):
        v = (getattr(self.catalog, "global_sysvars", None) or {}).get(name)
        return default if v is None else v

    def tick(self) -> int:
        """One sweep; returns the number of tables analyzed. A table
        dropped mid-sweep is skipped; one whose ANALYZE raises is logged
        and skipped."""
        from tidb_tpu_torch.session.session import statement_lock

        enabled = self._sysvar("tidb_enable_auto_analyze", True)
        if not enabled or str(enabled) in ("0", "OFF", "False"):
            return 0
        try:
            ratio = float(self._sysvar("tidb_auto_analyze_ratio", self.ratio))
        except (TypeError, ValueError):
            ratio = self.ratio
        n = 0
        for db in list(self.catalog.databases()):
            if db.startswith("_") or db == "information_schema":
                continue
            for name in list(self.catalog.tables(db)):
                try:
                    t = self.catalog.table(db, name)
                except (KeyError, ValueError):
                    continue
                if not needs_analyze(t, ratio):
                    continue
                try:
                    with statement_lock(self.device):
                        if maybe_auto_analyze(t, ratio, device=self.device):
                            n += 1
                except Exception:
                    # one table's failure (the card out of memory, a column
                    # dropped under the pass) must not end the sweep or the
                    # loop: the other tables go on, this one comes again
                    _log.exception("auto-analyze of %s.%s failed", db, name)
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

            th = threading.Thread(target=loop, name="stats-auto-analyze", daemon=True)
            th.start()
            self._thread = th

    def stop(self) -> None:
        with self._guard:
            self._stop.set()
            th, self._thread = self._thread, None
        if th is not None:
            th.join(timeout=5)
