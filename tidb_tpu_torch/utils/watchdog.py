"""Instance watchdog: memory-usage alarm, expensive-query flag, server
memory limit.

Counterpart of tidb_tpu/utils/watchdog.py. Reference:
pkg/util/memoryusagealarm/memoryusagealarm.go (record an alarm when the
instance's memory passes a ratio of the total), pkg/util/expensivequery/
expensivequery.go (flag statements running past a threshold), and
pkg/util/servermemorylimit/servermemorylimit.go:51 (kill the top memory
consumer when the instance limit is breached).

One daemon per catalog samples the process's host RSS and walks the
session registry (the one SHOW PROCESSLIST reads). The "top consumer" is
the running statement whose session admitted the largest working set
(``PhysicalExecutor.last_working_set``, the bytes quota admission counts
for each launch), then the longest-running one. ``tidb_server_memory_limit``
is enforced at its default of 80% of the host's memory, as the JAX
package enforces it. The alarm and kill records surface through
information_schema.memory_usage and memory_usage_ops_history; each
action counts in its ``tidbtpu_watchdog_*`` counter, and an expensive
statement gets an ``[expensive_query]`` entry in the slow log while
``slow_query_log`` is on (flagged once, in ``expensive_seen``).
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

from tidb_tpu_torch.utils.metrics import REGISTRY, SLOW_LOG


def host_memory() -> tuple:
    """(rss bytes, total bytes) from /proc (Linux)."""
    rss = total = 0
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    rss = int(line.split()[1]) * 1024
                    break
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = int(line.split()[1]) * 1024
                    break
    except OSError:
        pass
    return rss, total


def parse_mem_limit(v, total: int) -> int:
    """tidb_server_memory_limit: '80%' | bytes | '0' (off) -> bytes."""
    s = str(v).strip()
    if not s or s == "0":
        return 0
    if s.endswith("%"):
        try:
            return int(total * float(s[:-1]) / 100.0)
        except ValueError:
            return 0
    try:
        return int(float(s))
    except ValueError:
        return 0


def gvar(catalog, name, default):
    """A GLOBAL sysvar as the watchdog sees it: the SET GLOBAL value, else
    the registered default (so tidb_server_memory_limit's '80%' is
    enforced, not only displayed), else `default`."""
    v = catalog.global_sysvars.get(name)
    if v is not None:
        return v
    from tidb_tpu_torch.utils.sysvar import SYSVAR_DEFS

    d = SYSVAR_DEFS.get(name)
    return d.default if d is not None else default


class InstanceWatchdog(threading.Thread):
    """Daemon sampler over one catalog's sessions."""

    def __init__(self, catalog, interval: float = 2.0):
        super().__init__(daemon=True, name="watchdog-instance")
        self.catalog = catalog
        self.interval = interval
        self.stop_flag = threading.Event()
        self.alarm_records: List[dict] = []
        self.kill_records: List[dict] = []
        self.expensive_seen: set = set()
        self.last_rss = 0
        self.samples = 0

    def _gvar(self, name, default):
        return gvar(self.catalog, name, default)

    def run(self) -> None:
        from tidb_tpu_torch.utils.failpoint import FailpointError

        while not self.stop_flag.wait(self.interval):
            try:
                self.sample()
            except FailpointError:
                raise  # injected faults must be observable in tests
            except Exception:
                pass  # the watchdog must never take the engine down

    def stop(self, timeout: float = 10.0) -> None:
        """Stop sampling and join the thread (within `timeout` seconds)."""
        self.stop_flag.set()
        if self.is_alive():
            self.join(timeout)

    def sessions(self):
        reg = getattr(self.catalog, "_session_registry", None) or {}
        return [s for s in list(reg.values()) if s is not None]

    def sample(self) -> None:
        from tidb_tpu_torch.utils.failpoint import inject

        inject("watchdog/sample")

        self.samples += 1
        now = time.time()
        rss, total = host_memory()
        self.last_rss = rss

        # ---- expensive queries (expensivequery.go) --------------------
        thr = float(self._gvar("tidb_expensive_query_time_threshold", 60))
        for s in self.sessions():
            cur = s._current_stmt
            if cur is None:
                continue
            elapsed = now - cur[1]
            key = (s.conn_id, cur[1])
            if elapsed >= thr and key not in self.expensive_seen:
                self.expensive_seen.add(key)
                REGISTRY.counter("tidbtpu_watchdog_expensive_queries_total",
                                 "statements running past the expensive threshold").inc()
                # the entry rides the slow log and honors its switch; its
                # bar is its own threshold (the statement still runs)
                if bool(self._gvar("slow_query_log", True)):
                    SLOW_LOG.record(
                        f"[expensive_query] conn={s.conn_id} "
                        f"elapsed={elapsed:.1f}s sql={str(cur[0])[:200]}",
                        elapsed, conn_id=s.conn_id)
        if len(self.expensive_seen) > 4096:
            self.expensive_seen.clear()

        # ---- memory usage alarm (memoryusagealarm.go) -----------------
        ratio = float(self._gvar("tidb_memory_usage_alarm_ratio", 0.7))
        if total and rss > ratio * total:
            keep = int(self._gvar("tidb_memory_usage_alarm_keep_record_num", 5))
            self.alarm_records.append(
                {"time": now, "rss": rss, "total": total, "ratio": ratio})
            del self.alarm_records[:-max(keep, 1)]
            REGISTRY.counter("tidbtpu_watchdog_memory_usage_alarms_total",
                             "instance memory passed the alarm ratio").inc()

        # ---- server memory limit (servermemorylimit.go:51) ------------
        limit = parse_mem_limit(self._gvar("tidb_server_memory_limit", "0"), total)
        if limit and rss > limit:
            victim = self.top_consumer()
            if victim is not None:
                victim.killer.kill()
                self.kill_records.append({
                    "time": now,
                    "conn_id": victim.conn_id,
                    "sql": str(victim._current_stmt[0])[:200] if victim._current_stmt else "",
                    "rss": rss,
                    "limit": limit,
                    "working_set": getattr(victim.executor, "last_working_set", 0),
                })
                del self.kill_records[:-64]
                REGISTRY.counter("tidbtpu_watchdog_server_memory_limit_kills_total",
                                 "statements killed at the instance memory limit").inc()

    def top_consumer(self) -> Optional[object]:
        """The session of a running statement with the largest admitted
        working set (then the longest-running statement)."""
        best, best_key = None, (-1, -1.0)
        now = time.time()
        for s in self.sessions():
            cur = s._current_stmt
            if cur is None:
                continue
            ws = int(getattr(s.executor, "last_working_set", 0) or 0)
            key = (ws, now - cur[1])
            if key > best_key:
                best, best_key = s, key
        return best


def ensure_watchdog(catalog, interval: float = 2.0) -> InstanceWatchdog:
    """One watchdog per base catalog, started lazily (at the first SET of
    one of its knobs, and by the server binary)."""
    base = getattr(catalog, "_base", catalog)
    wd = getattr(base, "_watchdog", None)
    if wd is None or not wd.is_alive():
        wd = base._watchdog = InstanceWatchdog(base, interval=interval)
        wd.start()
    return wd
