"""Pessimistic lock manager: blocking table locks with deadlock
detection. A copy of tidb_tpu/storage/locks.py.

Reference: the pessimistic transaction path takes row locks per
statement and blocks conflicting writers instead of aborting them
(pkg/store/driver/txn/txn_driver.go LockKeys, pkg/session/txn.go), with
a wait-for-graph deadlock detector that aborts one member of a cycle
(pkg/store/mockstore/unistore/tikv/detector.go). The storage engine
here applies writes table-at-a-time (shadow tables swapped at commit),
so the natural lock unit is the table: two
transactions writing the same table serialize; different tables run in
parallel. Waits use one condition variable; every blocked waiter
registers an edge in the wait-for graph and a DFS over it detects
cycles exactly like the reference's detector (detector.go:113
CheckDeadlock).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Set, Tuple

from tidb_tpu_torch.utils import racecheck
from tidb_tpu_torch.utils.failpoint import inject

LockKey = Tuple[str, str]  # (db, table)


class DeadlockError(RuntimeError):
    """MySQL error 1213 analog; the session aborts (rolls back) the
    requesting transaction, mirroring InnoDB's victim choice of the
    waiter that closed the cycle."""

    def __init__(self) -> None:
        super().__init__(
            "Deadlock found when trying to get lock; try restarting "
            "transaction"
        )


class LockWaitTimeout(RuntimeError):
    """MySQL error 1205 analog (innodb_lock_wait_timeout exceeded)."""

    def __init__(self, key: LockKey, seconds: float) -> None:
        super().__init__(
            f"Lock wait timeout exceeded on {key[0]}.{key[1]} "
            f"after {seconds:g}s; try restarting transaction"
        )


class LockManager:
    def __init__(self) -> None:
        self._mu = racecheck.make_condition("storage.txn_wait")
        # key -> owning txn id
        self._owners: Dict[LockKey, int] = {}
        # txn id -> keys it holds
        self._held: Dict[int, Set[LockKey]] = {}
        # wait-for edges: waiting txn -> owner txn it is blocked on
        self._waits: Dict[int, int] = {}

    # -- deadlock detection (wait-for graph DFS, detector.go:113) -----
    def _would_deadlock(self, waiter: int, owner: int) -> bool:
        seen = set()
        cur: Optional[int] = owner
        while cur is not None and cur not in seen:
            if cur == waiter:
                return True
            seen.add(cur)
            cur = self._waits.get(cur)
        return False

    def acquire(self, txn_id: int, key: LockKey, timeout: float = 50.0,
                kill_check=None) -> None:
        """Block until `txn_id` holds `key`. Raises DeadlockError when
        waiting would close a cycle in the wait-for graph, or
        LockWaitTimeout after `timeout` seconds. `kill_check` (the
        session killer's ``check``) is polled at least every 0.25 s of a
        wait, so a KILL or the watchdog ends a statement waiting here."""
        inject("locks/acquire")
        deadline = time.monotonic() + timeout
        with self._mu:
            while True:
                owner = self._owners.get(key)
                if owner is None or owner == txn_id:
                    self._owners[key] = txn_id
                    self._held.setdefault(txn_id, set()).add(key)
                    self._waits.pop(txn_id, None)
                    return
                if self._would_deadlock(txn_id, owner):
                    self._waits.pop(txn_id, None)
                    inject("locks/deadlock-detected")
                    raise DeadlockError()
                self._waits[txn_id] = owner
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._waits.pop(txn_id, None)
                    raise LockWaitTimeout(key, timeout)
                self._mu.wait(timeout=min(remaining, 0.25))
                if kill_check is not None:
                    try:
                        kill_check()
                    except BaseException:
                        self._waits.pop(txn_id, None)
                        raise

    def release_all(self, txn_id: int) -> None:
        with self._mu:
            for key in self._held.pop(txn_id, set()):
                if self._owners.get(key) == txn_id:
                    del self._owners[key]
            self._waits.pop(txn_id, None)
            self._mu.notify_all()


_txn_id_lock = racecheck.make_lock("storage.txn_id")
_txn_id_next = [1]


def next_txn_id() -> int:
    with _txn_id_lock:
        i = _txn_id_next[0]
        _txn_id_next[0] += 1
        return i
