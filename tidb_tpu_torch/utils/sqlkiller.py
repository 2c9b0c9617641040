"""Query kill switch.

Counterpart of tidb_tpu/utils/sqlkiller.py. Reference:
pkg/util/sqlkiller/sqlkiller.go:41 — an atomic flag the executor polls
at safepoints; KILL QUERY sets it and the running statement aborts with
ErrQueryInterrupted. Here the safepoints are the host-side control
points of the engine (each capacity-discovery attempt, each streamed
chunk): a check tests a flag and the clock on the host and never waits
for the device.
"""

from __future__ import annotations

import contextlib
import threading
import time


class QueryKilled(RuntimeError):
    pass


class SQLKiller:
    def __init__(self) -> None:
        self._killed = threading.Event()
        # wall-clock deadline for the current statement (runaway-query
        # control, reference max_execution_time +
        # pkg/domain/resourcegroup/runaway.go); None = no limit
        self.deadline: float = 0.0

    def kill(self) -> None:
        """Signal the running statement to abort (thread-safe)."""
        self._killed.set()

    def clear(self, deadline: float = 0.0) -> None:
        self._killed.clear()
        self.deadline = deadline

    def check(self) -> None:
        if self._killed.is_set():
            raise QueryKilled("query interrupted (killed)")
        if self.deadline and time.monotonic() > self.deadline:
            raise QueryKilled(
                "query interrupted (max_execution_time exceeded)"
            )


# The killer of the statement currently executing on THIS thread
# (set by Session._execute_stmt): host-side blocking builtins (SLEEP,
# GET_LOCK waits) poll it so KILL and the instance watchdogs can abort
# them — the reference's sqlkiller is likewise reachable from any
# executor goroutine. Beside it, the statement's device lock, which
# those builtins let go while they wait.
_current = threading.local()


def set_current(killer, lock=None) -> None:
    _current.killer = killer
    _current.lock = lock


@contextlib.contextmanager
def statement_lock_released():
    """Let the current statement's device lock (a ``threading.RLock``)
    go while a host-side builtin waits, so that other sessions'
    statements run meanwhile, and take it back at the same depth after.
    A GET_LOCK that waits for another session's RELEASE_LOCK needs this
    to succeed at all. Take no other lock before entering: the device
    lock is always taken first."""
    lock = getattr(_current, "lock", None)
    if lock is None or not lock._is_owned():
        yield
        return
    # what threading.Condition.wait does with an RLock: every level of
    # this thread's hold is released, then restored together
    state = lock._release_save()
    try:
        yield
    finally:
        lock._acquire_restore(state)


def current_check() -> None:
    k = getattr(_current, "killer", None)
    if k is not None:
        k.check()


def interruptible_sleep(seconds: float) -> None:
    """time.sleep in 50ms slices, polling the current killer, with the
    statement's device lock let go."""
    deadline = time.monotonic() + seconds
    with statement_lock_released():
        while True:
            current_check()
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            time.sleep(min(remaining, 0.05))
