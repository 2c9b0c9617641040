"""Lock-order race/deadlock detection.

Counterpart of tidb_tpu/utils/racecheck.py. Reference: the Go build runs
`make race` (ut --race, Makefile:192); TiKV-side lock deadlocks are caught
at runtime by unistore's wait-for detector
(pkg/store/mockstore/unistore/tikv/detector.go). Python under the GIL has
no torn reads for the Go detector to catch: the race class that does
exist here is *lock-order inversion* between the engine's mutexes (the
device's statement lock against table, catalog and lock-manager locks),
which deadlocks two threads exactly like the reference's txn wait cycles.
The port runs device work from several threads, each under the device's
statement lock: the server's connection threads, the TTL and auto-analyze
workers, the DXF executors and the instance watchdog's kill.

`make_lock(name)` returns a plain threading.Lock unless
TIDB_TPU_RACECHECK=1 (or `enable()` was called before the lock was
built), in which case it returns an order-tracked wrapper: every
acquisition records the (held-class -> acquiring-class) edges; an edge
that closes a cycle with the edges seen anywhere earlier in the process is
a potential deadlock and raises LockOrderError naming both orders. The
check is by lock *class* (the `name` passed at construction), and the
edge graph is global: one run catches inversions exercised on any thread.
`make_rlock` and `make_condition` are the RLock/Condition analogs (an
RLock may re-enter the same *instance*; a Condition may wait on itself
while held). Self-deadlock (re-acquiring the same non-reentrant class in
one thread) is reported too.

``LOCK_CLASSES`` declares every lock class the port builds, with the JAX
package's name where the lock is the same; the factories reject
undeclared names. ``THREAD_NAME_PREFIXES`` declares the names of the
port's threads. tests/test_torch_racecheck.py checks statically that the
port builds no raw threading primitive outside this module, names no
undeclared class and starts no thread without a declared prefix.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Set, Tuple

#: Every lock class the port constructs, name -> what it guards.
LOCK_CLASSES: Dict[str, str] = {
    # storage tier
    "table": "one table's rows/indexes during DML + shadow-commit swap",
    "catalog": "the shared schema map (create/drop/alter)",
    "catalog.commit": "whole-catalog commit serialization",
    "sequence": "sequence allocator state",
    "storage.external": "process-global in-memory object-store buckets",
    "storage.native": "lazy build + load of the native .so",
    "storage.txn_wait": "pessimistic lock-manager wait state (condition)",
    "storage.txn_id": "global txn id allocator",
    # dxf / sessions
    "dxf.manager": "DXF task/subtask tables",
    "dxf.stagers": "each IMPORT task's pool of staging processes",
    "session.user_locks": "GET_LOCK advisory-lock registry (condition)",
    "session.statement": "one device's statement lock: one statement at a "
                         "time runs on the device (reentrant)",
    "session.statement_guard": "the device -> statement lock map",
    # background workers
    "stats.handle": "the auto-analyze worker's start/stop",
    "ttl.worker": "the TTL worker's start/stop",
    # server tier
    "server.conns": "MySQL server connection counter/ids",
    # observability tier
    "metrics.registry": "the metric name -> collector map",
    "metrics.family": "one labeled family's children map",
    "metrics.metric": "one counter/gauge/histogram's value cells",
    "metrics.slowlog": "slow-query ring buffer",
    "metrics.slowlog_file": "slow-query file sink appends",
    "metrics.stmt_summary": "per-digest statement aggregates",
    "metrics.stmt_history": "closed statements_summary windows + pending evictions",
    "engine_watch": "finished engine-watch records ring",
    "flight.ring": "finished query-flight ring",
    "resgroup": "resource-group definitions",
    # utils
    "failpoint.registry": "armed failpoint actions",
    "failpoint.site": "one after_n() site's invocation counter",
    "privilege": "user + grant store",
}

#: Declared thread-name families: every thread the port starts is named
#: "<prefix>-..." (or exactly "<prefix>") with a prefix from this set.
THREAD_NAME_PREFIXES = frozenset({
    "dxf",
    "http",
    "mysql",
    "stats",
    "storage",
    "ttl",
    "watchdog",
})


class LockOrderError(RuntimeError):
    pass


_enabled = os.environ.get("TIDB_TPU_RACECHECK", "0") == "1"
_graph_mu = threading.Lock()
#: lock-class -> set of lock-classes acquired while it was held
_edges: Dict[str, Set[str]] = {}
#: where each recorded edge was first seen (for the report)
_edge_origin: Dict[Tuple[str, str], str] = {}
#: every class acquired at least once while tracking was on — the
#: "did this subsystem's locks participate in the run" signal the
#: stress tests assert (set.add is GIL-atomic)
_seen: Set[str] = set()
_held = threading.local()


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def reset() -> None:
    """Clear the recorded edge graph (test isolation)."""
    with _graph_mu:
        _edges.clear()
        _edge_origin.clear()
        _seen.clear()


def _held_stack() -> List[str]:
    st = getattr(_held, "stack", None)
    if st is None:
        st = _held.stack = []
    return st


def _rdepths() -> Dict[int, int]:
    """Per-thread reentrancy depth per TrackedRLock instance."""
    d = getattr(_held, "rdepths", None)
    if d is None:
        d = _held.rdepths = {}
    return d


def _acquire_site() -> str:
    """file:line of the acquisition call site — the innermost stack
    frame OUTSIDE this module. A fixed extract_stack(limit=N)[0] slice
    reported an arbitrary ancestor frame instead (the deeper the
    caller, the wronger the report)."""
    import traceback

    here = os.path.abspath(__file__)
    for frame in reversed(traceback.extract_stack()):
        if os.path.abspath(frame.filename) != here:
            return f"{frame.filename}:{frame.lineno}"
    return "?"


def _check_and_record(acquiring: str) -> None:
    """Shared acquisition bookkeeping: self-deadlock check against the
    thread's held stack, then one (held -> acquiring) edge per held
    class, each cycle-checked against the global graph."""
    _seen.add(acquiring)
    stack = _held_stack()
    if acquiring in stack:
        raise LockOrderError(
            f"self-deadlock: lock class '{acquiring}' re-acquired "
            f"while held (stack: {stack})"
        )
    for held in stack:
        _record_edge(held, acquiring, stack)


def _record_edge(held: str, acquiring: str, stack) -> None:
    if held == acquiring:
        return
    with _graph_mu:
        fwd = _edges.setdefault(held, set())
        if acquiring in fwd:
            return  # known-consistent order
        # the reversal check BEFORE recording: if `held` is
        # REACHABLE from `acquiring` through recorded edges, adding
        # held->acquiring closes a cycle — N threads interleaving
        # the N paths deadlock (direct reversal is the 2-cycle;
        # BFS catches table->A->B->table style 3+-cycles too)
        seen, frontier = {acquiring}, [acquiring]
        while frontier:
            node = frontier.pop()
            for nxt in _edges.get(node, ()):
                if nxt == held:
                    origin = _edge_origin.get((node, held), "?")
                    raise LockOrderError(
                        f"lock-order inversion: acquiring "
                        f"'{acquiring}' while holding {stack}, but "
                        f"'{node}' -> '{held}' was recorded at "
                        f"{origin}, making '{held}' reachable from "
                        f"'{acquiring}' — interleaving threads "
                        "deadlock on this cycle"
                    )
                if nxt not in seen:
                    seen.add(nxt)
                    frontier.append(nxt)
        fwd.add(acquiring)
        _edge_origin[(held, acquiring)] = _acquire_site()


class TrackedLock:
    """Order-tracking wrapper with the Lock/context-manager protocol."""

    def __init__(self, name: str):
        self.name = name
        self._lk = threading.Lock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        _check_and_record(self.name)
        got = self._lk.acquire(blocking, timeout)
        if got:
            _held_stack().append(self.name)
        return got

    def release(self) -> None:
        stack = _held_stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        elif self.name in stack:
            # out-of-LIFO release is legal for Lock; drop the entry
            stack.remove(self.name)
        self._lk.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self) -> bool:
        return self._lk.locked()


class TrackedRLock:
    """Order-tracked reentrant lock: re-acquiring the SAME instance on
    one thread is legal (no edges, depth-counted); re-acquiring the
    same CLASS through a different instance is still a potential
    deadlock — two threads, two instances, opposite orders."""

    def __init__(self, name: str):
        self.name = name
        self._lk = threading.RLock()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        d = _rdepths()
        k = id(self)
        if d.get(k, 0) > 0:  # reentry on this thread
            got = self._lk.acquire(blocking, timeout)
            if got:
                d[k] += 1
            return got
        _check_and_record(self.name)
        got = self._lk.acquire(blocking, timeout)
        if got:
            d[k] = 1
            _held_stack().append(self.name)
        return got

    def release(self) -> None:
        d = _rdepths()
        k = id(self)
        if d.get(k, 0) > 1:
            d[k] -= 1
            self._lk.release()
            return
        d.pop(k, None)
        stack = _held_stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        elif self.name in stack:
            stack.remove(self.name)
        self._lk.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    # the protocol utils/sqlkiller.py's statement_lock_released uses (what
    # threading.Condition.wait does with an RLock): every level of this
    # thread's hold let go at once, then taken back together
    def _is_owned(self) -> bool:
        return _rdepths().get(id(self), 0) > 0

    def _release_save(self):
        depth = _rdepths().pop(id(self), 0)
        stack = _held_stack()
        if self.name in stack:
            stack.remove(self.name)
        return depth, self._lk._release_save()

    def _acquire_restore(self, state) -> None:
        depth, inner = state
        _check_and_record(self.name)
        self._lk._acquire_restore(inner)
        _rdepths()[id(self)] = depth
        _held_stack().append(self.name)


class TrackedCondition:
    """Order-tracked condition variable. acquire/release track like
    TrackedLock; wait/wait_for/notify delegate to a real Condition
    (wait releases and re-acquires the underlying lock internally —
    the thread is parked meanwhile, so the held-stack entry simply
    stays put: no other acquisition can happen on this thread)."""

    def __init__(self, name: str):
        self.name = name
        self._cv = threading.Condition()

    def acquire(self, *args) -> bool:
        _check_and_record(self.name)
        got = self._cv.acquire(*args)
        if got:
            _held_stack().append(self.name)
        return got

    def release(self) -> None:
        stack = _held_stack()
        if stack and stack[-1] == self.name:
            stack.pop()
        elif self.name in stack:
            stack.remove(self.name)
        self._cv.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def wait(self, timeout=None):
        return self._cv.wait(timeout)

    def wait_for(self, predicate, timeout=None):
        return self._cv.wait_for(predicate, timeout)

    def notify(self, n: int = 1) -> None:
        self._cv.notify(n)

    def notify_all(self) -> None:
        self._cv.notify_all()


def _check_declared(name: str) -> None:
    if name not in LOCK_CLASSES:
        raise ValueError(
            f"undeclared lock class {name!r}: declare it in "
            "tidb_tpu_torch/utils/racecheck.py LOCK_CLASSES"
        )


def make_lock(name: str):
    """A mutex for declared lock class `name`: plain threading.Lock
    normally (zero overhead), TrackedLock under race checking."""
    _check_declared(name)
    if _enabled:
        return TrackedLock(name)
    return threading.Lock()


def make_rlock(name: str):
    """A reentrant mutex for declared lock class `name`: plain
    threading.RLock normally, TrackedRLock under race checking."""
    _check_declared(name)
    if _enabled:
        return TrackedRLock(name)
    return threading.RLock()


def make_condition(name: str):
    """A condition variable for declared lock class `name`: plain
    threading.Condition normally, TrackedCondition under race
    checking."""
    _check_declared(name)
    if _enabled:
        return TrackedCondition(name)
    return threading.Condition()


def edge_graph() -> Dict[str, Set[str]]:
    with _graph_mu:
        return {k: set(v) for k, v in _edges.items()}


def seen_classes() -> Set[str]:
    """Lock classes acquired at least once since the last reset()
    while tracking was on — participation, independent of whether an
    acquisition happened to NEST (edge_graph() records only pairs).
    .copy() is one C-level call that never releases the GIL for str
    elements, so it is atomic against concurrent _seen.add()."""
    return _seen.copy()


def edge_origins() -> Dict[Tuple[str, str], str]:
    """(held, acquiring) -> 'file:line' of the first observation of
    that edge — the acquisition call site, not a racecheck frame."""
    with _graph_mu:
        return dict(_edge_origin)
