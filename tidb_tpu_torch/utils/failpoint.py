"""Failpoint-style fault injection.

Counterpart of tidb_tpu/utils/failpoint.py. Reference: pingcap/failpoint
with its inject sites enabled by code rewrite (Makefile failpoint-enable)
+ kv.FaultInjectedStore (pkg/kv/fault_injection.go). Python needs no
rewrite step: `inject(name)` is a no-op unless a test armed the
failpoint, in which case it raises, returns a value, or calls a hook.

The port's ``SITES`` are the JAX package's sites whose code the port has,
under the same names: the repo's failpoint lint (scripts/
check_failpoints.py) holds every literal site a test or the port arms
against the JAX registry. The ``ddl/index-*`` and ``ddl/modify-column-*``
ladders are left out on purpose (the port's online DDL runs no such
ladder), and so are the sites of modules not ported yet (the MPP tier,
the delta tier, CDC, log backup and the serving tier).
"""

from __future__ import annotations

from typing import Dict

from tidb_tpu_torch.utils import racecheck

_lock = racecheck.make_lock("failpoint.registry")
_active: Dict[str, object] = {}

#: Every failpoint site the port defines, each with an ``inject`` call in
#: the port (tests/test_torch_failpoint.py checks both).
SITES = frozenset({
    "br/statement",
    "catalog/create-table",
    "catalog/drop-table",
    "collate/rank-lut",
    "cte/iterate",
    "ddl/alter-table",
    "ddl/create-index",
    "ddl/generated-recompute",
    "ddl/rename-table",
    "dml/delete",
    "dml/insert",
    "dml/load",
    "dml/update",
    "dxf/heartbeat",
    "dxf/submit",
    "executor/admission",
    "executor/before-discover",
    "executor/cap-overflow",
    "executor/partition-feed",
    "executor/partition-start",
    "executor/stream-chunk",
    "executor/stream-chunk-device",
    "executor/stream-sort",
    "executor/stream-start",
    "extsort/merge-round",
    "extsort/merge-views",
    "fk/cascade-delete",
    "fk/cascade-update",
    "locks/acquire",
    "locks/deadlock-detected",
    "persist/backup-table",
    "persist/before-manifest",
    "persist/restore-start",
    "resgroup/debit",
    "sequence/nextval",
    "server/dispatch-query",
    "session/before-commit",
    "session/begin-txn",
    "session/commit-apply",
    "session/commit-conflict-check",
    "session/execute-prepared",
    "session/stmt-start",
    "stats/analyze",
    "storage/append-skip-unique",
    "storage/gc-drop-version",
    "storage/gc-versions",
    "storage/install-commit",
    "storage/scan",
    "watchdog/sample",
})

#: sites declared at runtime (tests exercising the lint itself or
#: prototyping a new site before it lands in SITES)
_extra_sites: set = set()


class FailpointError(RuntimeError):
    pass


def declare(name: str) -> None:
    """Declare an out-of-tree site (tests/prototypes). Engine sites
    belong in SITES."""
    with _lock:
        _extra_sites.add(name)


def is_declared(name: str) -> bool:
    return name in SITES or name in _extra_sites


def enable(name: str, action: object) -> None:
    """action: an Exception instance/class to raise, a callable hook, or
    a value to return from inject(). Rejects undeclared site names — a
    typo here would otherwise arm nothing and the test would silently
    pass."""
    if not is_declared(name):
        raise ValueError(
            f"unknown failpoint site {name!r}: declare it in "
            "tidb_tpu_torch/utils/failpoint.py SITES (engine sites) or via "
            "declare() "
            "(test-local sites)"
        )
    with _lock:
        _active[name] = action


def disable(name: str) -> None:
    with _lock:
        _active.pop(name, None)


def disable_all() -> None:
    with _lock:
        _active.clear()


def _run_action(action, msg: str):
    """The four action kinds a site applies: raise an exception class,
    raise an instance, call a hook, or return a value (shared by
    inject() and after_n() so the dispatch never drifts)."""
    if isinstance(action, type) and issubclass(action, BaseException):
        raise action(msg)
    if isinstance(action, BaseException):
        raise action
    if callable(action):
        return action()
    return action


def inject(name: str, default=None):
    """Call at a site. Returns `default` (or the enabled value)."""
    action = _active.get(name)
    if action is None:
        return default
    return _run_action(action, f"failpoint {name}")


def is_enabled(name: str) -> bool:
    return name in _active


def _gated(action: object, msg: str, due):
    """The shared shell of every stateful action term: serialize hits
    on a private lock, ask ``due()`` (which owns/mutates the term's
    state) whether THIS hit fires, and run the action if so — the
    thread-safety and dispatch live once for seeded/times/after_n."""
    slock = racecheck.make_lock("failpoint.site")

    def fire():
        with slock:
            hit = due()
        if not hit:
            return None
        return _run_action(action, msg)

    return fire


def seeded(seed: int, p: float, action: object):
    """A PROBABILISTIC action driven by a private seeded PRNG: each
    invocation of the site draws once and fires `action` when the draw
    lands under `p`. The draw SEQUENCE is fully determined by the seed
    — a chaos run replays a fault schedule by
    re-arming the same (seed, p) pair, the analog of the reference's
    `K%` failpoint term (pingcap/failpoint terms.go) made
    deterministic. Thread-safe: concurrent hits serialize so every
    hit consumes exactly one draw."""
    import random

    rng = random.Random(int(seed))
    return _gated(
        action, f"failpoint seeded({seed}, {p})",
        lambda: rng.random() < float(p),
    )


def _counter(n: int, cmp):
    state = {"count": 0}

    def due():
        state["count"] += 1
        return cmp(state["count"], int(n))

    return due


def times(n: int, action: object):
    """An action that fires on the FIRST n invocations of its site and
    then goes dormant — a bounded fault WINDOW (the reference's `Nx`
    term): a tunnel partition that heals after k frames, a crash storm
    that ends. Thread-safe."""
    return _gated(
        action, "failpoint times", _counter(n, lambda c, n: c <= n)
    )


def after_n(n: int, action: object):
    """An action that fires EXACTLY on the n-th invocation of its site
    (dormant before and after) — 'die on the K-th fragment' style
    schedules, the analog of the reference's `Nx`/`xN` failpoint term
    syntax (pingcap/failpoint terms.go). One-shot so a retry of the
    failed operation observes a healthy site. Thread-safe."""
    return _gated(
        action, "failpoint after_n", _counter(n, lambda c, n: c == n)
    )
