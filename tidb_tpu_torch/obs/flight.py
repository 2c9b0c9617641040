"""Query flight recorder: an always-on phase timeline per statement.

Counterpart of tidb_tpu/obs/flight.py (reference: the slow-query log
with plan capture, stmtsummary's per-digest aggregates). The session
opens a flight per top-level statement on its thread; each layer charges
seconds to a declared phase of it; finished flights go into a bounded
ring and feed information_schema.statements_summary (per-digest
percentiles and mean phases, joined with the engine watch),
information_schema.slow_query (the phase timeline and the captured
plan) and the ``tidbtpu_flight_*`` family.

Where the port's phases end (CUDA runs asynchronously, and no boundary
adds a ``torch.cuda.synchronize()``): ``parse`` and ``plan`` are host
work; ``compile`` is the plan build (``PlanCompiler.compile``);
``execute`` ends where the executor's one fetch brings the result to the
host (the wait for the card is in it), with the builds inside it taken
out; ``final-merge`` is ``materialize_rows``.

``PHASES`` is the JAX package's declaration, whole: ``note_phase``
rejects any other name, and scripts/check_flight_phases.py holds every
literal call site in the repo to it. The DCN phases stay uncharged here
until the multi-host tier is ported (ROADMAP.md queue 1, items 8-9), as
does the per-peer link registry; the Top SQL and timeline hooks come
with the time-series tier.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Dict, List, Optional

from tidb_tpu_torch.utils import racecheck
from tidb_tpu_torch.utils.metrics import REGISTRY

#: every phase a flight may charge (the JAX package's list)
PHASES = (
    "parse",
    "plan",
    "queue-wait",
    "compile",
    "execute",
    "final-merge",
    "fragment-dispatch",
    "shuffle-produce",
    "shuffle-push",
    "shuffle-wait",
    "shuffle-stage",
)

_PHASE_SET = frozenset(PHASES)


def _c_phase_seconds():
    return REGISTRY.counter("tidbtpu_flight_phase_seconds",
                            "cumulative seconds charged per flight phase", labels=("phase",))


def c_slow_captures():
    return REGISTRY.counter("tidbtpu_flight_slow_plan_captures_total",
                            "over-threshold statements whose plan text was captured")


class QueryFlight:
    """One statement's timeline. ``phases`` maps a declared phase to
    [seconds, bytes, retries]."""

    __slots__ = (
        "qid", "conn_id", "sql", "start_ts", "duration_s", "phases", "plan_cache",
        "plan_digest", "rows_sent", "plan_text", "jit_compilations", "retraces", "h2d_bytes",
        "d2h_bytes", "device_mem_peak_bytes",
    )

    def __init__(self, qid: int, conn_id: int, sql: str):
        self.qid = qid
        self.conn_id = conn_id
        self.sql = sql
        self.start_ts = time.time()
        self.duration_s = 0.0
        self.phases: Dict[str, list] = {}
        #: "hit" | "miss" | "": the last plan-cache outcome the executor
        #: reported while this flight was open
        self.plan_cache = ""
        #: a short fingerprint of that plan's cache key
        self.plan_digest = ""
        self.rows_sent = 0
        #: the captured plan (EXPLAIN's tree, or EXPLAIN ANALYZE's lines)
        self.plan_text = ""
        self.jit_compilations = 0
        self.retraces = 0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.device_mem_peak_bytes = 0

    def timeline(self) -> List[tuple]:
        """(phase, seconds, bytes, retries) in declared order."""
        return [(p, *self.phases[p]) for p in PHASES if p in self.phases]


class FlightRecorder:
    """The current flight is thread-local (its notes take no lock);
    finished flights go into a ring of `capacity`, oldest out first."""

    def __init__(self, capacity: int = 256):
        self._tls = threading.local()
        self._lock = racecheck.make_lock("flight.ring")
        self._recent = collections.deque(maxlen=capacity)
        self._qid = itertools.count(1)
        self._phase_counters: Dict[str, object] = {}
        self._c_queries = REGISTRY.counter("tidbtpu_flight_queries_total",
                                           "statements the flight recorder closed")
        self._h_seconds = REGISTRY.histogram("tidbtpu_flight_query_seconds",
                                             "flight-recorded statement latency")

    # -- a statement's scope ----------------------------------------------
    def begin(self, sql: str, conn_id: int = 0) -> QueryFlight:
        rec = QueryFlight(next(self._qid), int(conn_id), str(sql)[:2048])
        self._tls.rec = rec
        return rec

    def current(self) -> Optional[QueryFlight]:
        return getattr(self._tls, "rec", None)

    def finish(self, duration_s: float) -> Optional[QueryFlight]:
        """Close the current flight into the ring and return it; None
        when none is open."""
        rec = self.current()
        self._tls.rec = None
        if rec is None:
            return None
        rec.duration_s = float(duration_s)
        self._c_queries.inc()
        self._h_seconds.observe(rec.duration_s)
        with self._lock:
            self._recent.append(rec)
        return rec

    def discard(self) -> None:
        """Drop an open flight unrecorded (the statement raised: a
        half-charged timeline would skew its digest's means)."""
        self._tls.rec = None

    # -- notes -------------------------------------------------------------
    def note_phase(self, name: str, seconds: float, nbytes: int = 0, retries: int = 0) -> None:
        """Charge seconds (and bytes, retries) to a declared phase of the
        current flight; an undeclared name raises."""
        if name not in _PHASE_SET:
            raise ValueError(f"undeclared flight phase {name!r} (not in PHASES)")
        seconds = max(float(seconds), 0.0)
        c = self._phase_counters.get(name)
        if c is None:
            c = self._phase_counters[name] = _c_phase_seconds().labels(phase=name)
        c.inc(seconds)
        rec = self.current()
        if rec is None:
            return
        row = rec.phases.get(name)
        if row is None:
            row = rec.phases[name] = [0.0, 0, 0]
        row[0] += seconds
        row[1] += int(nbytes)
        row[2] += int(retries)

    def phase_seconds(self, name: str) -> float:
        """Seconds charged so far to `name` on the current flight (0.0
        with none open): a caller whose wall holds nested charges takes
        them out."""
        rec = self.current()
        if rec is None:
            return 0.0
        row = rec.phases.get(name)
        return row[0] if row else 0.0

    def note_plan_cache(self, hit: bool, key=None) -> None:
        """The executor's plan-cache outcome; `key` stamps a short plan
        digest onto the flight."""
        rec = self.current()
        if rec is None:
            return
        rec.plan_cache = "hit" if hit else "miss"
        if key is not None:
            try:
                rec.plan_digest = "%016x" % (hash(key) & (2 ** 64 - 1))
            except TypeError:
                pass

    def note_rows_sent(self, n: int) -> None:
        rec = self.current()
        if rec is not None:
            rec.rows_sent = int(n)

    def note_plan_text(self, text: str) -> None:
        rec = self.current()
        if rec is not None and text:
            rec.plan_text = str(text)[:16384]

    def note_engine(self, engine_rec) -> None:
        """Join the statement's engine-watch record into its flight."""
        rec = self.current()
        if rec is None or engine_rec is None:
            return
        for k in ("jit_compilations", "retraces", "h2d_bytes", "d2h_bytes",
                  "device_mem_peak_bytes"):
            setattr(rec, k, getattr(engine_rec, k))

    # -- surfaces ----------------------------------------------------------
    def rows(self) -> List[dict]:
        """The finished flights, oldest first, as dicts."""
        with self._lock:
            recs = list(self._recent)
        return [{
            "qid": r.qid, "conn_id": r.conn_id, "sql": r.sql, "start_ts": r.start_ts,
            "duration_s": r.duration_s,
            "phases": {p: {"seconds": s, "bytes": b, "retries": n}
                       for p, s, b, n in r.timeline()},
            "plan_cache": r.plan_cache, "rows_sent": r.rows_sent,
            "jit_compilations": r.jit_compilations, "retraces": r.retraces,
            "h2d_bytes": r.h2d_bytes, "d2h_bytes": r.d2h_bytes,
            "device_mem_peak_bytes": r.device_mem_peak_bytes, "plan_captured": bool(r.plan_text),
        } for r in recs]

    def reset(self) -> None:
        """Forget the finished flights."""
        with self._lock:
            self._recent.clear()


FLIGHT = FlightRecorder()
