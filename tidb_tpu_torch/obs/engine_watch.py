"""Engine watch: per-statement accounting of what the CUDA engine spends
besides its kernels.

Counterpart of tidb_tpu/obs/engine_watch.py. The JAX package counts XLA
compilations, retraces of a plan signature it compiled before, host <->
device bytes and the device-memory high-water. The port's counterparts:

- ``jit_compilations``: a plan build (``PlanCompiler.compile``). Eager
  torch compiles nothing, so a build is what a cold plan costs.
- ``retraces``: another build of a plan signature already built (the
  plan cache is keyed by table versions, so a write, or a table grown
  past its tile, builds the plan again), or a re-size of a built plan's
  tiles (capacity discovery re-running a node that overflowed).
- ``h2d_bytes`` / ``d2h_bytes``: counted at the sites that feed
  ``chunk.TRANSFERS``, so the two agree to the byte.
- ``device_mem_peak_bytes``: the admission working set
  (``PhysicalExecutor._admit``'s ``last_working_set``), as the JAX
  package notes it.
- ``compile_flops`` / ``compile_bytes_accessed`` /
  ``compile_output_bytes``: 0, with no compiler to analyze.

Every note lands in the global REGISTRY (``tidbtpu_engine_*``) and, while
the session has a statement's record open on the thread, in that record;
finished records go into a ring of 256 read back as
information_schema.tpu_engine.
"""

from __future__ import annotations

import collections
import itertools
import threading
from typing import List, Optional

from tidb_tpu_torch.utils import racecheck
from tidb_tpu_torch.utils.metrics import REGISTRY

#: plan signatures built so far; a build of a member is a retrace. Reset
#: past this bound (the baseline restarts, which only under-counts)
_MAX_SIGS = 8192


class QueryEngineRecord:
    """One statement's engine accounting."""

    __slots__ = ("qid", "query", "jit_compilations", "retraces", "h2d_bytes", "d2h_bytes",
                 "device_mem_peak_bytes", "duration_s")

    def __init__(self, qid: int, query: str):
        self.qid = qid
        self.query = query
        self.jit_compilations = 0
        self.retraces = 0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.device_mem_peak_bytes = 0
        self.duration_s = 0.0


class EngineWatch:
    def __init__(self, capacity: int = 256):
        self._tls = threading.local()
        self._lock = racecheck.make_lock("engine_watch")
        self._seen_sigs = set()
        self._recent = collections.deque(maxlen=capacity)
        self._qid = itertools.count(1)
        self._c_builds = REGISTRY.counter(
            "tidbtpu_engine_jit_compilations", "plan builds (PlanCompiler.compile)")
        self._c_retraces = REGISTRY.counter(
            "tidbtpu_engine_retraces",
            "rebuilds and tile re-sizes of an already-built plan signature")
        self._c_h2d = REGISTRY.counter("tidbtpu_engine_h2d_bytes", "host->device transfer bytes")
        self._c_d2h = REGISTRY.counter("tidbtpu_engine_d2h_bytes", "device->host transfer bytes")
        self._g_mem = REGISTRY.gauge("tidbtpu_engine_device_mem_highwater_bytes",
                                     "largest admitted per-launch device working set")

    # -- a statement's scope (opened by the session per top-level statement)
    def begin_query(self, query: str) -> None:
        self._tls.rec = QueryEngineRecord(next(self._qid), str(query)[:256])

    def end_query(self, elapsed_s: float) -> None:
        rec = getattr(self._tls, "rec", None)
        self._tls.rec = None
        if rec is None:
            return
        rec.duration_s = float(elapsed_s)
        with self._lock:
            self._recent.append(rec)

    def current(self) -> Optional[QueryEngineRecord]:
        return getattr(self._tls, "rec", None)

    # -- notes from the engine (each O(1)) ---------------------------------
    def note_trace(self, sig) -> None:
        """One plan build for the plan signature `sig`."""
        with self._lock:
            if len(self._seen_sigs) > _MAX_SIGS:
                self._seen_sigs.clear()
            retrace = sig in self._seen_sigs
            self._seen_sigs.add(sig)
        self._c_builds.inc()
        if retrace:
            self._c_retraces.inc()
        rec = self.current()
        if rec is not None:
            rec.jit_compilations += 1
            rec.retraces += int(retrace)

    def note_resize(self) -> None:
        """One re-size of a built plan's tiles (a node overflowed)."""
        self._c_retraces.inc()
        rec = self.current()
        if rec is not None:
            rec.retraces += 1

    def note_h2d(self, nbytes: int) -> None:
        self._c_h2d.inc(nbytes)
        rec = self.current()
        if rec is not None:
            rec.h2d_bytes += int(nbytes)

    def note_d2h(self, nbytes: int) -> None:
        self._c_d2h.inc(nbytes)
        rec = self.current()
        if rec is not None:
            rec.d2h_bytes += int(nbytes)

    def note_device_mem(self, nbytes: int) -> None:
        """One launch's admitted working set (scan batches and operator
        tiles): the statement's device-memory high-water."""
        self._g_mem.set_max(nbytes)
        rec = self.current()
        if rec is not None:
            rec.device_mem_peak_bytes = max(rec.device_mem_peak_bytes, int(nbytes))

    # -- surfaces ------------------------------------------------------------
    def rows(self) -> List[tuple]:
        """information_schema.tpu_engine's rows, oldest first (the three
        compile-cost columns 0)."""
        with self._lock:
            recs = list(self._recent)
        return [(r.qid, r.query, r.jit_compilations, r.retraces, r.h2d_bytes, r.d2h_bytes,
                 r.device_mem_peak_bytes, r.duration_s, 0.0, 0.0, 0.0) for r in recs]

    def reset(self) -> None:
        """Forget the finished records and the signatures seen."""
        with self._lock:
            self._recent.clear()
            self._seen_sigs.clear()


ENGINE_WATCH = EngineWatch()
