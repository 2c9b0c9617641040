"""Span tracing through a statement, for TRACE.

Counterpart of tidb_tpu/utils/tracing.py (reference:
pkg/util/tracing/util.go:21, rendered by TRACE, pkg/executor/trace.go).
A session's Tracer records (name, start, duration, depth); the session
opens spans around plan, run and materialize, and ``TRACE <stmt>``
returns them as rows. The spans of a remote worker (``add_remote``)
wait for the DCN tier (ROADMAP.md queue 1, item 9).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import List, Optional


@dataclasses.dataclass
class Span:
    name: str
    start_s: float
    dur_s: float
    depth: int


class Tracer:
    def __init__(self) -> None:
        self.spans: List[Span] = []
        self._depth = 0
        self._t0: Optional[float] = None
        self.enabled = False

    def reset(self) -> None:
        self.spans = []
        self._depth = 0
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        if self._t0 is None:
            self.reset()
        start = time.perf_counter()
        self._depth += 1
        depth = self._depth
        try:
            yield
        finally:
            self._depth -= 1
            self.spans.append(Span(name, start - self._t0, time.perf_counter() - start, depth))

    def rows(self):
        """TRACE's rows: (operation indented by depth, start, duration),
        by start."""
        return [("  " * (s.depth - 1) + s.name, f"{s.start_s * 1e3:.3f}ms",
                 f"{s.dur_s * 1e3:.3f}ms")
                for s in sorted(self.spans, key=lambda s: s.start_s)]

    def totals_by_name(self) -> dict:
        """Total duration per span name (the spans and the flight
        recorder's phases time the same walls)."""
        out: dict = {}
        for s in self.spans:
            out[s.name] = out.get(s.name, 0.0) + s.dur_s
        return out
