"""Metrics, the slow-query log and the statement summary.

Counterpart of tidb_tpu/utils/metrics.py. Reference: pkg/metrics
(Prometheus collectors per subsystem), pkg/executor/slow_query.go (the
slow log read back as INFORMATION_SCHEMA.SLOW_QUERY) and
pkg/util/stmtsummary/statement_summary.go:73 (per-digest aggregated
statement stats). One process: an in-memory registry rendered as
Prometheus text, a ring-buffer slow log and a digest-keyed summary, all
read through information_schema's virtual tables.

Metric names follow ``tidbtpu_<subsystem>_<name>`` with the JAX
package's subsystems (scripts/check_metric_names.py walks this package
too): ``REGISTRY.counter("tidbtpu_session_statements_total", "...")``.

A statement's digest is its normalized text. ``sql_digest`` tokenizes
the text; the session builds the same digest from the tokens its parse
already made (``digest_tokens``), so no statement is tokenized twice.
The counter shipping between worker processes (``counter_snapshot`` and
its family) waits for the DCN worker (ROADMAP.md queue 1, item 9).
"""

from __future__ import annotations

import collections
import re
import time
from typing import Dict, List, Optional, Tuple

from tidb_tpu_torch.utils import racecheck


def _escape_label_value(v: str) -> str:
    """Prometheus text-format label value escaping: backslash, quote,
    newline."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_block(labelnames, labelvalues) -> str:
    """'{k="v",...}', or '' for the unlabeled case."""
    if not labelnames:
        return ""
    return "{" + ",".join(
        f'{k}="{_escape_label_value(v)}"' for k, v in zip(labelnames, labelvalues)) + "}"


class Counter:
    kind = "counter"

    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self.value = 0.0
        self._lock = racecheck.make_lock("metrics.metric")

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Gauge:
    """A value that goes up and down (connection counts, high-water marks)."""

    kind = "gauge"

    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self.value = 0.0
        self._lock = racecheck.make_lock("metrics.metric")

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def set_max(self, v: float) -> None:
        """High-water: keep the larger of the current value and v."""
        with self._lock:
            if v > self.value:
                self.value = float(v)

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self.value -= n


class Histogram:
    """Fixed-bucket latency histogram (seconds)."""

    kind = "histogram"

    BUCKETS = (0.001, 0.005, 0.02, 0.1, 0.5, 2.0, 10.0)

    def __init__(self, name: str, help_: str = ""):
        self.name = name
        self.help = help_
        self.counts = [0] * (len(self.BUCKETS) + 1)
        self.sum = 0.0
        self.total = 0
        self._lock = racecheck.make_lock("metrics.metric")

    def observe(self, v: float) -> None:
        with self._lock:
            self.sum += v
            self.total += 1
            for i, b in enumerate(self.BUCKETS):
                if v <= b:
                    self.counts[i] += 1
                    return
            self.counts[-1] += 1


class StreamingHistogram(Histogram):
    """A Histogram that also answers quantiles: the statement summary's
    p50/p95/p99, interpolated linearly inside the covering bucket as
    Prometheus' histogram_quantile does. Monotone in q."""

    def quantile(self, q: float) -> float:
        """The estimated value at quantile ``q`` in [0, 1]. The overflow
        bucket has no upper edge: it answers max(mean, last edge)."""
        q = min(max(float(q), 0.0), 1.0)
        with self._lock:
            total = self.total
            if total == 0:
                return 0.0
            rank = q * total
            acc = 0
            lo = 0.0
            for edge, c in zip(self.BUCKETS, self.counts):
                if acc + c >= rank and c > 0:
                    frac = (rank - acc) / c
                    return lo + (edge - lo) * min(max(frac, 0.0), 1.0)
                acc += c
                lo = edge
            return max(self.sum / total, float(self.BUCKETS[-1]))


class MetricFamily:
    """A labeled metric: its children are plain Counter/Gauge/Histogram
    instances keyed by label values (client_golang's *Vec collectors)."""

    def __init__(self, cls, name: str, help_: str, labelnames: Tuple[str, ...]):
        self.cls = cls
        self.kind = cls.kind
        self.name = name
        self.help = help_
        self.labelnames = tuple(labelnames)
        self._children: Dict[Tuple[str, ...], object] = {}
        self._lock = racecheck.make_lock("metrics.family")

    def labels(self, *values, **kv):
        if kv:
            if values:
                raise ValueError("pass label values positionally OR by name")
            extra = set(kv) - set(self.labelnames)
            if extra:
                raise ValueError(f"{self.name}: unknown label(s) {sorted(extra)} "
                                 f"(labelnames={self.labelnames})")
            try:
                values = tuple(kv[k] for k in self.labelnames)
            except KeyError as e:
                raise ValueError(f"{self.name}: missing label {e} "
                                 f"(labelnames={self.labelnames})") from None
        values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(f"{self.name}: expected {len(self.labelnames)} label "
                             f"values, got {len(values)}")
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._children[values] = self.cls(self.name, self.help)
            return child

    def children(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())


def _fmt_value(v: float) -> str:
    """Full precision: integral values as integers, the rest by repr
    (%g would step byte counters past 1e10 in ~1e5 increments)."""
    f = float(v)
    return str(int(f)) if f.is_integer() else repr(f)


def _render_one(out: List[str], name: str, m, labelnames=(), labelvalues=()) -> None:
    lb = _label_block(labelnames, labelvalues)
    if isinstance(m, (Counter, Gauge)):
        out.append(f"{name}{lb} {_fmt_value(m.value)}")
        return
    # a histogram's le buckets are cumulative (the exposition format)
    acc = 0
    names, values = tuple(labelnames) + ("le",), tuple(labelvalues)
    for b, c in zip(m.BUCKETS, m.counts):
        acc += c
        out.append(f"{name}_bucket{_label_block(names, values + (f'{b:g}',))} {acc}")
    out.append(f"{name}_bucket{_label_block(names, values + ('+Inf',))} {m.total}")
    out.append(f"{name}_sum{lb} {_fmt_value(m.sum)}")
    out.append(f"{name}_count{lb} {m.total}")


class Registry:
    def __init__(self):
        self._lock = racecheck.make_lock("metrics.registry")
        self._metrics: Dict[str, object] = {}

    def _get(self, cls, name: str, help_: str, labels):
        labels = tuple(labels or ())
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = MetricFamily(cls, name, help_, labels) if labels else cls(name, help_)
                self._metrics[name] = m
                return m
        # a name is one kind and one label set, for good
        existing_kind = getattr(m, "kind", None)
        if existing_kind != cls.kind:
            raise ValueError(f"metric {name} already registered as {existing_kind}")
        if isinstance(m, MetricFamily) != bool(labels) or (
                isinstance(m, MetricFamily) and m.labelnames != labels):
            raise ValueError(f"metric {name} already registered with different labels")
        return m

    def counter(self, name: str, help_: str = "", labels=()) -> Counter:
        return self._get(Counter, name, help_, labels)

    def gauge(self, name: str, help_: str = "", labels=()) -> Gauge:
        return self._get(Gauge, name, help_, labels)

    def histogram(self, name: str, help_: str = "", labels=()) -> Histogram:
        return self._get(Histogram, name, help_, labels)

    def _items(self):
        with self._lock:
            return sorted(self._metrics.items())

    def render(self) -> str:
        """Prometheus text exposition format."""
        out: List[str] = []
        for name, m in self._items():
            out.append(f"# TYPE {name} {m.kind}")
            if isinstance(m, MetricFamily):
                for values, child in m.children():
                    _render_one(out, name, child, m.labelnames, values)
            else:
                _render_one(out, name, m)
        return "\n".join(out) + "\n"

    def rows(self) -> List[Tuple[str, str, float]]:
        """(name, kind, value) for information_schema.metrics: a labeled
        child carries its label block in the name, a histogram gives its
        _count and _sum."""
        out: List[Tuple[str, str, float]] = []

        def one(name, m):
            if isinstance(m, Histogram):
                out.append((name + "_count", "histogram", float(m.total)))
                out.append((name + "_sum", "histogram", float(m.sum)))
            else:
                out.append((name, m.kind, float(m.value)))

        for name, m in self._items():
            if isinstance(m, MetricFamily):
                for values, child in m.children():
                    lb = _label_block(m.labelnames, values)
                    if isinstance(child, Histogram):
                        out.append((name + "_count" + lb, "histogram", float(child.total)))
                        out.append((name + "_sum" + lb, "histogram", float(child.sum)))
                    else:
                        out.append((name + lb, child.kind, float(child.value)))
            else:
                one(name, m)
        return out


REGISTRY = Registry()


def sample_rows(registry: Registry = REGISTRY) -> List[tuple]:
    """One sample of the whole registry, for a time-series store:
    ``(name, labelnames, labelvalues, value, kind)`` per counter and
    gauge child; a histogram samples as two series told apart by an
    appended ``stat`` label (``count`` and ``sum``)."""
    out: List[tuple] = []

    def one(name, lnames, lvalues, m):
        if isinstance(m, Histogram):
            hl = tuple(lnames) + ("stat",)
            out.append((name, hl, tuple(lvalues) + ("count",), float(m.total), "histogram"))
            out.append((name, hl, tuple(lvalues) + ("sum",), float(m.sum), "histogram"))
        else:
            out.append((name, tuple(lnames), tuple(lvalues), float(m.value), m.kind))

    for name, m in registry._items():
        if isinstance(m, MetricFamily):
            for values, child in m.children():
                one(name, m.labelnames, values, child)
        else:
            one(name, (), (), m)
    return out


# -- digests -------------------------------------------------------------------


def _collapse_in_lists(parts: List[str]) -> List[str]:
    """``in ( ? , ? , ? )`` -> ``in ( ... )``, so a statement's digest
    does not fragment by its IN list's length (digester.go). Only a list
    of placeholders collapses: ``in (select ...)`` and mixed lists keep
    their structure."""
    out: List[str] = []
    i = 0
    n = len(parts)
    while i < n:
        if parts[i] == "in" and i + 2 < n and parts[i + 1] == "(" and parts[i + 2] == "?":
            j = i + 3
            while j + 1 < n and parts[j] == "," and parts[j + 1] == "?":
                j += 2
            if j < n and parts[j] == ")":
                out.extend(("in", "(", "...", ")"))
                i = j + 1
                continue
        out.append(parts[i])
        i += 1
    return out


_LITERALS = frozenset(("num", "str"))


def digest_tokens(tokens) -> str:
    """The digest of a statement from its tokens: literals -> '?', IN
    lists of literals -> '( ... )', hints and ';' dropped (the hinted
    and unhinted forms share one digest), keywords lowercased, one space
    between tokens (parser digester.go)."""
    parts = []
    append = parts.append
    for t in tokens:
        kind = t.kind
        if kind in _LITERALS:
            append("?")
        elif kind == "kw":
            append(t.text.lower())
        elif kind == "op":
            if t.text != ";":
                append(t.text)
        elif kind == "eof":
            break
        elif kind != "hint":
            append(t.text)
    return " ".join(_collapse_in_lists(parts) if "in" in parts else parts)


def sql_digest(sql: str) -> str:
    """The digest of a statement's text (``digest_tokens`` over its
    tokens); text that does not tokenize is whitespace-collapsed."""
    try:
        from tidb_tpu_torch.parser.sqlparse import tokenize

        return digest_tokens(tokenize(sql))
    except Exception:
        return re.sub(r"\s+", " ", sql.strip())[:512]


# -- the slow log --------------------------------------------------------------


class SlowLog:
    """Ring buffer of the statements slower than the threshold, each
    with its flight's phase timeline and, where captured, its plan."""

    def __init__(self, capacity: int = 256):
        self._buf = collections.deque(maxlen=capacity)
        self._lock = racecheck.make_lock("metrics.slowlog")
        self._file_lock = racecheck.make_lock("metrics.slowlog_file")

    def record(self, sql: str, seconds: float, digest: str = "", conn_id: int = 0,
               phases: str = "", plan: str = "", log_file: Optional[str] = None) -> None:
        ts = time.time()
        with self._lock:
            self._buf.append((ts, sql[:2048], seconds, digest[:512], int(conn_id),
                              phases[:4096], plan[:16384]))
        if log_file:
            self._append_file(log_file, ts, sql, seconds, phases, plan)

    def _append_file(self, path, ts, sql, seconds, phases, plan) -> None:
        """The tidb_slow_query_file sink, in the reference's entry shape
        (`# Time` / `# Query_time` headers, a `# Plan` block, the
        statement ended by `;`). A failed write never fails the
        statement."""
        lines = [f"# Time: {time.strftime('%Y-%m-%dT%H:%M:%S', time.gmtime(ts))}Z",
                 f"# Query_time: {seconds:.6f}"]
        if phases:
            lines.append(f"# Phases: {phases}")
        if plan:
            lines.extend("# Plan: " + ln for ln in plan.splitlines())
        lines.append(sql.rstrip(";") + ";")
        try:
            with self._file_lock, open(path, "a", encoding="utf-8") as f:
                f.write("\n".join(lines) + "\n")
        except OSError:
            pass

    def rows(self) -> List[tuple]:
        """(time, query, query_time, digest, conn_id, phases, plan),
        oldest first."""
        with self._lock:
            return list(self._buf)

    def reset(self) -> None:
        with self._lock:
            self._buf.clear()


# -- the statement summary -----------------------------------------------------


class _StmtEntry:
    """One digest's aggregates: count, sum and max latency, its sample
    text, the latency histogram, and what its flights carried (phase
    sums, rows sent, plan-cache outcomes, the engine watch's columns)."""

    __slots__ = (
        "n", "sum_s", "max_s", "sample", "hist", "phases", "rows_sent", "plan_digest",
        "plan_cache_hits", "plan_cache_misses", "jit_compilations", "retraces", "h2d_bytes",
        "d2h_bytes", "device_mem_peak_bytes",
    )

    def __init__(self, sample: str):
        self.n = 0
        self.sum_s = 0.0
        self.max_s = 0.0
        self.sample = sample
        self.hist = StreamingHistogram("stmt_latency")
        #: phase name -> [sum seconds, bytes, retries]
        self.phases: Dict[str, list] = {}
        self.rows_sent = 0
        self.plan_digest = ""
        self.plan_cache_hits = 0
        self.plan_cache_misses = 0
        self.jit_compilations = 0
        self.retraces = 0
        self.h2d_bytes = 0
        self.d2h_bytes = 0
        self.device_mem_peak_bytes = 0

    def absorb_flight(self, flight) -> None:
        """Fold one finished QueryFlight (obs/flight.py) in."""
        for name, (s, b, r) in flight.phases.items():
            row = self.phases.setdefault(name, [0.0, 0, 0])
            row[0] += s
            row[1] += b
            row[2] += r
        self.rows_sent += int(flight.rows_sent)
        if flight.plan_digest:
            self.plan_digest = flight.plan_digest
        if flight.plan_cache == "hit":
            self.plan_cache_hits += 1
        elif flight.plan_cache == "miss":
            self.plan_cache_misses += 1
        self.jit_compilations += int(flight.jit_compilations)
        self.retraces += int(flight.retraces)
        self.h2d_bytes += int(flight.h2d_bytes)
        self.d2h_bytes += int(flight.d2h_bytes)
        self.device_mem_peak_bytes = max(self.device_mem_peak_bytes,
                                         int(flight.device_mem_peak_bytes))


def _entry_dict(digest: str, e: _StmtEntry) -> dict:
    """One digest's statements_summary row as a dict (also the snapshot
    an evicted digest leaves to the history). A percentile is at most
    the largest latency seen: interpolating inside a wide bucket can read
    past it (a 3.8 s cold run beside two 35 ms warm ones reads p99 as
    9.8 s), and the JAX package's rows do. The JAX package's compile-cost
    columns (XLA's analysis) and cardinality columns (estimated against
    observed rows of a statement routed across hosts) are 0 here: the
    port compiles nothing and routes nothing."""
    return {
        "digest_text": digest,
        "exec_count": e.n,
        "sum_latency": e.sum_s,
        "max_latency": e.max_s,
        "p50_latency": min(e.hist.quantile(0.50), e.max_s),
        "p95_latency": min(e.hist.quantile(0.95), e.max_s),
        "p99_latency": min(e.hist.quantile(0.99), e.max_s),
        "plan_digest": e.plan_digest,
        "phases": {p: list(v) for p, v in e.phases.items()},
        "rows_sent": e.rows_sent,
        "plan_cache_hits": e.plan_cache_hits,
        "plan_cache_misses": e.plan_cache_misses,
        "jit_compilations": e.jit_compilations,
        "retraces": e.retraces,
        "h2d_bytes": e.h2d_bytes,
        "d2h_bytes": e.d2h_bytes,
        "device_mem_peak_bytes": e.device_mem_peak_bytes,
        "compile_flops": 0.0,
        "compile_bytes_accessed": 0.0,
        "compile_output_bytes": 0.0,
        "est_rows": 0.0,
        "act_rows": 0.0,
        "card_divergence": 0.0,
        "sample_text": e.sample,
    }


class StmtSummary:
    """Per-digest aggregated statement stats (statement_summary.go:73),
    at most `capacity` digests: a new one evicts the least executed,
    whose aggregates go to the history."""

    def __init__(self, capacity: int = 512):
        self._capacity = capacity
        self._map: Dict[str, _StmtEntry] = {}
        self._lock = racecheck.make_lock("metrics.stmt_summary")
        #: the StmtHistory that absorbs evicted digests
        self.history: Optional["StmtHistory"] = None

    def record(self, sql: str, seconds: float, flight=None, digest: Optional[str] = None) -> None:
        d = digest if digest is not None else sql_digest(sql)
        evicted = None
        with self._lock:
            ent = self._map.get(d)
            if ent is None:
                if len(self._map) >= self._capacity:
                    victim = min(self._map, key=lambda k: self._map[k].n)
                    # the history's append runs after this lock is let go
                    # (stmt_summary -> stmt_history is the declared order)
                    evicted = _entry_dict(victim, self._map[victim])
                    del self._map[victim]
                ent = self._map[d] = _StmtEntry(sql[:256])
            ent.n += 1
            ent.sum_s += seconds
            ent.max_s = max(ent.max_s, seconds)
            ent.hist.observe(seconds)
            if flight is not None:
                ent.absorb_flight(flight)
        if evicted is not None and self.history is not None:
            self.history.absorb_evicted(evicted)

    def rows(self) -> List[Tuple[str, int, float, float, str]]:
        """(digest, count, sum, max, sample) per digest."""
        with self._lock:
            return [(d, e.n, e.sum_s, e.max_s, e.sample) for d, e in sorted(self._map.items())]

    def rows_full(self) -> List[dict]:
        """Every digest's full row (``_entry_dict``)."""
        with self._lock:
            return [_entry_dict(d, e) for d, e in sorted(self._map.items())]

    def reset(self) -> None:
        with self._lock:
            self._map.clear()


class StmtHistory:
    """Closed windows of statements_summary snapshots, read back as
    statements_summary_history; a digest the live summary evicted lands
    in the window that closes next. ``refresh_interval_s`` and the
    window count follow tidb_stmt_summary_refresh_interval and
    tidb_stmt_summary_history_size."""

    def __init__(self, max_windows: int = 24, refresh_interval_s: float = 1800.0):
        self._lock = racecheck.make_lock("metrics.stmt_history")
        #: closed windows, oldest first: (begin_ts, end_ts, [row dicts])
        self._windows: "collections.deque" = collections.deque(maxlen=max(int(max_windows), 1))
        self._pending_evicted: List[dict] = []
        self._open_t0 = time.time()
        self.refresh_interval_s = float(refresh_interval_s)

    def set_capacity(self, n: int) -> None:
        with self._lock:
            self._windows = collections.deque(self._windows, maxlen=max(int(n), 1))

    def absorb_evicted(self, row: dict) -> None:
        """A digest the live summary evicted (at most 4,096 wait)."""
        with self._lock:
            self._pending_evicted.append(dict(row))
            if len(self._pending_evicted) > 4096:
                self._pending_evicted.pop(0)

    def _close(self, rows, now: float) -> None:
        rows = rows + self._pending_evicted
        self._pending_evicted = []
        self._windows.append((self._open_t0, now, rows))
        self._open_t0 = now

    def rotate(self, summary: StmtSummary, now: Optional[float] = None) -> None:
        """Close the open window. The summary is read before this
        store's lock is taken: the two never nest."""
        rows = summary.rows_full()
        now = time.time() if now is None else float(now)
        with self._lock:
            self._close(rows, now)

    def maybe_rotate(self, summary: StmtSummary, now: Optional[float] = None) -> bool:
        """``rotate`` when the refresh interval has passed. The check and
        the append share one critical section, so two racing ticks never
        both close a window."""
        now = time.time() if now is None else float(now)
        with self._lock:
            if now - self._open_t0 < self.refresh_interval_s:
                return False
        rows = summary.rows_full()
        with self._lock:
            if now - self._open_t0 < self.refresh_interval_s:
                return False
            self._close(rows, now)
        return True

    def rows(self) -> List[tuple]:
        """(begin_ts, end_ts, row dict) per digest per closed window,
        oldest window first."""
        with self._lock:
            windows = list(self._windows)
        return [(b, e, dict(r)) for b, e, rows in windows for r in rows]

    def reset(self) -> None:
        with self._lock:
            self._windows.clear()
            self._pending_evicted = []
            self._open_t0 = time.time()


SLOW_LOG = SlowLog()
STMT_SUMMARY = StmtSummary()
STMT_HISTORY = StmtHistory()
STMT_SUMMARY.history = STMT_HISTORY
