"""Per-statement memory accounting against a quota.

Counterpart of tidb_tpu/utils/memtrack.py. A statement's device buffers
have sizes known before it launches: each scanned column at its table's
tile, and each operator's output tile (a capacity knob times the bytes
of a row). The executor's admission (``PhysicalExecutor._admit``)
consumes every one of them in a tree of trackers under the quota
(``executor.quota_bytes``, TiDB's ``tidb_mem_quota_query``) before each
launch; a tracker that passes the quota raises ``QuotaExceeded``, and
the executor turns that into an error carrying the tree's report.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


class QuotaExceeded(RuntimeError):
    pass


@dataclasses.dataclass
class MemoryTracker:
    label: str
    quota_bytes: Optional[int] = None
    consumed: int = 0
    peak: int = 0
    children: List["MemoryTracker"] = dataclasses.field(default_factory=list)
    parent: Optional["MemoryTracker"] = None

    def child(self, label: str) -> "MemoryTracker":
        c = MemoryTracker(label, parent=self)
        self.children.append(c)
        return c

    def consume(self, nbytes: int) -> None:
        t = self
        while t is not None:
            t.consumed += nbytes
            t.peak = max(t.peak, t.consumed)
            if t.quota_bytes is not None and t.consumed > t.quota_bytes:
                raise QuotaExceeded(
                    f"memory quota exceeded at {t.label}: "
                    f"{t.consumed} > {t.quota_bytes} bytes"
                )
            t = t.parent

    def release(self, nbytes: int) -> None:
        t = self
        while t is not None:
            t.consumed -= nbytes
            t = t.parent

    def report(self, depth: int = 0) -> List[str]:
        lines = [
            "  " * depth
            + f"{self.label}: peak={self.peak} consumed={self.consumed}"
            + (f" quota={self.quota_bytes}" if self.quota_bytes else "")
        ]
        for c in self.children:
            lines.extend(c.report(depth + 1))
        return lines


def batch_bytes(capacity: int, col_dtypes: Dict[str, object]) -> int:
    """Static size of a Batch: data + validity per column + row mask."""
    total = capacity  # row_valid
    for dt in col_dtypes.values():
        total += capacity * (getattr(dt, "itemsize", 8) + 1)
    return total
