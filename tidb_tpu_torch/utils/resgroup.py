"""Resource groups: request units (RU) per second for each group.

Counterpart of tidb_tpu/utils/resgroup.py (reference: TiDB resource
control, pkg/domain/resourcegroup). One token bucket per group, filled at
RU_PER_SEC and holding at most one second of fill. A statement is billed
after it runs, 1 RU per millisecond from the group's gate to its end, and
the bucket may go negative; the group's next statement waits
(``acquire``) until the bucket is back at zero. A BURSTABLE group never
waits, and the built-in ``default`` group is unlimited. The JAX
package's model adds 1 RU per KiB of a result shipped across hosts,
billed where it dispatches to a worker; at the statement's end it bills
time alone, as here.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from tidb_tpu_torch.utils import racecheck
from tidb_tpu_torch.utils.failpoint import inject


class ResourceGroup:
    def __init__(self, name: str, ru_per_sec: Optional[int], burstable: bool):
        self.name = name
        self.ru_per_sec = ru_per_sec  # None: unlimited (the default group)
        self.burstable = burstable
        self.tokens = float(ru_per_sec or 0)
        self.last_refill = time.monotonic()
        self.consumed_ru = 0.0
        self.queries = 0

    def _refill(self) -> None:
        now = time.monotonic()
        if self.ru_per_sec:
            self.tokens = min(float(self.ru_per_sec),
                              self.tokens + (now - self.last_refill) * self.ru_per_sec)
        self.last_refill = now


class ResourceGroupManager:
    """The groups of one catalog; ``default`` always exists."""

    def __init__(self):
        self._lock = racecheck.make_lock("resgroup")
        self.groups: Dict[str, ResourceGroup] = {"default": ResourceGroup("default", None, True)}

    @staticmethod
    def _check_rate(ru_per_sec):
        # 0 would read as unlimited; a group that may never run is a DROP
        if ru_per_sec is not None and ru_per_sec < 1:
            raise ValueError("RU_PER_SEC must be >= 1")

    def create(self, name, ru_per_sec, burstable, if_not_exists=False):
        name = name.lower()
        self._check_rate(ru_per_sec)
        with self._lock:
            if name in self.groups:
                if if_not_exists:
                    return
                raise ValueError(f"resource group {name!r} already exists")
            self.groups[name] = ResourceGroup(name, ru_per_sec, burstable)

    def alter(self, name, ru_per_sec=None, burstable=None):
        self._check_rate(ru_per_sec)
        with self._lock:
            g = self.groups.get(name.lower())
            if g is None:
                raise ValueError(f"unknown resource group {name!r}")
            if ru_per_sec is not None:
                g.ru_per_sec = ru_per_sec
                g.tokens = min(g.tokens, float(ru_per_sec))
            if burstable is not None:
                g.burstable = burstable

    def drop(self, name, if_exists=False):
        name = name.lower()
        if name == "default":
            raise ValueError("cannot drop the default resource group")
        with self._lock:
            if name not in self.groups:
                if if_exists:
                    return
                raise ValueError(f"unknown resource group {name!r}")
            del self.groups[name]

    def get(self, name: str) -> ResourceGroup:
        g = self.groups.get(name.lower())
        if g is None:
            raise ValueError(f"unknown resource group {name!r}")
        return g

    def acquire(self, name: str, kill_check=None, max_wait_s: float = 60.0) -> float:
        """Wait while the group's bucket is negative; returns the seconds
        waited. `kill_check` runs between polls (KILL, the deadline). A
        group dropped while a session was bound to it does not throttle."""
        g = self.groups.get(name.lower())
        if g is None:
            return 0.0
        t0 = time.monotonic()
        while True:
            with self._lock:
                g._refill()
                if g.burstable or not g.ru_per_sec or g.tokens >= 0:
                    return time.monotonic() - t0
            if kill_check is not None:
                kill_check()
            if time.monotonic() - t0 > max_wait_s:
                raise RuntimeError(
                    f"resource group {g.name!r} RU wait exceeded {max_wait_s:.0f}s")
            time.sleep(0.01)

    def debit(self, name: str, elapsed_s: float) -> float:
        """Bill a statement: the bucket may go negative, and the group's
        next statement then waits it out. Returns the RU billed."""
        inject("resgroup/debit")
        g = self.groups.get(name.lower())
        if g is None:  # dropped mid-statement: nothing to bill
            return 0.0
        ru = elapsed_s * 1000.0
        with self._lock:
            g._refill()
            if g.ru_per_sec:
                g.tokens -= ru
            g.consumed_ru += ru
            g.queries += 1
        return ru

    def rows(self):
        """information_schema.resource_groups' rows, by name."""
        with self._lock:
            return [(g.name, -1 if g.ru_per_sec is None else int(g.ru_per_sec),
                     "YES" if g.burstable else "NO", round(g.consumed_ru, 3), g.queries)
                    for g in sorted(self.groups.values(), key=lambda x: x.name)]
