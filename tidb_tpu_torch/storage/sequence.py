"""SEQUENCE objects: value allocators with MINVALUE, MAXVALUE and CYCLE.

Counterpart of tidb_tpu/storage/sequence.py. Every allocation is exact
under one lock, so ``cache`` is metadata only (information_schema shows
it). The catalog holds sequences in the namespace of its tables and views.
"""

from __future__ import annotations

from typing import Optional

from tidb_tpu_torch.utils import racecheck
from tidb_tpu_torch.utils.failpoint import inject


class SequenceExhausted(ValueError):
    pass


class Sequence:
    def __init__(
        self,
        name: str,
        start: Optional[int] = 1,
        increment: int = 1,
        minvalue: Optional[int] = None,
        maxvalue: Optional[int] = None,
        cycle: bool = False,
        cache: int = 1000,
    ):
        if increment == 0:
            raise ValueError("sequence INCREMENT must be non-zero")
        self.name = name
        self.increment = int(increment)
        # ascending sequences run [1, 2^63-1], descending [-2^63+1, -1]
        if increment > 0:
            self.minvalue = int(minvalue) if minvalue is not None else 1
            self.maxvalue = int(maxvalue) if maxvalue is not None else (1 << 63) - 1
        else:
            self.minvalue = int(minvalue) if minvalue is not None else -(1 << 63) + 1
            self.maxvalue = int(maxvalue) if maxvalue is not None else -1
        if self.minvalue > self.maxvalue:
            raise ValueError("sequence MINVALUE exceeds MAXVALUE")
        self.start = int(start) if start is not None else self.minvalue
        if not (self.minvalue <= self.start <= self.maxvalue):
            raise ValueError("sequence START outside [MINVALUE, MAXVALUE]")
        self.cycle = bool(cycle)
        self.cache = int(cache)
        self._next: Optional[int] = self.start  # None: exhausted
        self._lock = racecheck.make_lock("sequence")

    def _after(self, v: int) -> Optional[int]:
        """The value after `v`: past a bound, the other bound when the
        sequence cycles (MINVALUE ascending, MAXVALUE descending, not
        START), else None."""
        n = v + self.increment
        if n > self.maxvalue or n < self.minvalue:
            if not self.cycle:
                return None
            n = self.minvalue if self.increment > 0 else self.maxvalue
        return n

    def nextval(self) -> int:
        inject("sequence/nextval")
        with self._lock:
            if self._next is None:
                raise SequenceExhausted(f"sequence {self.name!r} has run out")
            v = self._next
            self._next = self._after(v)
            return v

    def setval(self, v: int) -> int:
        """SETVAL(seq, v): the next NEXTVAL returns the value after v."""
        with self._lock:
            self._next = self._after(int(v))
            return int(v)

    def meta(self) -> dict:
        with self._lock:
            return {"start": self.start, "increment": self.increment,
                    "minvalue": self.minvalue, "maxvalue": self.maxvalue,
                    "cycle": self.cycle, "cache": self.cache, "next": self._next}

    @classmethod
    def from_meta(cls, name: str, m: dict) -> "Sequence":
        """The sequence a BACKUP manifest's ``meta()`` describes."""
        s = cls(name, start=m["start"], increment=m["increment"],
                minvalue=m["minvalue"], maxvalue=m["maxvalue"], cycle=m["cycle"],
                cache=m.get("cache", 1000))
        s._next = m.get("next", s.start)
        return s
