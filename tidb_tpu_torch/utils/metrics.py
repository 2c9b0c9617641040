"""Statement digests.

Counterpart of tidb_tpu/utils/metrics.py, cut to ``sql_digest`` and its
normalizer (SQL bindings match a statement by its digest) and to the
normalized texts of the statements run in the process (``record_digest``,
``seen_digests``), which TIDB_DECODE_SQL_DIGESTS reads where the JAX
package reads its statement summary. The metrics registry, the slow log
and the statement summaries belong to a later slice (ROADMAP.md queue 1
item 6).
"""

from __future__ import annotations

import re
from collections import OrderedDict
from typing import List, Optional

from tidb_tpu_torch.utils import racecheck

class _SeenTexts:
    """The texts of the statements run, most recent last, each with its
    normalized text once asked for: normalizing costs about what parsing
    does, so it waits for TIDB_DECODE_SQL_DIGESTS instead of taxing every
    statement. Bounded by count, as the JAX package's statement summary
    is (512), and by characters (a 1,000-row INSERT is ~100 KB)."""

    def __init__(self, most: int = 512, max_chars: int = 8 << 20) -> None:
        self.most, self.max_chars = most, max_chars
        self.texts: "OrderedDict[str, Optional[str]]" = OrderedDict()
        self.chars = 0
        self.lock = racecheck.make_lock("metrics.seen_texts")

    def add(self, sql: str) -> None:
        with self.lock:
            if sql in self.texts:
                self.texts.move_to_end(sql)
                return
            self.texts[sql] = None
            self.chars += len(sql)
            while len(self.texts) > self.most or (
                    self.chars > self.max_chars and len(self.texts) > 1):
                old, _d = self.texts.popitem(last=False)
                self.chars -= len(old)

    def digests(self) -> List[str]:
        with self.lock:
            pending = [t for t, d in self.texts.items() if d is None]
        done = {t: sql_digest(t) for t in pending}
        with self.lock:
            for t, d in done.items():
                if t in self.texts:
                    self.texts[t] = d
            return list(dict.fromkeys(d for d in self.texts.values() if d is not None))


_SEEN = _SeenTexts()


def record_digest(sql: str) -> None:
    """Note a finished statement's text."""
    _SEEN.add(sql)


def seen_digests() -> List[str]:
    """The normalized texts of the statements noted, each once."""
    return _SEEN.digests()


def _collapse_in_lists(parts: List[str]) -> List[str]:
    """Collapse ``in ( ? , ? , ? )`` to ``in ( ... )`` so a statement's
    digest does not fragment per IN-list literal count (reference:
    digester.go reduces value lists to one `...` element — without
    this, `a IN (1,2)` and `a IN (1,2,3)` land in different
    statements_summary rows and the summary store fills with
    cardinality noise)."""
    out: List[str] = []
    i = 0
    n = len(parts)
    while i < n:
        if (
            parts[i] == "in"
            and i + 2 < n
            and parts[i + 1] == "("
            and parts[i + 2] == "?"
        ):
            # only a pure placeholder list collapses; `in (select …)`
            # and mixed-expression lists keep their structure
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


def sql_digest(sql: str) -> str:
    """Normalize a statement for summary grouping: literals -> '?',
    IN-lists of literals -> '(...)', whitespace collapsed, lowercased
    keywords (reference: parser digester.go)."""
    try:
        from tidb_tpu_torch.parser.sqlparse import tokenize

        parts = []
        for t in tokenize(sql):
            if t.kind in ("num", "str"):
                parts.append("?")
            elif t.kind == "hint" or (t.kind == "op" and t.text == ";"):
                # hints and statement separators are not semantic: the
                # hinted and unhinted forms of a query share one digest
                # (reference digester strips hints)
                continue
            elif t.kind == "eof":
                break
            else:
                parts.append(t.text.lower() if t.kind == "kw" else t.text)
        return " ".join(_collapse_in_lists(parts))
    except Exception:
        return re.sub(r"\s+", " ", sql.strip())[:512]
