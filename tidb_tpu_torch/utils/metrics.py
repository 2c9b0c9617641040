"""Statement digests.

Counterpart of tidb_tpu/utils/metrics.py, cut to ``sql_digest`` and its
normalizer: SQL bindings match a statement by its digest. The metrics
registry, the slow log and the statement summaries belong to a later
slice (ROADMAP.md queue 1 item 6).
"""

from __future__ import annotations

import re
from typing import List


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
