"""Collation engine: sort keys for MySQL collations.

Reference: pkg/util/collate/collate.go:66 — the Collator interface
(Compare / Key / KeyWithoutTrimRightSpace) with per-collation
implementations (binCollator, generalCICollator, unicodeCICollator...).
The columnar analog: a collation is a SORT-KEY function over strings;
the engine compares/sorts dictionary-coded columns through dense rank
LUTs built from these keys at compile time (one host pass over the
dictionary, zero per-row device cost beyond a gather).

Semantics implemented:
- *_bin / binary: identity (code order IS binary order — native).
- *_general_ci: per-character simple uppercase mapping (MySQL's
  general_ci compares by uppercasing each character) + PAD SPACE
  (trailing spaces ignored, like the reference's Key()).
- *_unicode_ci / *_0900_ai_ci: accent- and case-insensitive via NFKD
  decomposition with combining marks stripped, then casefold + PAD
  SPACE ('é' == 'e', 'ß' == 'ss' per casefold).
"""

from __future__ import annotations

import unicodedata
from typing import Callable, Optional

# collation name -> key function; None = binary (identity fast path)
_REGISTRY: dict = {}


def _pad(s: str) -> str:
    """PAD SPACE attribute: trailing spaces are insignificant."""
    return s.rstrip(" ")


def _general_ci_key(s: str) -> str:
    return _pad(s).upper()


def _unicode_ci_key(s: str) -> str:
    d = unicodedata.normalize("NFKD", _pad(s))
    return "".join(
        c for c in d if not unicodedata.combining(c)
    ).casefold()


def _bin_key(s: str) -> str:
    return s


for _name in (
    "utf8mb4_general_ci", "utf8_general_ci", "utf8mb3_general_ci",
    "latin1_general_ci", "latin1_swedish_ci", "ascii_general_ci",
):
    _REGISTRY[_name] = _general_ci_key
for _name in (
    "utf8mb4_unicode_ci", "utf8_unicode_ci", "utf8mb4_0900_ai_ci",
    "utf8mb4_unicode_520_ci",
):
    _REGISTRY[_name] = _unicode_ci_key
for _name in (
    "binary", "utf8mb4_bin", "utf8_bin", "utf8mb3_bin", "latin1_bin",
    "ascii_bin", "utf8mb4_0900_bin",
):
    _REGISTRY[_name] = None

#: charset -> its default collation. These are the REFERENCE's (TiDB)
#: defaults — new_collations_enabled_on_first_bootstrap=false ships
#: *_bin for every charset (pkg/parser/charset; MySQL 8.0 would pick
#: utf8mb4_0900_ai_ci) — so dumps restore with identical comparison
#: semantics.
CHARSET_DEFAULTS = {
    "utf8mb4": "utf8mb4_bin",
    "utf8": "utf8_bin",
    "utf8mb3": "utf8mb3_bin",
    "latin1": "latin1_bin",
    "ascii": "ascii_bin",
    "binary": "binary",
}


def known(name: str) -> bool:
    return name.lower() in _REGISTRY


def is_binary(name: Optional[str]) -> bool:
    return name is None or _REGISTRY.get(name.lower(), _bin_key) is None


def key_fn(name: Optional[str]) -> Callable[[str], str]:
    """Sort-key function for a collation name (identity for binary /
    unknown names — unknown should be rejected at DDL time)."""
    if name is None:
        return _bin_key
    f = _REGISTRY.get(name.lower())
    return _bin_key if f is None else f


def validate(name: str) -> str:
    n = name.lower()
    if n not in _REGISTRY:
        raise ValueError(f"Unknown collation: {name!r}")
    return n


def rank_lut(d, coll):
    """Group-key LUT over ONE dictionary: returns (lut, rep) where
    equal-under-collation entries share lut[code], and rep is a
    BINARY-SORTED dictionary of one representative per class (the
    binary-least member — MySQL permits any group member as the
    displayed GROUP BY value) with lut[code] its class's position in
    rep. Keeping rep binary-sorted keeps every downstream consumer
    that assumes sorted dictionaries (literal-compare searchsorted,
    binary ORDER BY on codes, nested re-aggregation) sound. Grouping
    by lut[code] instead of code is the columnar analog of hashing on
    Collator.Key() (reference pkg/util/collate/collate.go:66 — Key()
    drives both compare and hash); unlike the *comparison* rank LUTs
    (merge_rank_luts, kernels._collation_rank_lut) the codes here are
    NOT in collation order — only equality structure matters.
    Returns None for binary collations (identity). Memoized by
    (dictionary identity, collation): plan compilation asks for the
    same LUT from several sites (group keys, output dicts, arg
    wraps) and dictionaries are table-global and immutable."""
    import numpy as np

    if is_binary(coll):
        return None
    key = (id(d), (coll or "").lower())
    hit = _RANK_CACHE.get(key)
    if hit is not None and hit[0] is d:
        return hit[1]
    from tidb_tpu_torch.utils.failpoint import inject

    inject("collate/rank-lut")
    f = key_fn(coll)
    entries = [str(s) for s in d.tolist()]
    keys = [f(s) for s in entries]
    rep_of: dict = {}  # collation key -> binary-least member
    for s, k in zip(entries, keys):
        if k not in rep_of or s < rep_of[k]:
            rep_of[k] = s
    rep_sorted = sorted(rep_of.values())
    idx = {s: i for i, s in enumerate(rep_sorted)}
    lut = np.array([idx[rep_of[k]] for k in keys], dtype=np.int64)
    out = (lut, np.array(rep_sorted, dtype=object))
    while len(_RANK_CACHE) >= 32:
        _RANK_CACHE.pop(next(iter(_RANK_CACHE)))
    # the cached strong ref to `d` keeps its id from being reused
    _RANK_CACHE[key] = (d, out)
    return out


# (id(dict), collation) -> (dict strong ref, (lut, rep)); see rank_lut
_RANK_CACHE: dict = {}


def merge_rank_luts(da, db, coll):
    """Merge two dictionaries in collation-KEY space: returns
    (merged sorted key array, lut_a, lut_b) where lut_x[code] is the
    merged rank of dictionary x's entry — equal-under-collation values
    land on equal ranks. The ONE implementation behind string compare
    kernels and join-key alignment."""
    import numpy as np

    kf = key_fn(coll)
    ka = [kf(str(s)) for s in (da.tolist() if da is not None else [])]
    kb = [kf(str(s)) for s in (db.tolist() if db is not None else [])]
    merged = np.array(sorted(set(ka) | set(kb)), dtype=object)
    lut_a = (
        np.searchsorted(merged, np.array(ka, dtype=object)).astype(np.int64)
        if ka else np.zeros(1, np.int64)
    )
    lut_b = (
        np.searchsorted(merged, np.array(kb, dtype=object)).astype(np.int64)
        if kb else np.zeros(1, np.int64)
    )
    return merged, lut_a, lut_b
