"""Per-value host functions of the JSON, regexp, INET/UUID and
AES/compress builtins.

Counterpart of the JAX package's expression/kernels.py ``_json_path_get``,
``_json_path_parts``, ``_json_set_path``, ``_json_remove_path``, the
merges, ``_json_pyfn`` and the binary members of ``_str_transform_pyfn``,
with their semantics and refusals. ``expression/kernels.py`` runs each
function once per distinct value of an input dictionary on the host and
gathers the result table on the device; None is SQL NULL.

Binary values (AES_ENCRYPT, COMPRESS, INET6_ATON, UUID_TO_BIN) ride
dictionary strings as the JAX package's do: bytes <-> str through
latin-1, a lossless bijection, so HEX() and the round trips compare
alike. A function may carry ``many``, a list-at-once form the transform
uses instead (AES over a whole dictionary in one numpy pass).
"""

from __future__ import annotations

import fnmatch
import ipaddress
import json
import re
import struct
import uuid
import zlib

from tidb_tpu_torch.utils import aes

_JSON_MISSING = object()

#: string-valued JSON functions: one host pass over the document's
#: dictionary (paths and new values are literals)
JSON_STR_FUNCS = {
    "json_extract", "json_unquote", "json_type", "json_keys",
    "json_set", "json_insert", "json_replace", "json_remove",
    "json_merge_patch", "json_merge_preserve", "json_merge",
    "json_array_append", "json_array_insert", "json_pretty",
    "json_search",
}

#: string -> string transforms of this module (the rest of the JAX
#: package's _STR_TRANSFORMS lives in kernels.py)
BINARY_TRANSFORMS = {
    "regexp_substr", "regexp_replace", "json_quote",
    "aes_encrypt", "aes_decrypt", "compress", "uncompress",
    "inet6_aton", "inet6_ntoa", "uuid_to_bin", "bin_to_uuid",
}


def b2s(b: bytes) -> str:
    return b.decode("latin-1")


def s2b(s: str) -> bytes:
    try:
        return s.encode("latin-1")
    except UnicodeEncodeError:
        return s.encode("utf-8")


def sql_like_match(value: str, pattern: str, ci: bool = False) -> bool:
    """SQL LIKE over fnmatch (% -> *, _ -> ?, fnmatch's metacharacters
    escaped); ci=True folds case, as SHOW ... LIKE does in MySQL."""
    pat = (
        pattern.replace("[", "[[]").replace("*", "[*]").replace("?", "[?]")
        .replace("%", "*").replace("_", "?")
    )
    if ci:
        return fnmatch.fnmatchcase(value.lower(), pat.lower())
    return fnmatch.fnmatchcase(value, pat)


# -- JSON paths ----------------------------------------------------------------


def json_path_get(doc, path: str):
    """Walk a MySQL-ish JSON path ($.a.b[0], $[1]."q k"); _JSON_MISSING
    where it leads nowhere or does not parse."""
    if not path.startswith("$"):
        return _JSON_MISSING
    toks = re.findall(r'\.([A-Za-z_][A-Za-z0-9_]*)|\[(\d+)\]|\."([^"]+)"', path[1:])
    consumed = sum(len(m) for m in re.findall(
        r'\.[A-Za-z_][A-Za-z0-9_]*|\[\d+\]|\."[^"]+"', path[1:]))
    if consumed != len(path) - 1:
        return _JSON_MISSING
    cur = doc
    for name, idx, qname in toks:
        key = name or qname
        if key:
            if isinstance(cur, dict) and key in cur:
                cur = cur[key]
            else:
                return _JSON_MISSING
        else:
            i = int(idx)
            if isinstance(cur, list) and i < len(cur):
                cur = cur[i]
            else:
                return _JSON_MISSING
    return cur


def json_path_parts(path: str):
    """'$.a[0].b' -> ['a', 0, 'b']; '$' -> []. Refuses wildcards, and a
    path whose segments do not tile it (MySQL raises ER_INVALID_JSON_PATH)."""
    if not path.startswith("$"):
        raise NotImplementedError(f"bad JSON path {path!r}")
    if "*" in path:
        raise NotImplementedError("JSON path wildcards")
    parts: list = []
    pos = 0
    body = path[1:]
    seg = re.compile(r"\.(\w+)|\.\"([^\"]+)\"|\[(\d+)\]")
    while pos < len(body):
        m = seg.match(body, pos)
        if m is None:
            raise NotImplementedError(f"invalid JSON path {path!r}")
        parts.append(int(m.group(3)) if m.group(3) is not None else (m.group(1) or m.group(2)))
        pos = m.end()
    return parts


def json_set_path(doc, parts, value, mode):
    """Set/insert/replace `value` at `parts` (in place where possible);
    mode in {'set', 'insert', 'replace', 'array_insert', 'array_append'}.
    MySQL: an unreachable path is a no-op, an array index past the end
    appends."""
    if not parts:
        if mode in ("set", "replace"):
            return value
        if mode == "array_append":
            # a root array appends; a root scalar or object is wrapped
            return doc + [value] if isinstance(doc, list) else [doc, value]
        return doc
    cur = doc
    for p in parts[:-1]:
        nxt = None
        if isinstance(p, int):
            if isinstance(cur, list) and p < len(cur):
                nxt = cur[p]
        elif isinstance(cur, dict) and p in cur:
            nxt = cur[p]
        if nxt is None or not isinstance(nxt, (dict, list)):
            return doc
        cur = nxt
    last = parts[-1]
    if mode == "array_append":
        tgt = None
        if isinstance(last, int):
            tgt = cur[last] if isinstance(cur, list) and last < len(cur) else None
        elif isinstance(cur, dict):
            tgt = cur.get(last)
        if tgt is None:
            return doc
        if isinstance(tgt, list):
            tgt.append(value)
        else:
            cur[last] = [tgt, value]
        return doc
    if isinstance(last, int):
        if not isinstance(cur, list):
            return doc
        if mode == "array_insert":
            cur.insert(min(last, len(cur)), value)
        elif last < len(cur):
            if mode in ("set", "replace"):
                cur[last] = value
        elif mode in ("set", "insert"):
            cur.append(value)
    else:
        if not isinstance(cur, dict):
            return doc
        exists = last in cur
        if mode == "set" or (mode == "insert" and not exists) or (mode == "replace" and exists):
            cur[last] = value
    return doc


def json_remove_path(doc, parts):
    if not parts:
        return doc
    cur = doc
    for p in parts[:-1]:
        if isinstance(p, int):
            if not (isinstance(cur, list) and p < len(cur)):
                return doc
        elif not (isinstance(cur, dict) and p in cur):
            return doc
        cur = cur[p]
    last = parts[-1]
    if isinstance(last, int):
        if isinstance(cur, list) and last < len(cur):
            del cur[last]
    elif isinstance(cur, dict):
        cur.pop(last, None)
    return doc


def json_merge_patch(a, b):
    """RFC 7396."""
    if not isinstance(b, dict):
        return b
    if not isinstance(a, dict):
        a = {}
    out = dict(a)
    for k, v in b.items():
        if v is None:
            out.pop(k, None)
        else:
            out[k] = json_merge_patch(out.get(k), v)
    return out


def json_merge_preserve(a, b):
    """MySQL JSON_MERGE_PRESERVE: arrays concatenate, objects merge
    recursively, scalars wrap into arrays."""
    if isinstance(a, dict) and isinstance(b, dict):
        out = dict(a)
        for k, v in b.items():
            out[k] = json_merge_preserve(out[k], v) if k in out else v
        return out
    la = a if isinstance(a, list) else [a]
    lb = b if isinstance(b, list) else [b]
    return la + lb


def _loads(s):
    try:
        return json.loads(s), True
    except Exception:
        return None, False


def json_str_fn(op: str, ex: list):
    """The per-value function of a string-valued JSON builtin over its
    document; `ex` are the literal values of its other arguments."""
    if op == "json_extract":
        if len(ex) != 1:
            raise NotImplementedError("json_extract supports exactly one path")
        path = str(ex[0])

        def f(s):
            doc, ok = _loads(s)
            if not ok:
                return None
            v = json_path_get(doc, path)
            return None if v is _JSON_MISSING else json.dumps(v)

        return f
    if op == "json_keys":
        def f(s):
            v, ok = _loads(s)
            return json.dumps(list(v.keys())) if ok and isinstance(v, dict) else None

        return f
    if op == "json_unquote":
        def f(s):
            if len(s) >= 2 and s[0] == '"' and s[-1] == '"':
                try:
                    return str(json.loads(s))
                except Exception:
                    return s
            return s

        return f
    if op == "json_remove":
        paths = [json_path_parts(str(p)) for p in ex]

        def f(s):
            doc, ok = _loads(s)
            if not ok:
                return None
            for parts in paths:
                doc = json_remove_path(doc, parts)
            return json.dumps(doc)

        return f
    if op in ("json_set", "json_insert", "json_replace", "json_array_append",
              "json_array_insert"):
        mode = op[len("json_"):]
        if len(ex) % 2:
            raise NotImplementedError(f"{op} needs (path, value) pairs")
        # a literal new value stays what it is (MySQL treats a non-JSON
        # typed argument as a plain string)
        pairs = [(json_path_parts(str(ex[i])), ex[i + 1]) for i in range(0, len(ex), 2)]

        def f(s):
            doc, ok = _loads(s)
            if not ok:
                return None
            for parts, val in pairs:
                doc = json_set_path(doc, parts, val, mode)
            return json.dumps(doc)

        return f
    if op in ("json_merge_patch", "json_merge_preserve", "json_merge"):
        merge = json_merge_patch if op == "json_merge_patch" else json_merge_preserve
        others = [_loads(str(a))[0] for a in ex]

        def f(s):
            doc, ok = _loads(s)
            if not ok:
                return None
            for o in others:
                doc = merge(doc, o)
            return json.dumps(doc)

        return f
    if op == "json_pretty":
        def f(s):
            doc, ok = _loads(s)
            return json.dumps(doc, indent=2) if ok else None

        return f
    if op == "json_search":
        # JSON_SEARCH(doc, 'one'|'all', search_str): the path of the first
        # matching string value, or every one
        one = str(ex[0]).lower() != "all"
        needle = str(ex[1])

        def f(s):
            doc, ok = _loads(s)
            if not ok:
                return None
            hits: list = []

            def walk(v, path):
                if isinstance(v, str) and sql_like_match(v, needle):
                    hits.append(path)
                elif isinstance(v, dict):
                    for k, vv in v.items():
                        walk(vv, path + (f".{k}" if re.fullmatch(r"\w+", k) else f'."{k}"'))
                elif isinstance(v, list):
                    for i, vv in enumerate(v):
                        walk(vv, f"{path}[{i}]")

            walk(doc, "$")
            if not hits:
                return None
            if one:
                return json.dumps(hits[0])
            return json.dumps(hits if len(hits) > 1 else hits[0])

        return f
    if op == "json_type":
        def f(s):
            v, ok = _loads(s)
            if not ok:
                return None
            if v is None:
                return "NULL"
            if isinstance(v, bool):
                return "BOOLEAN"
            if isinstance(v, int):
                return "INTEGER"
            if isinstance(v, float):
                return "DOUBLE"
            if isinstance(v, str):
                return "STRING"
            return "ARRAY" if isinstance(v, list) else "OBJECT"

        return f
    raise AssertionError(op)


# -- string -> string transforms -------------------------------------------------


def binary_transform_fn(op: str, ex: list):
    """The per-value function of a transform of BINARY_TRANSFORMS."""
    if op == "regexp_substr":
        if ex[0] is None:
            return lambda s: None
        rx = re.compile(str(ex[0]))

        def _rs(s):
            m = rx.search(s)
            return m.group(0) if m else None  # no match: SQL NULL

        return _rs
    if op == "regexp_replace":
        if ex[0] is None or ex[1] is None:
            return lambda s: None
        rx = re.compile(str(ex[0]))
        # MySQL's capture references are $N, Python's \N
        repl = re.sub(r"\$(\d)", r"\\\1", str(ex[1]))
        return lambda s: rx.sub(repl, s)
    if op == "json_quote":
        return json.dumps
    if op in ("aes_encrypt", "aes_decrypt"):
        key = aes.mysql_key(s2b(str(ex[0])))
        if op == "aes_encrypt":
            def _aes_e(s):
                return b2s(aes.encrypt_many([s2b(s)], key)[0])

            _aes_e.many = lambda ss: [b2s(b) for b in aes.encrypt_many([s2b(s) for s in ss], key)]
            return _aes_e

        def _aes_d(s):
            out = aes.decrypt_many([s2b(s)], key)[0]
            return None if out is None else b2s(out)

        _aes_d.many = lambda ss: [None if b is None else b2s(b)
                                  for b in aes.decrypt_many([s2b(s) for s in ss], key)]
        return _aes_d
    if op == "compress":
        def _comp(s):
            data = s2b(s)
            if not data:
                return ""  # MySQL: empty in, empty out
            # MySQL's format: the 4-byte little-endian length, then deflate
            return b2s(struct.pack("<I", len(data)) + zlib.compress(data))

        return _comp
    if op == "uncompress":
        def _uncomp(s):
            data = s2b(s)
            if not data:
                return ""
            if len(data) <= 4:
                return None
            try:
                n = struct.unpack("<I", data[:4])[0]
                out = zlib.decompress(data[4:])
            except Exception:
                return None
            return b2s(out) if len(out) == n else None

        return _uncomp
    if op == "inet6_aton":
        def _i6a(s):
            try:
                return b2s(ipaddress.ip_address(s).packed)
            except ValueError:
                return None

        return _i6a
    if op == "inet6_ntoa":
        def _i6n(s):
            b = s2b(s)
            try:
                if len(b) == 4:
                    return str(ipaddress.IPv4Address(b))
                if len(b) == 16:
                    return str(ipaddress.IPv6Address(b))
            except ValueError:
                pass
            return None

        return _i6n
    if op == "uuid_to_bin":
        def _u2b(s):
            try:
                return b2s(uuid.UUID(s).bytes)
            except ValueError:
                return None

        return _u2b
    if op == "bin_to_uuid":
        def _bu(s):
            b = s2b(s)
            return str(uuid.UUID(bytes=b)) if len(b) == 16 else None

        return _bu
    raise AssertionError(op)


# -- value-typed functions (ints and bools over a dictionary) -------------------

_UUID_RE = re.compile(
    r"^(\{[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-[0-9a-f]{4}-"
    r"[0-9a-f]{12}\}|[0-9a-f]{8}-[0-9a-f]{4}-[0-9a-f]{4}-"
    r"[0-9a-f]{4}-[0-9a-f]{12}|[0-9a-f]{32})$", re.I,
)


def is_uuid(s) -> bool:
    # MySQL: fully dashed, dash-free, or braced fully dashed only
    return bool(_UUID_RE.match(s))


def ip_predicate(op: str):
    def _ipfn(s):
        # every IPv6 text holds a ':' and no IPv4 text does: the parse
        # that would fail is skipped
        if op == "is_ipv4":
            if ":" in s:
                return False
            try:
                ipaddress.IPv4Address(s)
                return True
            except ValueError:
                return False
        if op == "is_ipv6":
            if ":" not in s:
                return False
            try:
                ipaddress.IPv6Address(s)
                return True
            except ValueError:
                return False
        # *_compat and *_mapped take the binary form (INET6_ATON's)
        b = s2b(s)
        if len(b) != 16:
            return False
        if op == "is_ipv4_compat":
            return b[:12] == b"\x00" * 12 and b[12:] != b"\x00\x00\x00\x00"
        return b[:10] == b"\x00" * 10 and b[10:12] == b"\xff\xff"

    return _ipfn


def uncompressed_length(s) -> int:
    b = s2b(s)
    return 0 if len(b) <= 4 else struct.unpack("<I", b[:4])[0]


def inet_aton(s) -> int:
    parts = s.split(".")
    if not 1 <= len(parts) <= 4 or not all(p.isdigit() and int(p) <= 255 for p in parts):
        return 0  # MySQL: NULL; the table carries values only, as the JAX package's
    # short forms: leading parts fill the top bytes, the last part the
    # rest ('1.2' = 1 << 24 | 2)
    v = 0
    for p in parts[:-1]:
        v = (v << 8) | int(p)
    return (v << (8 * (5 - len(parts)))) | int(parts[-1])


def json_contains_fn(cand, path):
    def _contains(s):
        try:
            doc = json.loads(s)
            target = json.loads(str(cand))
        except Exception:
            return False
        if path and str(path).startswith("$."):
            for part in str(path)[2:].split("."):
                if isinstance(doc, dict) and part in doc:
                    doc = doc[part]
                else:
                    return False

        def has(d, t):
            if d == t:
                return True
            if isinstance(d, list):
                return any(has(x, t) for x in d)
            return False

        return has(doc, target)

    return _contains


def json_valid(s) -> int:
    return 1 if _loads(s)[1] else 0


def json_length_fn(jpath):
    def _jl(s):
        v, ok = _loads(s)
        if not ok:
            return 0
        if jpath is not None:
            v = json_path_get(v, jpath)
            if v is _JSON_MISSING:
                return 0
        return len(v) if isinstance(v, (list, dict)) else 1

    return _jl


def json_depth(s) -> int:
    v, ok = _loads(s)
    if not ok:
        return 0

    def d(x):
        if isinstance(x, dict):
            return 1 + max((d(v2) for v2 in x.values()), default=0)
        if isinstance(x, list):
            return 1 + max((d(v2) for v2 in x), default=0)
        return 1

    return d(v)


def json_contains_path_fn(mode, paths):
    one = str(mode).lower() != "all"
    parsed = [json_path_parts(str(p)) for p in paths]

    def _jcp(s):
        doc, ok = _loads(s)
        if not ok:
            return False
        hits = []
        for parts in parsed:
            cur, hit = doc, True
            for p in parts:
                if isinstance(p, int):
                    if isinstance(cur, list) and p < len(cur):
                        cur = cur[p]
                    else:
                        hit = False
                        break
                elif isinstance(cur, dict) and p in cur:
                    cur = cur[p]
                else:
                    hit = False
                    break
            hits.append(hit)
        return any(hits) if one else all(hits)

    return _jcp


def json_storage_size(s) -> int:
    v, ok = _loads(s)
    return len(json.dumps(v).encode()) if ok else 0


def json_overlaps_fn(other_text):
    other = _loads(str(other_text))[0]

    def _jov(s):
        doc, ok = _loads(s)
        if not ok:
            return False
        a, b = doc, other
        if isinstance(a, list) and isinstance(b, list):
            return any(x in b for x in a)
        if isinstance(a, dict) and isinstance(b, dict):
            return any(k in b and b[k] == v for k, v in a.items())
        if isinstance(a, list):
            return b in a
        if isinstance(b, list):
            return a in b
        return a == b

    return _jov
