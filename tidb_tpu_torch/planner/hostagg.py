"""Host-assisted aggregation: GROUP_CONCAT.

Counterpart of tidb_tpu/planner/hostagg.py. String concatenation makes
variable-length values, host work where the engine's strings are
dictionary codes. The device still scans, filters and projects the
aggregate's inputs in one run of the plan below it; only the per-group
concatenation (and the node's other aggregates, in the same pass) runs on
the host over those projected rows. The reduced table is staged back onto
the device as a ``Staged`` node (as streamed aggregation stages its
result), so HAVING, ORDER BY and joins above the aggregate run as usual.

The JAX package reads no ``group_concat_max_len``, so neither does the
port: a group's value is never truncated.
"""

from __future__ import annotations

import functools
import json
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from tidb_tpu_torch.chunk import HostBlock, HostColumn, batch_to_block, block_to_batch, encode_strings
from tidb_tpu_torch.dtypes import Kind, days_to_date, micros_to_datetime, micros_to_time
from tidb_tpu_torch.planner import logical as L


def find_gc_agg(plan) -> Optional[L.Aggregate]:
    """The first (innermost, leftmost) aggregate holding a GROUP_CONCAT."""
    from tidb_tpu_torch.planner.physical import _plan_children

    for c in _plan_children(plan):
        found = find_gc_agg(c)
        if found is not None:
            return found
    if isinstance(plan, L.Aggregate) and plan.gc_meta:
        return plan
    return None


def _format_value(v, t) -> str:
    """MySQL string rendering of a value inside GROUP_CONCAT."""
    if t.kind == Kind.DATE:
        return days_to_date(int(v))
    if t.kind == Kind.DATETIME:
        return micros_to_datetime(int(v))
    if t.kind == Kind.TIME:
        return micros_to_time(int(v))
    if t.kind == Kind.DECIMAL:
        return f"{v:.{t.scale}f}"
    if t.kind == Kind.BOOL:
        return "1" if v else "0"
    if isinstance(v, float):
        if math.isfinite(v) and abs(v) < 1e15 and v == int(v):
            return str(int(v))
        return repr(v)
    return str(v)


def _json_cell(v, t):
    """SQL value -> JSON value for JSON_ARRAYAGG / JSON_OBJECTAGG: numbers
    native, temporals and decimals as their MySQL strings, NULL as null."""
    if v is None:
        return None
    if t.kind in (Kind.DATE, Kind.DATETIME, Kind.TIME, Kind.DECIMAL):
        return _format_value(v, t)
    if isinstance(v, (bool, int, float)):
        return v
    return str(v)


def _group_concat(vals, obs, decoded, distinct, sep, at):
    """One group's GROUP_CONCAT of (value, row) pairs, NULLs dropped:
    ordered by the ORDER BY columns (NULLs first ascending), deduplicated
    under DISTINCT keeping the first, joined by `sep`; NULL when empty."""
    if obs:

        def cmp(x, y):
            for nm, desc in obs:
                ax, ay = decoded[nm][x[1]], decoded[nm][y[1]]
                kx, ky = (ax is not None, ax), (ay is not None, ay)
                if kx != ky:
                    lt = kx < ky
                    return (1 if desc else -1) if lt else (-1 if desc else 1)
            return 0

        vals = sorted(vals, key=functools.cmp_to_key(cmp))
    if distinct:
        seen = set()
        vals = [v for v in vals if not (v[0] in seen or seen.add(v[0]))]
    return sep.join(_format_value(v, at) for v, _r in vals) if vals else None


def _reduce(func, vs, distinct):
    if distinct:
        vs = list(dict.fromkeys(vs))
    if func == "count":
        return len(vs)
    if not vs:
        return None
    if func == "sum":
        return sum(vs)
    if func == "avg":
        return sum(vs) / len(vs)
    if func == "min":
        return min(vs)
    if func == "max":
        return max(vs)
    if func == "first":
        return vs[0]
    raise NotImplementedError(f"host aggregate {func}")


def try_host_agg(executor, plan) -> Optional[Tuple[object, Dict]]:
    """Run `plan` when it holds a GROUP_CONCAT aggregate: the device runs
    the aggregate's input projection, the host reduces the groups (every
    aggregate of the node in one pass), the result is staged and the
    rest of the plan runs over it. None when there is no GROUP_CONCAT."""
    from tidb_tpu_torch.planner.streamed import _STAGED_NONCE, _replace_node

    agg = find_gc_agg(plan)
    if agg is None:
        return None
    gc_meta = agg.gc_meta or {}

    # 1. the device projects everything the reduction reads
    exprs: List[Tuple[str, object]] = list(agg.group_exprs)
    argname: Dict[int, str] = {}
    for i, (_n, _f, a, _d) in enumerate(agg.aggs):
        if a is not None:
            argname[i] = f"_x{i}"
            exprs.append((f"_x{i}", a))
    ordnames: Dict[str, List[Tuple[str, bool]]] = {}
    for name, (_sep, obs) in gc_meta.items():
        lst = []
        for j, (e, desc) in enumerate(obs):
            nm = f"_o_{name}_{j}"
            exprs.append((nm, e))
            lst.append((nm, desc))
        ordnames[name] = lst
    outc = [L.OutCol(None, nm, nm, e.type) for nm, e in exprs]
    sub = L.Projection(L.Schema(outc), agg.child, list(exprs))
    batch, dicts = executor.run(sub)
    types = {nm: e.type for nm, e in exprs}
    block = batch_to_block(batch, types, dicts)
    decoded = {nm: block.columns[nm].decode() for nm, _ in exprs}

    # 2. group on the host, in first-seen order
    keys = [n for n, _ in agg.group_exprs]
    groups: Dict[tuple, int] = {}
    rows_of: List[List[int]] = []
    order: List[tuple] = []
    key_cols = [decoded[n] for n in keys]
    for r in range(block.nrows):
        k = tuple(c[r] for c in key_cols)
        gi = groups.get(k)
        if gi is None:
            gi = groups[k] = len(order)
            order.append(k)
            rows_of.append([])
        rows_of[gi].append(r)
    if not keys and not order:
        # a scalar aggregate over no rows still yields one row
        order.append(())
        rows_of.append([])

    out_vals: Dict[str, List] = {n: [k[i] for k in order] for i, n in enumerate(keys)}
    for i, (name, func, a, distinct) in enumerate(agg.aggs):
        vals_out = out_vals[name] = []
        col = decoded[argname[i]] if a is not None else None
        at = types.get(argname.get(i))
        for rs in rows_of:
            if func == "count" and a is None:
                vals_out.append(len(rs))
            elif func == "json_arrayagg":
                # SQL NULLs become JSON nulls, as MySQL keeps them
                vals_out.append(json.dumps([_json_cell(col[r], at) for r in rs]) if rs else None)
            elif func == "json_objectagg":
                kcol = decoded[ordnames[name][0][0]]
                obj = {}
                for r in rs:
                    if kcol[r] is None:
                        raise ValueError("JSON documents may not contain NULL member names")
                    obj[str(kcol[r])] = _json_cell(col[r], at)
                vals_out.append(json.dumps(obj) if rs else None)
            elif func == "group_concat":
                vals = [(col[r], r) for r in rs if col[r] is not None]
                vals_out.append(_group_concat(vals, ordnames[name], decoded, distinct,
                                              gc_meta[name][0], at))
            else:
                vals_out.append(_reduce(func, [col[r] for r in rs if col[r] is not None], distinct))

    # 3. stage the reduced table back onto the device
    cols: Dict[str, HostColumn] = {}
    sdicts = {}
    for c in agg.schema:
        vals = out_vals[c.internal]
        t = c.type
        if t.kind == Kind.STRING:
            hc = encode_strings(vals)
            hc = HostColumn(t, hc.data, hc.valid, hc.dictionary)
            sdicts[c.internal] = hc.dictionary
        else:
            valid = np.array([v is not None for v in vals], dtype=bool)
            if t.kind == Kind.DECIMAL:
                data = np.array([0 if v is None else int(round(v * 10**t.scale)) for v in vals],
                                dtype=np.int64)
            else:
                data = np.array([0 if v is None else v for v in vals], dtype=t.np_dtype)
            hc = HostColumn(t, data, valid)
        cols[c.internal] = hc
    result = block_to_batch(HostBlock(cols, len(order)), device=executor.device)
    _STAGED_NONCE[0] += 1
    staged = L.Staged(agg.schema, batch=result, dicts=sdicts, nonce=_STAGED_NONCE[0])
    return executor.run(staged if plan is agg else _replace_node(plan, agg, staged))
