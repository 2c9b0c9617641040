"""Partial/final aggregation stages.

Counterpart of the split in tidb_tpu/parallel/fragment.py: each aggregate
becomes partial-stage descriptors (run over one piece of the input: a
chunk of a table too large for one tile, or one device's shard) and a
final-stage rule that merges the partial rows (COUNT sums counts, AVG
sums its partial sums and counts and divides once). This slice ports the
part the streamed aggregation uses; the exchange-based mesh path belongs
to a later slice.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch

from tidb_tpu_torch.chunk import Batch, DevCol
from tidb_tpu_torch.executor.aggregate import AggDesc, _mix64

ExprFn = Callable[[Batch], DevCol]


def _colfn(name: str) -> ExprFn:
    return lambda b: b.cols[name]


def _partial_descs(
    aggs: Sequence[AggDesc],
) -> Tuple[List[AggDesc], List[Tuple[str, str, List[str], int, object]]]:
    """Split aggregates into partial-stage descriptors and final-stage
    combine rules: (final func name, out name, partial col names, scale,
    post-decode callable or None): the partial stage keeps MIN/MAX's
    encoded values and the final stage decodes them."""
    partial: List[AggDesc] = []
    final: List[Tuple[str, str, List[str], int, object]] = []
    for i, a in enumerate(aggs):
        if a.func == "count":
            pname = f"_p{i}"
            partial.append(AggDesc("count", a.arg, pname))
            final.append(("sum", a.out_name, [pname], 0, None))
        elif a.func == "sum":
            pname = f"_p{i}"
            # pack_bound holds at the partial stage (a per-row bound); the
            # final stage sums partial sums, whose bound is not per row
            partial.append(
                AggDesc("sum", a.arg, pname, wide=a.wide, pack_bound=a.pack_bound)
            )
            final.append(("sum", a.out_name, [pname], 0, None))
        elif a.func == "first":
            pname = f"_p{i}"
            partial.append(AggDesc("first", a.arg, pname))
            final.append(("first", a.out_name, [pname], 0, None))
        elif a.func in ("min", "max"):
            pname = f"_p{i}"
            partial.append(AggDesc(a.func, a.arg, pname))
            final.append((a.func, a.out_name, [pname], 0, a.post))
        elif a.func == "avg":
            sname, cname = f"_ps{i}", f"_pc{i}"
            partial.append(
                AggDesc("sum", a.arg, sname, wide=a.wide, pack_bound=a.pack_bound)
            )
            partial.append(AggDesc("count", a.arg, cname))
            final.append(("avg2", a.out_name, [sname, cname], a.arg_scale, None))
        else:
            raise NotImplementedError(f"distributed agg {a.func}")
    return partial, final


def build_final_stage(key_names, final):
    """Final-merge stage descriptors: key column readers, final AggDescs
    (avg split into sum + count), and post-division rules."""
    fkeys = [_colfn(n) for n in key_names]
    fdescs: List[AggDesc] = []
    post_avg: List[Tuple[str, str, str, int]] = []
    for func, out, pnames, scale, post in final:
        if func == "avg2":
            fdescs.append(AggDesc("sum", _colfn(pnames[0]), f"_fs_{out}"))
            fdescs.append(AggDesc("sum", _colfn(pnames[1]), f"_fc_{out}"))
            post_avg.append((out, f"_fs_{out}", f"_fc_{out}", scale))
        else:
            fdescs.append(AggDesc(func, _colfn(pnames[0]), out, post=post))
    return fkeys, fdescs, post_avg


def apply_post_avg(cols, post_avg):
    """AVG = SUM(partial sums) / SUM(partial counts), descaled for
    decimal args; drops the helper columns."""
    for out, sn, cn, scale in post_avg:
        s, c = cols[sn], cols[cn]
        denom = torch.where(c.data == 0, 1, c.data).to(torch.float64)
        if scale:
            denom = denom * (10**scale)
        cols[out] = DevCol(s.data.to(torch.float64) / denom, s.valid & (c.data > 0))
    for _out, sn, cn, _ in post_avg:
        cols.pop(sn, None)
        cols.pop(cn, None)
    return cols


def key_partition(cols: Sequence[DevCol], parts: int) -> torch.Tensor:
    """Partition id in [0, parts) of each row by its group key, `parts` a
    power of two: equal SQL keys (NULL keys included: their data is
    zeroed, validity mixed in) land in one partition, as the JAX
    package's ``_combined_key_hash`` routes them across devices."""
    n = cols[0].data.shape[0]
    h = torch.zeros(n, dtype=torch.int64, device=cols[0].data.device)
    for c in cols:
        hv = torch.where(c.valid, c.data.to(torch.int64), torch.zeros((), dtype=torch.int64,
                                                                      device=h.device))
        h = h * 1000003 ^ (hv * 2 + c.valid.to(torch.int64))
    # the mix spreads keys whose low bits repeat (dates, codes)
    return _mix64(h) & (parts - 1)
