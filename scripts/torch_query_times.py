"""Warm times of TPC-H queries through one checkout's PyTorch port, on CUDA.

    python3 scripts/torch_query_times.py ROOT q3,q10,q18 [--repeat 10] [--sf 10]
                                         [--topn sorted] [--sync-debug]
    python3 scripts/torch_query_times.py ROOT q95 --tpcds --sf 100

Imports ``tidb_tpu_torch`` from the checkout at ROOT (so two commits can
be compared inside one chip call: parent, change, change, parent),
generates the eight TPC-H tables with ``load_tpch(seed=1)``, ANALYZEs
them as chip_smoke.py does, and runs each named query of
``oracles.TPCH_QUERIES`` (or Q3) once cold and REPEAT times warm, each
run checked against its numpy oracle. Prints one JSON line: the card,
ROOT, and per query the warm times in ms. Needs a CUDA card. With
``--tpcds`` it generates the TPC-DS tables of BASELINE config #5 with
``load_tpcds(seed=1)`` instead (no ANALYZE, as chip_smoke.py runs them)
and runs TPC-DS Q95 ("q95").

``--topn sorted`` makes every ORDER BY ... LIMIT take the sorted path
(in a checkout whose planner has the packed top-N, its widths are
withheld), so the two top-N paths compare in one process. ``--sync-debug`` runs one
more warm run of each query under ``torch.cuda.set_sync_debug_mode``
and reports where operations made the host wait for the card
(file:line of each).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import warnings

TABLES = ["orders", "lineitem", "customer", "supplier", "nation", "region", "part", "partsupp"]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("root", help="checkout whose tidb_tpu_torch is measured")
    ap.add_argument("queries", help="comma-separated names: q3 or keys of TPCH_QUERIES")
    ap.add_argument("--repeat", type=int, default=10)
    ap.add_argument("--sf", type=float, default=10.0)
    ap.add_argument("--topn", choices=["auto", "sorted"], default="auto")
    ap.add_argument("--sync-debug", action="store_true")
    ap.add_argument("--tpcds", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("torch_query_times: no CUDA device", file=sys.stderr)
        return 2
    from tidb_tpu_torch.bench import load_tpch
    from tidb_tpu_torch.bench.oracles import Q3_SQL, TPCH_QUERIES, check_rows, numpy_q3, spec_params
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage import Catalog

    if args.topn == "sorted":
        from tidb_tpu_torch.planner.physical import PlanCompiler

        PlanCompiler._topn_widths = lambda self, keys, dicts: None

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    cat = Catalog()
    if args.tpcds:
        from tidb_tpu_torch.bench.tpcds import load_tpcds

        load_tpcds(cat, sf=args.sf, seed=1)
        sess = Session(cat, db="test")
    else:
        load_tpch(cat, sf=args.sf, seed=1, tables=TABLES)
        sess = Session(cat, db="tpch")
        for t in TABLES:
            sess.execute(f"analyze table {t}")
    out, syncs = {}, {}
    for name in args.queries.split(","):
        if name == "q95":
            from tidb_tpu_torch.bench.oracles import numpy_q95, same_value
            from tidb_tpu_torch.bench.tpcds import Q95_SQL

            sql = Q95_SQL
            want = numpy_q95(cat)

            def check(res, want=want):
                # the order count exactly, the sums within 1e-12 relative
                (got,) = [tuple(r) for r in res.rows]
                assert got[0] == want[0] and all(
                    (g is None and w is None) or same_value(g, w)
                    for g, w in zip(got[1:], want[1:])
                ), (got, want)
        elif name == "q3":
            sql = Q3_SQL
            want, _tied = numpy_q3(cat)

            def check(res, want=want):
                # revenue (scale 4) in ORDER BY order, exactly
                assert [r[1] for r in res.rows] == [int(w[1]) / 10**4 for w in want], res.rows
        else:
            q = TPCH_QUERIES[name]
            params = spec_params(name, args.sf)
            sql = q.sql.format(**params)
            want = q.oracle(cat, **params)

            def check(res, q=q, want=want):
                check_rows(res.rows, want, q.order, q.limit)
        check(sess.execute(sql))
        torch.cuda.synchronize()
        times = []
        for _ in range(args.repeat):
            t0 = time.perf_counter()
            res = sess.execute(sql)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            check(res)
        out[name] = times
        if args.sync_debug:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    sess.execute(sql)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs[name] = sorted({f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught})
    print(json.dumps({"card": card, "root": args.root, "topn": args.topn, "warm_ms": out,
                      "syncs": syncs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
