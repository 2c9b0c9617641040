"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py                  # TPC-H SF10 and SF100, as the port is measured
    python3 chip_smoke.py --profile out/   # plus a torch.profiler pass
    python3 chip_smoke.py --kernels        # phases 1-3 and 7 only, on
                                           # synthesized main-path inputs
    python3 chip_smoke.py --spill-only     # phases 1-3 and 8 only

1. Requires CUDA (exits 2 without a card) and prints the card's name and
   power limit.
2. Builds every kernel from tidb_tpu_torch/csrc/ (one nvcc per source, in
   parallel) and prints the build time and the -Xptxas -v report.
3. Holds each kernel against its plain PyTorch version on the card at edge
   shapes (each path's boundaries, ragged and misaligned inputs) and checks
   that slot_sums' float64 sums repeat bit for bit.
4. Generates the eight TPC-H tables with the port's load_tpch(seed=1).
5. Runs Q1, Q6 and an l_suppkey GROUP BY through Session on cuda, then
   ANALYZEs the eight tables (as bench.py does before measuring; the join
   order reads the statistics) and runs TPC-H Q3 and Q5, then the other
   18 TPC-H queries (oracles.TPCH_QUERIES, at the specification's
   substitution values for SF10): each query cold once and warm three
   times, each result checked against the numpy oracles of
   tidb_tpu_torch/bench/oracles.py.
6. Runs the window and set-operation reports W1-W5 and U1-U3
   (oracles.REPORT_QUERIES) on the same SF10 tables, then generates the
   TPC-DS tables of BASELINE config #5 at SF100 with the port's
   load_tpcds(seed=1) (7.2M web_sales rows, no ANALYZE, as bench.py runs
   it) and runs TPC-DS Q95: each cold once and warm three times, each run
   checked against its oracle. Each ORDER BY ... LIMIT prints the top-N
   path it took (packed key and its width, or sorted). No statement of
   phases 5 and 6 streams: SF10's tables fit one tile.
7. Times each kernel, its plain version and the one-call PyTorch equivalent
   on the inputs phases 5 and 6 gave it, and prints them beside the least
   time the card could take: the larger of the bytes these inputs need
   over 3.35 TB/s and their adds over 67 Top/s. Beside the time of a call
   (host work included, CUDA events around a loop of calls) stands the
   device time of its kernels alone (torch.profiler) and their launches
   per call.
8. Spill: frees the SF10 and TPC-DS tables and their device columns, then
   generates orders, lineitem, customer, supplier and nation at TPC-H SF100
   (BASELINE config #4: 600M lineitem rows, no cut of scale; only the
   columns the phase's statements read are kept, each equal to the full
   table's), ANALYZEs them, and runs TPC-H Q18 (quantity 300), Q1, Q21,
   the late-receipt report R1 (oracles.SPILL_REPORTS: a full ORDER BY of
   ~1M rows, no LIMIT) and Q1 under TiDB's default 1 GiB memory quota
   (tidb_mem_quota_query, the executor's quota_bytes): each cold once and
   warm three times, each run checked against the numpy oracles. Each
   exceeds the port's one-tile limit, so the executor's sizing sends it
   down a spill path (planner/streamed.py): Q18 and Q1 stream with their
   columns on the device, Q21 takes grace hash (its EXISTS and NOT EXISTS
   sides are lineitem too), R1 the host-merged ORDER BY, and the quota'd
   Q1 streams chunks from host RAM with its device allocation above its
   start within the quota. Each statement prints its spill records (path,
   mode, chunks or partitions, why, seconds per stage), its resident
   bytes after every run, its peak, and its host->device bytes and
   device->host fetches per warm run.
   Phases 5, 6 and 8 each show that every kernel launched there: launch
   counts are zeroed just before a phase's runs and read just after them.

With --kernels, phases 4-6 and 8 are skipped: phase 7 runs on inputs
shaped as the main path's (TPC-H Q1's slot_sums lanes at SF10, the
l_suppkey GROUP BY's prefix_sum), made from a seed, and prints its rows as
"kernel_times" with no launch counts, since no main path ran. With
--spill-only, phases 4-7 are skipped. Neither prints the last line.

Any failure raises; the last line is printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

#: TPC-H scale factor of the main path (lineitem ~ 6M rows per unit), the
#: SF10 that bench.py measures; lower it only if the time limit forces it
SF = 10.0
#: H100 SXM device-memory rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet), op/s:
#: the highest published rate of the scalar adds these kernels do (int64
#: and float64 adds run no faster)
SCALAR_OPS_PER_S = 67e12
#: the TPC-H tables the main path reads
TABLES = ["orders", "lineitem", "customer", "supplier", "nation", "region", "part", "partsupp"]
#: the table whose rows a query's rows/s counts: lineitem, unless the
#: query does not read it
BASE_TABLE = {"q2": "partsupp", "q11": "partsupp", "q13": "orders", "q16": "partsupp",
              "q22": "customer"}
#: TPC-DS scale factor of Q95, BASELINE config #5's SF100 (web_sales
#: 72,000 rows per unit)
TPCDS_SF = 100.0
#: float64 slot sums: summation order differs from the plain version, so
#: each slot may differ by this fraction of the sum of |values| in it (far
#: above the expected rounding, far below one lost or misplaced row)
F64_REL_TOL = 1e-10


def log(*a):
    print(*a, flush=True)


def bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take: the larger of moving `nbytes`
    at the memory rate and doing `ops` scalar adds at the peak rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / SCALAR_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


#: the port's kernel functions, as the profiler names them
PORT_KERNELS = ("slot_sums_private", "slot_sums_shared", "slot_sums_combine",
                "scan_single", "tile_sums", "scan_tile_sums", "tile_scan")


def device_ms(fn, reps: int):
    """Device time per call of the kernels `fn` launches, the host's work
    around them left out (torch.profiler), and each kernel's launches per
    call as recorded. Each kernel's time is its mean over the launches
    the profiler recorded times its whole launches per call, so a launch
    the profiler drops does not make the time read low. None where the
    profiler recorded no device time at all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    if not events:
        return None, {}
    total_us = sum(e.self_device_time_total / e.count * max(1, round(e.count / reps))
                   for e in events)
    return total_us / 1e3, {e.key[:90]: e.count / reps for e in events}


# ---------------------------------------------------------------------------
# kernel checks
# ---------------------------------------------------------------------------


def slot_sums_inputs(a, n, s, dtype, gen, offset=0, tail=0):
    """[a, n] lanes starting `offset` elements into their allocation
    (offset 1: no lane is 16-byte aligned), with the last `tail` rows
    outside the table, as a tile's padding is."""
    import torch

    dev = "cuda"
    if dtype == torch.int64:
        flat = torch.randint(-1000, 1000, (a * n + offset,), generator=gen, device=dev, dtype=torch.int64)
    else:
        flat = torch.randn((a * n + offset,), generator=gen, device=dev, dtype=torch.float64)
    values = flat[offset:].view(a, n)
    contrib = (torch.rand((a * n + offset,), generator=gen, device=dev) < 0.8)[offset:].view(a, n)
    # ids past the table (the overflow slot and beyond) are dropped
    seg = torch.randint(0, s + 2, (n + offset,), generator=gen, device=dev, dtype=torch.int32)[offset:]
    if tail:
        seg[n - tail:] = s
    return values, contrib, seg


def check_slot_sums(values, contrib, seg, s) -> float:
    """Kernel vs plain on one input; returns the max abs difference."""
    import torch

    from tidb_tpu_torch.executor import kernels as K

    got = K.slot_sums(values, contrib, seg, s)
    want = K.slot_sums_plain(values, contrib, seg, s)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, want.shape)
    if values.dtype == torch.int64:
        assert torch.equal(got, want), f"slot_sums int64 mismatch at {tuple(values.shape)}, S={s}"
        return 0.0
    scale = K.slot_sums_plain(values.abs(), contrib, seg, s)
    err = (got - want).abs()
    assert bool((err <= F64_REL_TOL * scale + 1e-12).all()), (
        f"slot_sums float64 mismatch at {tuple(values.shape)}, S={s}: {float(err.max())}"
    )
    return float(err.max())


def check_prefix_sum(x) -> None:
    import torch

    from tidb_tpu_torch.executor import kernels as K

    got = K.prefix_sum(x)
    want = K.prefix_sum_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(got, want), f"prefix_sum mismatch at n={x.shape[0]}, {x.dtype}"


def kernel_edge_checks(big_n: int) -> None:
    import torch

    from tidb_tpu_torch.executor import kernels as K

    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    t0 = time.perf_counter()
    worst = 0.0
    # slots: both sides of the private path's 32 and the 128-slot gate
    for dtype in (torch.int64, torch.float64):
        for a in (1, 16):
            for n in (1, 1023, 1025, big_n):
                for s in (1, 16, 32, 33, 128):
                    tail = n // 9 if n == big_n else 0
                    v, c, g = slot_sums_inputs(a, n, s, dtype, gen, tail=tail)
                    worst = max(worst, check_slot_sums(v, c, g, s))
                    del v, c, g
            for n in (1025, 1_000_003):
                for s in (16, 33):
                    v, c, g = slot_sums_inputs(a, n, s, dtype, gen, offset=1)
                    worst = max(worst, check_slot_sums(v, c, g, s))
    # the private path's float64 sums are taken in a fixed order
    for s in (1, 16, 32):
        v, c, g = slot_sums_inputs(16, big_n, s, torch.float64, gen, tail=big_n // 9)
        first = K.slot_sums(v, c, g, s)
        assert torch.equal(first, K.slot_sums(v, c, g, s)), f"slot_sums float64 not repeatable, S={s}"
        del v, c, g
    # exact small-integer counts, as the TPU kernel's test pins them
    ones = torch.ones((1, 4096), dtype=torch.int64, device="cuda")
    seg = (torch.arange(4096, device="cuda") % 3).to(torch.int32)
    got = K.slot_sums(ones, torch.ones_like(ones, dtype=torch.bool), seg, 3)
    assert got.tolist() == [[1366, 1365, 1365]], got.tolist()
    log(f"slot_sums: edge shapes pass (float64 max abs err {worst:.3g}, "
        f"rel tol {F64_REL_TOL}; float64 repeatable) in {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    # both sides of the one-block launch's 2^17; offset 1: misaligned
    for n in (1, 16, 1000, 2**17 - 1, 2**17, 2**17 + 1, 2**26 + 7):
        for offset in (0, 1):
            x = torch.rand(n + offset, generator=gen, device="cuda") < 0.3
            check_prefix_sum(x[offset:])
            xi = torch.randint(0, 5, (n + offset,), generator=gen, device="cuda", dtype=torch.int32)
            check_prefix_sum(xi[offset:])
    log(f"prefix_sum: edge shapes pass in {time.perf_counter() - t0:.1f}s")


# ---------------------------------------------------------------------------
# main path
# ---------------------------------------------------------------------------


def raw_columns(cat, names):
    t = cat.table("tpch", "lineitem")
    (b,) = t.blocks()
    return {n: b.columns[n].data for n in names}, t


def q1_check(blk, t):
    """A check of Q1's rows against numpy_q1, computed on first use and
    kept for the query's later runs."""
    from tidb_tpu_torch.bench.oracles import numpy_q1

    oracle = []

    def check(res):
        if not oracle:
            t0 = time.perf_counter()
            oracle.append(numpy_q1(blk))
            log(f"  oracle: Q1 in {time.perf_counter() - t0:.1f}s")
        check_q1(res, oracle[0], t)

    return check


def check_q1(res, o, t):
    rf, ls = t.dictionaries["l_returnflag"], t.dictionaries["l_linestatus"]
    want = []
    for k in range(6):
        if o["cnt"][k] == 0:
            continue
        want.append((rf[k // 2], ls[k % 2], k))
    assert [(r[0], r[1]) for r in res.rows] == [(a, b) for a, b, _k in want], res.rows
    for row, (_a, _b, k) in zip(res.rows, want):
        assert row[2] == o["sum_qty"][k] / 100, (row, k)
        assert row[3] == o["sum_base"][k] / 100, (row, k)
        # the engine sums this scale-4 product in two int64 limbs and
        # returns a float64 (as the JAX package does): exact while the
        # sum is below 2^53, the float gate's 1e-12 relative above (SF100)
        if abs(int(o["sum_disc"][k])) < 1 << 53:
            assert row[4] == o["sum_disc"][k] / 10**4, (row, k)
        else:
            assert np.isclose(row[4], o["sum_disc"][k] / 10**4, rtol=1e-12, atol=0), (row, k)
        assert np.isclose(row[5], o["sum_charge"][k] / 10**6, rtol=1e-12, atol=0), (row, k)
        assert np.isclose(row[6], o["avg_qty"][k] / 100, rtol=1e-12, atol=0), (row, k)
        assert np.isclose(row[7], o["avg_base"][k] / 100, rtol=1e-12, atol=0), (row, k)
        assert np.isclose(row[8], o["avg_disc"][k] / 100, rtol=1e-12, atol=0), (row, k)
        assert row[9] == o["cnt"][k], (row, k)


def check_q6(res, blk):
    from tidb_tpu_torch.bench.oracles import numpy_q6

    assert len(res.rows) == 1 and res.rows[0][0] == np.int64(numpy_q6(blk)) / 10**4, res.rows


def check_suppkey(res, blk):
    from tidb_tpu_torch.bench.oracles import numpy_suppkey

    keys, cnt, qty = numpy_suppkey(blk)
    got = sorted(res.rows)
    assert len(got) == len(keys), (len(got), len(keys))
    assert [r[0] for r in got] == keys.tolist()
    assert [r[1] for r in got] == cnt.tolist()
    assert [r[2] for r in got] == (qty / 100).tolist()


def present_date(days: int) -> str:
    return str(np.datetime64(int(days), "D"))


def check_q3(res, cat):
    """Rows equal numpy_q3 in ORDER BY order: (revenue, o_orderdate)
    exactly in sequence, whole rows as a multiset within each run of
    equal (revenue, o_orderdate), and rows tying the last one drawn from
    every group that ties it."""
    from tidb_tpu_torch.bench.oracles import numpy_q3

    want, tied = numpy_q3(cat)

    def shown(r):
        return (r[0], np.int64(r[1]) / 10**4, present_date(r[2]), r[3])

    got = [tuple(r) for r in res.rows]
    assert len(got) == len(want), (len(got), len(want))
    assert [(g[1], g[2]) for g in got] == [shown(w)[1:3] for w in want], (got, want)
    last = shown(want[-1])[1:3] if want else None
    rest = sorted(g for g in got if (g[1], g[2]) != last)
    assert rest == sorted(shown(w) for w in want if shown(w)[1:3] != last), (got, want)
    pool = [shown(t) for t in tied]
    for g in got:
        if (g[1], g[2]) == last:
            assert g in pool, (g, pool)


def check_q5(res, cat):
    """Rows equal numpy_q5: (n_name, revenue) per nation with revenue,
    in ORDER BY revenue desc."""
    from tidb_tpu_torch.bench.oracles import numpy_q5

    rev = numpy_q5(cat)
    (nb,) = cat.table("tpch", "nation").blocks()
    names = nb.columns["n_name"].dictionary[nb.columns["n_name"].data]
    by_key = dict(zip(nb.columns["n_nationkey"].data.tolist(), names))
    want = [(by_key[k], np.int64(rev[k]) / 10**4)
            for k in sorted(np.flatnonzero(rev > 0), key=lambda k: -rev[k])]
    assert [tuple(r) for r in res.rows] == want, (res.rows, want)


def oracle_check(cat, q, params):
    """A check of a TPCH_QUERIES result against its oracle, computed on
    first use and kept for the query's later runs."""
    from tidb_tpu_torch.bench.oracles import check_rows

    want = []

    def check(res):
        if not want:
            t0 = time.perf_counter()
            want.append(q.oracle(cat, **params))
            log(f"  oracle: {len(want[0])} rows in {time.perf_counter() - t0:.1f}s")
        check_rows(res.rows, want[0], q.order, q.limit)

    return check


def profile_query(sess, name, sql, out_dir) -> None:
    """Device time by kernel over one warm run, the device's busy share of
    the run's wall time, and the port's kernels launched in it beside its
    wrappers' launch counts."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from tidb_tpu_torch.executor import kernels as K

    torch.cuda.synchronize()
    l0 = dict(K.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sess.execute(sql)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    # device-side events only (kernels and copies): operator rows repeat
    # their kernels' time
    events = [
        e for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
    ]
    busy_us = sum(e.self_device_time_total for e in events)
    events.sort(key=lambda e: -e.self_device_time_total)
    top = [(e.key[:60], e.count, round(e.self_device_time_total / 1e3, 3)) for e in events[:12]]
    log(f"profile {name}: wall {wall * 1e3:.2f} ms, device busy {busy_us / 1e3:.2f} ms "
        f"({100 * busy_us / 1e6 / wall:.1f}%), top kernels (name, calls, ms): {top}")
    port = {e.key[:90]: (e.count, round(e.self_device_time_total / 1e3, 4))
            for e in events if any(k in e.key for k in PORT_KERNELS)}
    log(f"profile {name}: wrapper launches {({k: K.LAUNCHES[k] - l0[k] for k in l0})}, "
        f"port kernels (name: calls, ms) {port}")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_{name}.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=40))


def synthetic_inputs():
    """Inputs shaped as the main path gives them, made from a seed: TPC-H
    Q1's slot_sums lanes at SF10 (A=16 int64, a 2^26-row tile with its
    last 7,108,864 rows padding, 4 live slots of 16) and the l_suppkey
    GROUP BY's prefix_sum (2^17 bools)."""
    import torch

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    n, rows, s = 1 << 26, 60_000_000, 16
    live = torch.tensor([5, 6, 9, 13], dtype=torch.int32, device="cuda")
    seg = live[torch.randint(0, 4, (n,), generator=gen, device="cuda")]
    seg[rows:] = s
    # Q1's WHERE drops about 1.5% of the rows: their slot is the overflow
    seg[torch.rand(n, generator=gen, device="cuda") < 0.015] = s
    values = torch.randint(0, 10**7, (16, n), generator=gen, device="cuda")
    contrib = (seg < s).expand(16, n).contiguous()
    occupied = torch.rand(1 << 17, generator=gen, device="cuda") < 0.76
    return {"slot_sums": (values, contrib, seg, s), "prefix_sum": (occupied,)}


def kernel_rows(seen, launches):
    """Check and time each kernel on the input the main path gave it;
    `launches` holds the main path's launch counts (None: the caller
    fills them in, or no main path ran)."""
    import torch

    from tidb_tpu_torch.executor import kernels as K

    kernels = []
    v, c, g, s = seen["slot_sums"]
    err = check_slot_sums(v, c, g, s)
    a, n = v.shape
    in_table = (g >= 0) & (g < s)
    idx = torch.where(in_table, g, s).to(torch.int64)
    masked = torch.where(c, v, torch.zeros((), dtype=v.dtype, device=v.device))
    lib_out = torch.zeros((a, s + 1), dtype=v.dtype, device=v.device)
    # what this run's data needs: every slot id, the contrib flags of rows
    # inside the table, one value and one add per contributing entry, and
    # the [A, S] table written once
    rows_in = int(in_table.sum())
    adds = int((c & in_table).sum())
    nbytes = 4 * n + a * rows_in + adds * v.element_size() + a * s * v.element_size()
    dev_ms, per_call = device_ms(lambda: K.slot_sums(v, c, g, s), 10)
    kernels.append({
        "name": "slot_sums", "route": "cuda",
        "source": "tidb_tpu_torch/csrc/slot_sums.cu",
        "replaces": "tidb_tpu/executor/pallas_kernels.py:67",
        "launches": launches and launches["slot_sums"], "max_abs_err": err,
        "ms": cuda_time_ms(lambda: K.slot_sums(v, c, g, s), 10),
        "device_ms": dev_ms, "kernels_per_call": per_call,
        "plain_ms": cuda_time_ms(lambda: K.slot_sums_plain(v, c, g, s), 10),
        **bound(nbytes, adds),
        "library_ms": cuda_time_ms(lambda: lib_out.index_add_(1, idx, masked), 10),
        "shape": {"A": a, "N": n, "S": s, "dtype": str(v.dtype)},
    })
    del v, c, g, in_table, idx, masked, lib_out
    (x,) = seen["prefix_sum"]
    check_prefix_sum(x)
    n = x.shape[0]
    dev_ms, per_call = device_ms(lambda: K.prefix_sum(x), 50)
    lib_dev_ms, _ = device_ms(lambda: torch.cumsum(x, 0, dtype=torch.int32), 50)
    kernels.append({
        "name": "prefix_sum", "route": "cuda",
        "source": "tidb_tpu_torch/csrc/prefix_sum.cu",
        "replaces": "tidb_tpu/executor/pallas_kernels.py:192",
        "launches": launches and launches["prefix_sum"], "max_abs_err": 0.0,
        "ms": cuda_time_ms(lambda: K.prefix_sum(x), 50),
        "device_ms": dev_ms, "kernels_per_call": per_call,
        "plain_ms": cuda_time_ms(lambda: K.prefix_sum_plain(x), 50),
        **bound(n * (x.element_size() + 4), n),
        "library_ms": cuda_time_ms(lambda: torch.cumsum(x, 0, dtype=torch.int32), 50),
        "library_device_ms": lib_dev_ms,
        "shape": {"n": n, "dtype": str(x.dtype)},
    })
    # prefix_sum at Q1's 16 slots, and past the one-block launch at the
    # largest edge shape, where launch overhead does not hide the kernel
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    for label, reps, xs in (("16", 50, torch.rand(16, generator=gen, device="cuda") < 0.3),
                            ("2^26+7", 20, torch.rand(2**26 + 7, generator=gen, device="cuda") < 0.3)):
        dev_ms, per_call = device_ms(lambda: K.prefix_sum(xs), reps)
        log(f"prefix_sum at n={label}: " + json.dumps({
            "ms": cuda_time_ms(lambda: K.prefix_sum(xs), reps),
            "device_ms": dev_ms, "kernels_per_call": per_call,
            "plain_ms": cuda_time_ms(lambda: K.prefix_sum_plain(xs), reps),
            "library_ms": cuda_time_ms(lambda: torch.cumsum(xs, 0, dtype=torch.int32), reps),
            "library_device_ms": device_ms(lambda: torch.cumsum(xs, 0, dtype=torch.int32), reps)[0],
            **bound(xs.numel() * 5, xs.numel()),
        }))
    return kernels


#: the TPC-DS tables Q95 reads
TPCDS_TABLES = ["web_sales", "web_returns", "date_dim", "customer_address", "web_site"]


def q95_check(cat):
    """Q95's rows against the vectorized oracle: the order count exactly,
    the sums (cents) within 1e-12 relative."""
    from tidb_tpu_torch.bench.oracles import numpy_q95, same_value

    want = []

    def check(res):
        if not want:
            t0 = time.perf_counter()
            want.append(numpy_q95(cat))
            log(f"  oracle: {want[0]} in {time.perf_counter() - t0:.1f}s")
        (got,) = [tuple(r) for r in res.rows]
        assert got[0] == want[0][0] and all(
            (g is None and w is None) or same_value(g, w) for g, w in zip(got[1:], want[0][1:])
        ), (got, want[0])

    return check


def run_phase(queries, report, base_table, before=None) -> dict:
    """Run each (name, sql, check, session) cold once and warm three
    times, checking every run, and add its numbers to `report`. Kernel
    launch counts are zeroed just before the phase and returned as read
    just after it."""
    import torch

    from tidb_tpu_torch.chunk import TRANSFERS
    from tidb_tpu_torch.executor import kernels as K

    K.reset_launches()
    for name, sql, check, qs in queries:
        if before is not None:
            before(name)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        l0 = dict(K.LAUNCHES)
        t0 = time.perf_counter()
        res = qs.execute(sql)
        torch.cuda.synchronize()
        cold = time.perf_counter() - t0
        check(res)
        after = [torch.cuda.memory_allocated()]
        paths = [[(r["path"], r["mode"]) for r in qs.executor.stream_log]]
        peaks = [torch.cuda.max_memory_allocated()]
        warm = []
        f0, h0 = TRANSFERS["d2h_fetches"], TRANSFERS["h2d_bytes"]
        for _ in range(3):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = qs.execute(sql)
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - t0)
            peaks.append(torch.cuda.max_memory_allocated())
            check(res)
            after.append(torch.cuda.memory_allocated())
            paths.append([(r["path"], r["mode"]) for r in qs.executor.stream_log])
        table = base_table(name)
        report[name] = {
            "rows": len(res.rows),
            "cold_s": cold,
            "warm_s": warm,
            "rows_per_s": table.nrows / float(np.median(warm)),
            "rows_of": table.name,
            # the peak includes what was resident before the query: cached
            # columns of earlier queries and the kernel inputs kept for phase 7
            "max_memory_allocated": max(peaks),
            # the peak of the cold run and of each warm run (each from the
            # allocation at its start: a cold run may first release columns)
            "peaks": peaks,
            "resident_before": resident,
            # allocated after the cold run and after each warm run
            "resident_after": after,
            "d2h_fetches_per_warm_run": (TRANSFERS["d2h_fetches"] - f0) / 3,
            "h2d_bytes_per_warm_run": (TRANSFERS["h2d_bytes"] - h0) / 3,
            # the last run's spill records (streamed aggregates, grace-hash
            # pipelines, host-merged ORDER BYs), and each run's (path, mode)
            "stream": qs.executor.stream_log,
            "stream_paths": paths,
            "launches": {k: K.LAUNCHES[k] - l0[k] for k in K.LAUNCHES},
            # each ORDER BY ... LIMIT of the statement: ["packed", key bits]
            # or ["sorted", null]; null when the host merged the ORDER BY
            "topn": getattr(qs.executor.last_compiled, "topn", None),
        }
        log(f"{name}: " + json.dumps(report[name]))
    return dict(K.LAUNCHES)


#: TPC-H scale factor of the spill phase: BASELINE config #4's SF100, no cut
SPILL_SF = 100.0
#: the columns Q1, Q18, Q21 and R1 read of the spill phase's tables: the
#: full tables would take about 75 GB of host RAM (lineitem alone 116
#: bytes a row), the kept columns about 48 GB
SPILL_COLUMNS = {
    "orders": ["o_orderkey", "o_custkey", "o_totalprice", "o_orderdate", "o_orderstatus"],
    "lineitem": ["l_orderkey", "l_quantity", "l_extendedprice", "l_discount", "l_tax",
                 "l_returnflag", "l_linestatus", "l_shipdate", "l_suppkey", "l_receiptdate",
                 "l_commitdate"],
    "customer": ["c_custkey"],
    "supplier": ["s_suppkey", "s_nationkey"],
    "nation": ["n_nationkey", "n_name"],
}
#: TiDB's default tidb_mem_quota_query (1 GiB), the quota'd Q1's
SPILL_QUOTA = 1 << 30


def host_memory() -> str:
    """MemAvailable and this process's peak resident set, in GB."""
    import resource

    avail = 0
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) * 1024
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    return f"MemAvailable {avail / 1e9:.1f} GB, peak RSS {peak / 1e9:.1f} GB"


def sf10_phases(args, seen, report) -> dict:
    """Phases 4-6: TPC-H at SF10, the reports and TPC-DS Q95, recording
    the largest input each kernel gets in `seen`. Returns the launches of
    each phase. The tables and sessions are dropped when it returns."""
    import torch

    from tidb_tpu_torch.bench import load_tpch
    from tidb_tpu_torch.bench.oracles import (
        Q1_SQL, Q3_SQL, Q5_SQL, Q6_SQL, REPORT_BASE_TABLE, REPORT_QUERIES, SUPPKEY_SQL,
        TPCH_QUERIES, spec_params,
    )
    from tidb_tpu_torch.bench.tpcds import Q95_SQL, load_tpcds
    from tidb_tpu_torch.executor import aggregate as A
    from tidb_tpu_torch.executor import kernels as K
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage import Catalog

    # --- 4. data ---
    t0 = time.perf_counter()
    cat = Catalog()
    load_tpch(cat, sf=SF, seed=1, tables=TABLES)
    blk, li = raw_columns(cat, [
        "l_shipdate", "l_returnflag", "l_linestatus", "l_quantity",
        "l_extendedprice", "l_discount", "l_tax", "l_suppkey",
    ])
    log(f"datagen: SF{SF:g}, " + ", ".join(
        f"{t} {cat.table('tpch', t).nrows}" for t in TABLES
    ) + f" rows in {time.perf_counter() - t0:.1f}s")

    # record the largest input each kernel gets on these phases' path
    def recording(name, fn, size):
        def wrapped(*a):
            if name not in seen or size(*a) > size(*seen[name]):
                seen[name] = a
            return fn(*a)

        return wrapped

    A.slot_sums = recording("slot_sums", K.slot_sums, lambda v, c, s, n: v.numel())
    A.prefix_sum = recording("prefix_sum", K.prefix_sum, lambda x: x.numel())

    # --- 5. main path: TPC-H ---
    sess = Session(cat, db="tpch")
    queries = [("q1", Q1_SQL, q1_check(blk, li)),
               ("q6", Q6_SQL, lambda r: check_q6(r, blk)),
               ("l_suppkey", SUPPKEY_SQL, lambda r: check_suppkey(r, blk)),
               ("q3", Q3_SQL, lambda r: check_q3(r, cat)),
               ("q5", Q5_SQL, lambda r: check_q5(r, cat))]
    for name, q in TPCH_QUERIES.items():
        params = spec_params(name, SF)
        queries.append((name, q.sql.format(**params), oracle_check(cat, q, params)))
    queries = [(name, sql, check, sess) for name, sql, check in queries]

    def analyze_first(name):
        if name == "q3":
            t0 = time.perf_counter()
            for t in TABLES:
                sess.execute(f"analyze table {t}")
            torch.cuda.synchronize()
            log(f"analyze: {len(TABLES)} tables in {time.perf_counter() - t0:.1f}s")

    launches = {"tpch": run_phase(queries, report, lambda n: cat.table(
        "tpch", BASE_TABLE.get(n, "lineitem")), before=analyze_first)}

    # --- 6. main path: window and set-operation reports, TPC-DS Q95 ---
    t0 = time.perf_counter()
    ds = Catalog()
    load_tpcds(ds, sf=TPCDS_SF, seed=1)
    log(f"datagen: TPC-DS SF{TPCDS_SF:g}, " + ", ".join(
        f"{t} {ds.table('test', t).nrows}" for t in TPCDS_TABLES
    ) + f" rows in {time.perf_counter() - t0:.1f}s")
    ds_sess = Session(ds, db="test")
    slice6 = [(name, q.sql, oracle_check(cat, q, {}), sess) for name, q in REPORT_QUERIES.items()]
    slice6.append(("q95", Q95_SQL, q95_check(ds), ds_sess))

    def base6(name):
        if name == "q95":
            return ds.table("test", "web_sales")
        return cat.table("tpch", REPORT_BASE_TABLE[name])

    launches["reports_q95"] = run_phase(slice6, report, base6)
    A.slot_sums, A.prefix_sum = K.slot_sums, K.prefix_sum
    streamed = [n for n, _s, _c, _q in queries + slice6 if report[n]["stream"]]
    assert not streamed, f"SF10/TPC-DS statements streamed: {streamed}"

    if args.profile:
        for name, sql, _check, qs in queries + slice6:
            profile_query(qs, name, sql, args.profile)
    return launches


def spill_phase(args, report) -> dict:
    """Phase 8: TPC-H Q18, Q1, Q21, R1 and Q1 under a 1 GiB quota at SF100
    through the spill paths. Returns the phase's launches."""
    import torch

    from tidb_tpu_torch.bench import load_tpch
    from tidb_tpu_torch.bench.oracles import Q1_SQL, SPILL_REPORTS, TPCH_QUERIES, spec_params
    from tidb_tpu_torch.chunk import TRANSFERS
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage import Catalog

    tables = list(SPILL_COLUMNS)
    log(f"spill: before datagen, {host_memory()}, device allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    t0 = time.perf_counter()
    cat = Catalog()
    load_tpch(cat, sf=SPILL_SF, seed=1, tables=tables, columns=SPILL_COLUMNS)
    log(f"datagen: SF{SPILL_SF:g}, " + ", ".join(
        f"{t} {cat.table('tpch', t).nrows}" for t in tables
    ) + f" rows ({sum(len(c) for c in SPILL_COLUMNS.values())} columns) in "
        f"{time.perf_counter() - t0:.1f}s; {host_memory()}")
    sess = Session(cat, db="tpch")
    t0 = time.perf_counter()
    for t in tables:
        sess.execute(f"analyze table {t}")
    torch.cuda.synchronize()
    log(f"analyze: {len(tables)} tables in {time.perf_counter() - t0:.1f}s")
    blk, li = raw_columns(cat, ["l_shipdate", "l_returnflag", "l_linestatus", "l_quantity",
                                "l_extendedprice", "l_discount", "l_tax"])
    q18, q21, r1 = TPCH_QUERIES["q18"], TPCH_QUERIES["q21"], SPILL_REPORTS["r1"]
    params = spec_params("q18", SPILL_SF)
    # the quota'd Q1 runs in a session of its own, as a user with the
    # default quota would
    qsess = Session(cat, db="tpch")
    qsess.executor.quota_bytes = SPILL_QUOTA
    q1_oracle = q1_check(blk, li)
    queries = [("q18_sf100", q18.sql.format(**params), oracle_check(cat, q18, params), sess),
               ("q1_sf100", Q1_SQL, q1_oracle, sess),
               ("q21_sf100", q21.sql, oracle_check(cat, q21, {}), sess),
               ("r1_sf100", r1.sql, oracle_check(cat, r1, {}), sess),
               ("q1_quota_sf100", Q1_SQL, q1_oracle, qsess)]
    expect = {"q18_sf100": ("streamed", "device"), "q1_sf100": ("streamed", "device"),
              "q21_sf100": ("partitioned", "device"), "r1_sf100": ("sort", "device"),
              "q1_quota_sf100": ("streamed", "host")}
    h0 = TRANSFERS["h2d_bytes"]
    launches = run_phase(queries, report, lambda n: li)
    for name, _sql, _c, _s in queries:
        r = report[name]
        recs = r["stream"]
        log(f"stream {name}: {json.dumps(recs)}")
        for rec in recs:
            stages = ", ".join(f"{k} {v:.4g}" for k, v in rec.get("seconds", {}).items())
            size = (f"K {rec['K']}, largest partitions {rec['largest_partition_rows']}"
                    if rec["path"] == "partitioned" else f"{rec['chunks']} chunks")
            log(f"  {name}: {rec['path']}, {rec['mode']}, {size}; why: {rec['why']}; "
                f"mode: {rec['mode_why']}; seconds: {stages}")
        # every run, cold and warm, takes the path the sizing is meant to
        want = expect[name]
        assert r["stream_paths"] and all(
            ps and all(p == want for p in ps) for ps in r["stream_paths"]
        ), (name, r["stream_paths"])
        if want[0] != "partitioned":
            assert all(x["chunks"] > 1 for x in recs), f"{name} did not chunk"
        gb = [round(b / 1e9, 3) for b in r["resident_after"]]
        above = r["max_memory_allocated"] - r["resident_before"]
        log(f"{name}: warm s {r['warm_s']}, cold s {r['cold_s']:.3f}, rows/s "
            f"{r['rows_per_s']:.4g}, peak {r['max_memory_allocated'] / 1e9:.2f} GB "
            f"({above / 1e9:.3f} GB above the start; cold and each warm run "
            f"{[round(b / 1e9, 2) for b in r['peaks']]} GB), resident "
            f"{r['resident_before'] / 1e9:.2f} GB before and {gb} GB after each run, "
            f"h2d {r['h2d_bytes_per_warm_run']:.4g} B and d2h fetches "
            f"{r['d2h_fetches_per_warm_run']:.4g} per warm run")
        # no run leaves its staged batch, partials or partitions behind
        assert r["resident_after"][3] <= r["resident_after"][1] + (256 << 20), gb
    for rec in report["q21_sf100"]["stream"]:
        assert all(n <= 1 << 26 for n in rec["largest_partition_rows"].values()), rec
    r = report["q1_quota_sf100"]
    above = r["max_memory_allocated"] - r["resident_before"]
    h2d_s = sum(x["seconds"]["h2d"] for x in r["stream"])
    log(f"q1_quota_sf100: peak {above} B above its start under a {SPILL_QUOTA} B quota; "
        f"host->device {r['h2d_bytes_per_warm_run'] / h2d_s / 1e9:.3f} GB/s over the last "
        f"run's chunk copies ({h2d_s:.3f} s)")
    assert above <= SPILL_QUOTA, above
    log(f"spill: h2d {TRANSFERS['h2d_bytes'] - h0} B over the phase; {host_memory()}")
    if args.profile:
        for name, sql, _check, qs in queries:
            profile_query(qs, name, sql, args.profile)
    return launches


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", metavar="DIR",
                    help="also trace one warm run of each query with torch.profiler and "
                         "write each trace's table to DIR/profile_<query>.txt")
    ap.add_argument("--kernels", action="store_true",
                    help="build, check and time the kernels on synthesized main-path "
                         "inputs only: no data generation, no queries, no last line")
    ap.add_argument("--spill-only", action="store_true",
                    help="build and check the kernels and run the SF100 spill phase only: "
                         "no last line")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from tidb_tpu_torch import _build
    from tidb_tpu_torch.chunk import TRANSFERS, reset_transfers
    from tidb_tpu_torch.executor import kernels as K
    from tidb_tpu_torch.storage import scan

    card = card_line()
    log(f"card: {card}")
    if SF != 10.0 or SPILL_SF != 100.0:
        log(f"scale cut: SF{SF:g} and SF{SPILL_SF:g} instead of SF10 and SF100")

    # --- 1. build ---
    t0 = time.perf_counter()
    built = _build.build_all()
    log(f"build: {len(built)} kernels in {time.perf_counter() - t0:.1f}s")
    for name, (secs, out) in built.items():
        took = "already built" if secs is None else f"{secs:.1f}s"
        log(f"--- nvcc {name}.cu ({took})\n{out.strip()}")

    # --- 2. kernels vs plain at edge shapes ---
    big_n = int(6_000_000 * SF)
    kernel_edge_checks(big_n)

    if args.kernels:
        log("kernels only: phases 4-6 and 8 skipped, inputs synthesized")
        log(json.dumps({"kernel_times": kernel_rows(synthetic_inputs(), None)}))
        log(card)
        return 0

    reset_transfers()
    report = {}
    launches = {}
    kernels = None
    if not args.spill_only:
        seen = {}
        launches.update(sf10_phases(args, seen, report))
        # --- 7. kernels on the main path's inputs: check and time ---
        kernels = kernel_rows(seen, None)
        seen.clear()

    # --- 8. spill: TPC-H SF100 ---
    # the SF10 sessions' compiled plans and their executors refer to each
    # other: collect them now, with the tables they hold
    gc.collect()
    freed = scan.release()
    torch.cuda.empty_cache()
    log(f"spill: released {freed} B of cached device columns, device allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    launches["spill_sf100"] = spill_phase(args, report)
    log(f"main path: launches by phase {launches}, h2d_bytes {TRANSFERS['h2d_bytes']}, "
        f"d2h_bytes {TRANSFERS['d2h_bytes']}, d2h_fetches {TRANSFERS['d2h_fetches']}")
    for phase, counts in launches.items():
        for k, n in counts.items():
            assert n > 0, f"kernel {k} was not launched on the main path's {phase} phase"
    log(json.dumps({"queries": report}))
    if kernels is None:
        log("spill only: phases 4-7 skipped")
        log(card)
        return 0
    totals = {k: sum(ph[k] for ph in launches.values()) for k in K.LAUNCHES}
    for row in kernels:
        row["launches"] = totals[row["name"]]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
