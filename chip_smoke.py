"""Drive the PyTorch/CUDA port on one GPU and check it end to end.

    python3 chip_smoke.py                  # TPC-H SF10 and SF100, as the port is measured
    python3 chip_smoke.py --profile out/   # plus a torch.profiler pass
    python3 chip_smoke.py --kernels        # phases 1-3 and 7 only, on
                                           # synthesized main-path inputs
    python3 chip_smoke.py --spill-only     # phases 1-3 and 8 only
    python3 chip_smoke.py --refresh-only   # phases 1-3 and the refresh phase only
    python3 chip_smoke.py --builtins-only  # phases 1-3 and the builtins phase only
    python3 chip_smoke.py --statements-only  # phases 1-3 and the statements phase only
    python3 chip_smoke.py --operator-only  # phases 1-3 and the operator phase only
    python3 chip_smoke.py --indexes-only   # phases 1-3 and the index phase only
    python3 chip_smoke.py --constraints-only  # phases 1-3 and the constraint phase only
    python3 chip_smoke.py --partitions-only  # phases 1-3 and the partition phase only
    python3 chip_smoke.py --loads-only     # phases 1-3 and the load phase only
    python3 chip_smoke.py --durability-only  # phases 1-3 and the durability phase only
    python3 chip_smoke.py --observability-only  # phases 1-3 and the observability phase only

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
   (oracles.REPORT_QUERIES) on the same SF10 tables, then TPC-DS Q95 over
   the TPC-DS tables of BASELINE config #5 at SF100, generated with the
   port's load_tpcds(seed=1) beside phase 5's oracles (7.2M web_sales
   rows, no ANALYZE, as bench.py runs it): each cold once and warm three
   times, each run
   checked against its oracle. Each ORDER BY ... LIMIT prints the top-N
   path it took (packed key and its width, or sorted). No statement of
   phases 5 and 6 streams: SF10's tables fit one tile.
   Then the builtins phase, on the same SF10 tables through the same
   Session: the BI reports B1-B9 (oracles.BUILTIN_REPORTS: DATE_FORMAT,
   LOWER and ROUND by month; UPPER, LEFT, CONCAT, SUBSTRING_INDEX and
   CHAR_LENGTH over customers; WEEK and DAYNAME; TIMESTAMPDIFF, GREATEST,
   LEAST, NULLIF and COALESCE; FLOOR, CEIL, TRUNCATE, SQRT and TRIM;
   GROUP_CONCAT over a join and over nations; REPLACE, LOCATE, LPAD and
   CONCAT_WS; a CI-collated CASE), each cold once and warm three times and
   every run checked against its numpy oracle. It prints per report the
   warm ms, cold s, the host seconds spent building dictionary tables in
   the cold run, fetches and host->device bytes per warm run, and the
   phase's seconds against its 120 s limit and its kernel launches.
   Then the statements phase, on the same tables through the same
   Session (oracles.STATEMENT_QUERIES): X1-X5, TPC-H Q2, Q9, Q14, Q16 and
   Q20 with each LIKE restated as the REGEXP it equals, each checked
   against its query's oracle; X6, revenue by REGEXP_SUBSTR's metal and
   REGEXP_REPLACE's container kind over lineitem and part; X7, a CRM
   profile table with ENUM, SET and JSON columns filled from customer,
   nation and region (1.5M rows by INSERT ... SELECT) and a report over
   orders by JSON_EXTRACT's region, segment and FIND_IN_SET's VIP flag,
   then an ENUM value outside the list and invalid JSON, each refused
   with the JAX package's error and the row count kept; X8, a 15M-row web
   access log generated from the seed (oracles.access_log: 1M IPv4 and
   50k IPv6 addresses, 1M session UUIDs, a DATETIME) loaded through
   storage.convert, and a report by INET_ATON's first octet with IS_IPV6,
   UUID_TO_BIN/BIN_TO_UUID, COMPRESS/UNCOMPRESSED_LENGTH and
   AES_ENCRYPT/AES_DECRYPT round trips; X9, a WITH RECURSIVE date spine
   over 1995 left-joined to orders (365 recursive steps, their seconds
   printed); each cold once and warm once, every run checked
   against its numpy oracle, with the host seconds of the dictionary
   tables (REGEXP, JSON, INET, AES) of each cold run. X10: EXPLAIN of the
   22 TPC-H queries (Q1, Q3 and Q18's lines printed) and EXPLAIN ANALYZE
   of Q1, Q3 and Q18, each asserting the root's rows= equal to the
   oracle's row count and calls=1 on every node, its wall time beside
   the query's warm time. It prints the phase's seconds against its 150 s
   limit and its kernel launches.
   Then the server: the port's MySQL server (tidb_tpu_torch.server.Server)
   on the card over phase 5's SF10 tables, columns resident, driven by a
   raw-socket client (MysqlWire) on the port's protocol module. It connects
   as root and sends what a MySQL client sends (select @@version_comment
   limit 1, COM_INIT_DB tpch, COM_PING); runs Q1, Q6, Q3 and Q18 three
   times each and the late-receipt report R1 once (R1_WIRE_RUNS; also
   from a client in a process of its own) over the text protocol, each
   checked, printing the wire time beside the in-process warm time (R1's
   own three in-process runs) and R1's rows/s; prepares Q6 with its
   parameters as '?' and EXECUTEs it at two parameter sets over the binary
   protocol, checked against numpy_q6, and drains R1 through a read-only
   cursor with COM_STMT_FETCH; checks an unknown table's errno (1105, as
   the JAX server) and that the connection lives; runs Q1 on a fresh
   connection after SET tidb_mem_quota_query = 1 GiB (its spill records
   printed, the quota asserted in the executor and in each); runs Q1, Q6,
   Q5 and Q3 on four connections at once, three times each, every result
   checked, printing the wall time; and starts `python3 -m
   tidb_tpu_torch.tidb_server --tpch 1 -P 0`, whose Q1 over the wire must
   equal numpy_q1 on the same SF1 data generated here, then SIGTERMs it
   and asserts exit code 0.
   Then the refresh phase, on the same SF10 tables through Session on
   the card: DDL (a summary table with an AUTO_INCREMENT key filled by
   INSERT ... SELECT of Q1's groups, read back, TRUNCATEd, refilled with
   LAST_INSERT_ID() restarting, DROPped); TPC-H RF1 (SF x 1500 = 15,000
   new orders and their one to seven line items, INSERT ... VALUES in
   batches of 1,000 rows, one transaction, one batch growing o_comment's
   dictionary); Q1, Q6, Q3 and Q18, each cold once and warm once;
   UPDATEs of the new orders' o_orderstatus and l_extendedprice (* 1.05,
   a DECIMAL through CAST) in batches of 1,000 keys, each asserted to
   take the columnar path, then Q1 and Q6; a DELETE of 1,000 orders' line
   items seen inside its transaction and rolled back; RF2 (15,000 old
   orders and their line items, DELETE in batches of 1,000 keys, one
   transaction), then the four queries again; and writes over the wire
   (OK packets' affected rows and last_insert_id, two connections whose
   transactions touch one table: the second waits, then succeeds). Every
   query is checked against the numpy oracles over an oracle catalog
   built from arrays (the columns captured before the phase, plus RF1's
   rows, minus RF2's, with the updates applied in numpy), every DML's
   affected rows asserted, a query over unwritten tables asserted to copy
   nothing host->device after a write, and the device cache to hold one
   version of each table and no transaction's shadow at the end. It
   prints each statement's seconds and affected rows, each query's cold
   seconds, warm ms, host->device bytes and fetches, and each step's peak
   device memory, cached bytes by table and host RSS.
   Then the operator phase, on the same tables: what a MySQL client and
   its operator send around the queries. O1: over the wire, the tables'
   rows from information_schema.tables, lineitem's 16 columns from
   information_schema.columns (against bench/tpch.py's schema), SHOW
   COLUMNS / CREATE TABLE / TABLE STATUS / COLLATION / CHARSET / ENGINES,
   and a scratch table's SHOW INDEX, statistics and key_column_usage
   rows. O2: CREATE USER with a password, GRANT SELECT; the user logs in,
   runs Q6 and Q1 (checked), is refused an INSERT with the JAX package's
   error; SHOW GRANTS, REVOKE (Q6 refused), DROP USER (login refused,
   1045). O3: CREATE BINDING of Q18 to its STREAM_ROWS hint (about 8
   chunks of lineitem), SHOW BINDINGS; Q18 cold once and warm three
   times on the streamed path (chunks, chunk seconds and the gaps between
   kill safepoints printed), then DROP BINDING and Q18 one tile. O4: the
   streamed Q18 under max_execution_time (a third of its warm time), then
   under the MAX_EXECUTION_TIME hint: each raises within the limit plus
   the slowest chunk plus 0.5 s, and the re-run equals the oracle with
   the device's allocation back within 1%. O5: connection A runs the
   streamed Q18, B waits for it in SHOW PROCESSLIST and half its warm
   time more, and sends KILL QUERY (both return while A runs); A's error comes within the slowest chunk
   plus 0.5 s, its next Q18 equals the oracle, and KILL CONNECTION ends A.
   O6: tidb_gc_life_time = 600, a timestamp, RF1's inserts (15,000
   orders and their line items, one transaction), then Q1 and Q6 AS OF
   the timestamp, the same under tidb_snapshot (an INSERT refused), Q1
   current, and Q1 under a tidb_read_staleness that reaches back past the
   insert: each against the oracle of its version, with its host->device
   bytes. O7: INSERT IGNORE's warning in SHOW WARNINGS, DO, FLUSH TABLES,
   OPTIMIZE TABLE orders (timed), SHOW STATUS, USE information_schema. It
   prints the phase's seconds against its 150 s limit and its launches.
   Then the index phase, on the same tables: I1, 200 EXECUTEs of a
   prepared point get by o_orderkey over seeded keys (one in eight absent),
   each against the orders arrays, every twentieth EXPLAINed as
   IndexRangeScan, a warm get copying at most 16 KB host->device; I2,
   CREATE INDEX on o_orderdate (timed), EXPLAIN of a one-week range and
   the range's count and sum three times (slot_sums launches), the index in
   information_schema.statistics and SHOW INDEX; I3, an OR of an
   o_orderkey range and one date as IndexMerge, then TPC-H Q4, whose
   EXPLAIN names the o_orderdate range, three times against its oracle;
   I4, daily revenue upserted by INSERT ... SELECT ... GROUP BY l_shipdate
   ... ON DUPLICATE KEY UPDATE over two overlapping windows, the affected
   rows and rows checked (the dense GROUP BY launches prefix_sum); I5,
   supplier_dim LIKE supplier filled with one nation, a UNIQUE index on
   s_name, REPLACE of ~4,000 suppliers (half already stored) with a
   changed s_acctbal, and a UNIQUE index over duplicates refused with the
   JAX error and no index left; I6, a multi-table UPDATE of EUROPE's
   suppliers and a multi-table DELETE of the partsupp rows of suppliers
   whose comment matches '%Customer%Complaints%', checked against the
   arrays; I7, ALTER TABLE ADD COLUMN and MODIFY, a failing two-spec ALTER
   rolled back, SHOW CREATE TABLE, CREATE TABLE LIKE and RENAME TABLE of
   two pairs, DROP INDEX (Q4's EXPLAIN then names no range). Each step
   prints its seconds, host->device bytes, narrowed reads (rows, host
   seconds), index sorts and full garbage collections; the phase its
   seconds against its 120 s limit and its launches.
   Then the constraint phase (database tpch_c, dropped at its end): C1,
   the eight tables declared with their tpch columns and primary keys,
   TPC-H clause 1.4.2's single-column FOREIGN KEYs (lineitem's order key
   ON DELETE CASCADE, orders' customer key ON DELETE SET NULL) and clause
   1.4.2.4's CHECKs, filled with the tpch tables' blocks (lineitem's
   l_receiptdate derived by clause 4.2.3's rule where the generator drew
   it before l_shipdate), each CHECK's violating rows and each FK's
   orphans counted in SQL and numpy (0), SHOW CREATE TABLE of lineitem
   and information_schema.referential_constraints; C2, RF1's 15,000
   orders and their line items written under the constraints by INSERT
   ... SELECT from tables staged through the storage layer (and, for the
   constraints' share, into copies without them), then Q1;
   C3, an FK, a CHECK, a RESTRICT DELETE, a CHECK on a columnar UPDATE
   and a DROP TABLE of a referenced table, each refused with the JAX
   package's error and the tables' counts and sums unchanged, INSERT
   IGNORE of 1,000 line items keeping the 900 that pass, and a
   constrained UPDATE of l_discount on the columnar path against numpy;
   C4, RF2 as one DELETE of 15,000 orders cascading to their line items,
   then Q1, Q3 and Q18, and a DELETE of 100 customers that sets their
   orders' o_custkey NULL, then Q13; C5, TPC-H Q15 as the specification
   writes it, over a view on the tpch tables, cold once and warm three
   times beside the CTE form, a view over that view, SHOW CREATE VIEW,
   information_schema.views and a view over tpch_c.lineitem after the
   cascade; C6, a stored generated column added to supplier (the
   backfill), its GROUP BY against numpy, an INSERT that computes it, a
   columnar UPDATE that recomputes it and an INSERT that writes it,
   refused. Each step prints its seconds, its statements' seconds,
   host->device bytes and launches; the phase its seconds against its
   120 s limit.
   Then the partition phase (database tpch_p, dropped at its end), the
   deployment of TiDB's partitioning guide: P1, lineitem and orders
   RANGE-partitioned by year (p1992 ... p1998, no MAXVALUE), customer
   HASH-partitioned on its key into 16, supplier LIST-partitioned by
   region and the other four tables as they are, loaded from the tpch
   blocks through each table's split_by_partition, every block proved
   inside its partition, information_schema.partitions' counts against
   numpy's per year, bucket and region, and SHOW CREATE TABLE's clauses;
   P2, TPC-H Q6, Q14, Q7, Q3, Q4, Q5, Q10 and Q8 with Q1 and Q12 as
   controls, a HASH point query and a LIST range, each with the
   partition list the JAX package's pruning gives (PARTITION_LISTS),
   cold once and warm twice over tpch_p, then cold once and warm once
   over tpch, every run against its numpy oracle, with each query's cold host->device
   bytes and warm ms side by side and the scan cache's bytes per pruned
   set; P3, RF1's 15,000 orders and their line items routed by INSERT
   ... SELECT and RF2's DELETEs, the counts, Q1 and Q6 against numpy
   after each; P4, ADD PARTITION p1999 (a 1999 row lands there, a 2001
   row is refused with the JAX text), TRUNCATE of lineitem's p1992 and
   DROP of orders' p1992 (a tidb_snapshot reader pinned before it still
   counts the old rows, pruned with the old defs), EXCHANGE of
   lineitem's p1998 with an empty archive and back WITH VALIDATION, Q1
   and the counts after each; P5, 1,000 NEXTVALs in one INSERT ...
   VALUES, a temporary table of Q18's inner GROUP BY under Q18 (against
   its oracle) that a second session cannot see, GET_LOCK held against
   the second session, and a SLEEP(5) there cut by KILL within 0.5 s.
   Each step prints its seconds, its statements' seconds, host->device
   bytes, launches and its reads' partition lists; the phase its
   seconds against its 100 s.
   Then the load phase (database tpch_l, dropped at its end; its files
   under tempfile.gettempdir()): L1 declares customer empty and
   HASH-partitioned into 16, orders and lineitem with TPC-H's keys
   (lineitem's (l_orderkey, l_linenumber), numbered as the specification
   numbers it), FOREIGN KEYs and CHECKs over the tpch tables' blocks,
   and orders_ttl, orders' rows with TTL = o_orderdate + INTERVAL 60
   MONTH; L2 writes customer.tbl as dbgen writes it (1.5M rows, '|' at
   each line's end) and runs IMPORT INTO over the DXF (four executors),
   then ADMIN CHECKSUM TABLE of tpch.customer and tpch_l.customer (equal
   checksum and row count: Lightning's post-import check), ADMIN CHECK
   TABLE and a 125-group segment report against numpy. Scale cut: the
   import loads customer, not the whole SF10 database (86.6M rows):
   both packages' import parses in Python, and the whole database would
   take longer than the script's limit. L3 LOADs RF1's 15,000 orders
   and their line items from dbgen-style update files through the
   constrained path (the native splitter), then the counts, Q1 and Q6
   against numpy, and has a line that breaks a CHECK and a short line
   refused with the JAX texts; L4 runs ADMIN CHECK TABLE over orders and
   lineitem (the keys and the FOREIGN KEY closure over ~60M line items),
   ADMIN CHECK INDEX lineitem primary, CHECK TABLE and ADMIN SHOW DDL
   JOBS, each clean, with its seconds; L5 sweeps with TTLWorker at
   1998-08-03 (the removed rows against numpy's count before the cutoff,
   a second sweep removing none, a report by o_orderpriority over the
   kept rows, SHOW CREATE TABLE's TTL clause); L6 ticks StatsHandle,
   which must analyze exactly the tables needs_analyze lists (their
   statistics equal an explicit ANALYZE's), and starts and stops a server
   with both workers. Each step prints its seconds, its statements'
   seconds, host->device bytes and launches; the phase its seconds
   against its 60 s.
   Then the durability phase, in database tpch_d over the SF10 tables'
   blocks (region, nation, supplier and customer with TPC-H's keys and
   FOREIGN KEYs; a cut of scale: BACKUP deflates on the host, and the
   whole SF10 database would take minutes): D1 adds a CHECK, supplier_p
   (RANGE by s_nationkey into five), ev (100,000 rows, a TTL of 90
   days), a view, a sequence and the user br_reader, and runs BACKUP
   DATABASE tpch_d (its seconds, bytes written and MB/s); D2 arms
   persist/backup-table to fail at the second table of a BACKUP into a
   second directory (it fails, checkpoint.json stays) and backs up again
   (only the tables not checkpointed are written), on a thread beside
   D3; D3 boots `python3 -m tidb_tpu_torch.tidb_server --path <D1's
   directory> --config <toml> --status-port 0 -P 0` with
   TIDB_TPU_RACECHECK=1, the script's cached columns released first,
   reads /status, /schema/tpch_d/customer, /settings and /metrics, has
   a client in another process run the segment report
   (against numpy), 1,000 INSERTed customers, 1,000 UPDATEd balances, a
   DELETE from supplier_p and two NEXTVALs, logs in as br_reader (the
   manifest's user: a SELECT answers, an INSERT is refused), then
   SIGTERMs it (exit 0 after its snapshot, whose seconds and MB/s it
   prints); D4 RESTOREs
   that directory over the live tpch_d and checks row counts and the
   125-group report against numpy with D3's writes, NEXTVAL after the
   binary's, SHOW CREATE TABLE's TTL and partitions, supplier_p's
   pruning, br_reader's grants, ADMIN CHECK and ADMIN CHECKSUM against
   tpch's; D5 has a SLEEP(30) ended by the instance watchdog within two
   of its intervals after SET GLOBAL tidb_server_memory_limit goes below
   the process's RSS (the kill in information_schema.memory_usage_ops_
   history, memory_usage's total equal to /proc/meminfo's MemTotal,
   printed beside the phase), then the limit back at '0' and the
   watchdog stopped and joined. Each step prints its seconds, its
   statements' seconds, host->device bytes and launches; the phase its
   seconds against its 60 s (DURABILITY_LIMIT_S).
   Then the observability phase on the tpch tables (observability_phase:
   M1 the statement summary and the slow log over Q1, Q5, Q6 and Q18, and
   Q6 by EXECUTE against Q6 as text; M2 TRACE of Q5; M3 information_schema.
   tpu_engine over a cold and a warm Q6; M4 resource groups; M5 /metrics;
   M6 PLAN REPLAYER and the recorder's cost), its seconds against its 40 s
   (OBSERVABILITY_LIMIT_S). The recorder's entry points are timed from the
   script on every statement of the run (``watch_recorder``), printed as
   one `recorder:` line before the `phases:` line.
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
   warm once (SPILL_WARM_RUNS), each run checked against the numpy
   oracles. Each
   exceeds the port's one-tile limit, so the executor's sizing sends it
   down a spill path (planner/streamed.py): Q18 and Q1 stream with their
   columns on the device, Q21 takes grace hash (its EXISTS and NOT EXISTS
   sides are lineitem too), R1 the host-merged ORDER BY, and the quota'd
   Q1 streams chunks from host RAM with its device allocation above its
   start within the quota. Each statement prints its spill records (path,
   mode, chunks or partitions, why, seconds per stage), its resident
   bytes after every run, its peak, and its host->device bytes and
   device->host fetches per warm run.
   Phases 5, 6, the builtins, statements, server, refresh, operator,
   index, constraint, partition, load, durability and observability
   phases and 8 each
   show that every
   kernel launched
   there: launch counts
   are zeroed just before a phase's runs and read just after them.

With --kernels, phases 4-6 and 8 are skipped: phase 7 runs on inputs
shaped as the main path's (TPC-H Q1's slot_sums lanes at SF10, the
l_suppkey GROUP BY's prefix_sum), made from a seed, and prints its rows as
"kernel_times" with no launch counts, since no main path ran. With
--spill-only, phases 4-7 are skipped; --refresh-only, --builtins-only,
--statements-only, --operator-only, --indexes-only, --constraints-only,
--partitions-only, --loads-only, --durability-only and
--observability-only generate and ANALYZE the SF10 tables and run that
one phase. None of them prints the last line.

Before the kernels line the full run prints one `phases:` line: every
phase's seconds (datagen within its phase), the script's total from its
start, and whether the partition phase kept to its 100 s, the load and
durability phases to their 60 s and the observability phase to its 40 s.

Any failure raises; the last line is printed only when every phase passed.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import os
import signal
import socket
import struct
import subprocess
import sys
import threading
import time
import types
from concurrent.futures import ThreadPoolExecutor

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


def q1_check(blk, t, pool=None):
    """A check of Q1's rows against numpy_q1, computed on first use (on
    `pool` from now on, when given) and kept for the query's later runs."""
    from tidb_tpu_torch.bench.oracles import numpy_q1

    def compute():
        t0 = time.perf_counter()
        o = numpy_q1(blk)
        log(f"  oracle: Q1 in {time.perf_counter() - t0:.1f}s")
        return o

    fut = pool.submit(compute) if pool is not None else None
    oracle = []

    def check(res):
        if not oracle:
            oracle.append(fut.result() if fut is not None else compute())
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


def check_suppkey(res, blk, oracle=None):
    """Rows equal numpy_suppkey (`oracle`: its answer, computed already)."""
    from tidb_tpu_torch.bench.oracles import numpy_suppkey

    keys, cnt, qty = oracle if oracle is not None else numpy_suppkey(blk)
    got = sorted(res.rows)
    assert len(got) == len(keys), (len(got), len(keys))
    assert [r[0] for r in got] == keys.tolist()
    assert [r[1] for r in got] == cnt.tolist()
    assert [r[2] for r in got] == (qty / 100).tolist()


def present_date(days: int) -> str:
    return str(np.datetime64(int(days), "D"))


def check_q3(res, cat, oracle=None):
    """Rows equal numpy_q3 in ORDER BY order: (revenue, o_orderdate)
    exactly in sequence, whole rows as a multiset within each run of
    equal (revenue, o_orderdate), and rows tying the last one drawn from
    every group that ties it. `oracle`: numpy_q3's answer, computed
    already."""
    from tidb_tpu_torch.bench.oracles import numpy_q3

    want, tied = oracle if oracle is not None else numpy_q3(cat)

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


def check_q5(res, cat, oracle=None):
    """Rows equal numpy_q5: (n_name, revenue) per nation with revenue,
    in ORDER BY revenue desc. `oracle`: numpy_q5's answer, computed
    already."""
    from tidb_tpu_torch.bench.oracles import numpy_q5

    rev = oracle if oracle is not None else numpy_q5(cat)
    (nb,) = cat.table("tpch", "nation").blocks()
    names = nb.columns["n_name"].dictionary[nb.columns["n_name"].data]
    by_key = dict(zip(nb.columns["n_nationkey"].data.tolist(), names))
    want = [(by_key[k], np.int64(rev[k]) / 10**4)
            for k in sorted(np.flatnonzero(rev > 0), key=lambda k: -rev[k])]
    assert [tuple(r) for r in res.rows] == want, (res.rows, want)


def oracle_check(cat, q, params, pool=None):
    """A check of a TPCH_QUERIES result against its oracle, computed on
    first use (on `pool` from now on, when given) and kept for the
    query's later runs."""
    from tidb_tpu_torch.bench.oracles import check_rows

    def compute():
        t0 = time.perf_counter()
        rows = q.oracle(cat, **params)
        log(f"  oracle: {len(rows)} rows in {time.perf_counter() - t0:.1f}s")
        return rows

    fut = pool.submit(compute) if pool is not None else None
    want = []

    def check(res):
        if not want:
            want.append(fut.result() if fut is not None else compute())
        check_rows(res.rows, want[0], q.order, q.limit)

    return check


def oracles_first(pool, what: str, threads: int) -> None:
    """Wait for the oracles submitted to `pool` (numpy releases the
    interpreter lock in its passes, so they run side by side), before a
    phase's timed runs: no oracle shares the host with a timed query."""
    t0 = time.perf_counter()
    pool.shutdown(wait=True)
    log(f"{what}: oracles in {time.perf_counter() - t0:.1f}s on {threads} threads")


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
        # the plain version and the library call take ~0.3 s a call: three
        # calls give their mean
        "plain_ms": cuda_time_ms(lambda: K.slot_sums_plain(v, c, g, s), 3),
        **bound(nbytes, adds),
        "library_ms": cuda_time_ms(lambda: lib_out.index_add_(1, idx, masked), 3),
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


def q95_check(cat, oracle=None):
    """Q95's rows against the vectorized oracle (`oracle`, when computed
    already): the order count exactly, the sums (cents) within 1e-12
    relative."""
    from tidb_tpu_torch.bench.oracles import numpy_q95, same_value

    want = [] if oracle is None else [oracle]

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


def run_phase(queries, report, base_table, before=None, warm_runs=3) -> dict:
    """Run each (name, sql, check, session) cold once and warm
    `warm_runs` times, checking every run, and add its numbers to
    `report`. Kernel launch counts are zeroed just before the phase and
    returned as read just after it."""
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
        for _ in range(warm_runs):
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
            "d2h_fetches_per_warm_run": (TRANSFERS["d2h_fetches"] - f0) / warm_runs,
            "h2d_bytes_per_warm_run": (TRANSFERS["h2d_bytes"] - h0) / warm_runs,
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
#: warm runs of each SF100 statement after its cold run
SPILL_WARM_RUNS = 1
#: threads the numpy oracles run on before a phase's timed runs: SF10's
#: each take at most a few GB (7 of the card host's 8 cores; numpy lets
#: the interpreter lock go in its passes); SF100's Q18 oracle alone
#: ~15 GB, with ~47 GB of the host free after the SF100 data
ORACLE_THREADS = 7
#: warm runs of each statement of the statements and refresh phases: they
#: measure cold costs (dictionary tables, copies after a write) and one
#: warm run beside them; the TPC-H and builtins phases keep three
PHASE_WARM_RUNS = 1
SPILL_ORACLE_THREADS = 3


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
    from tidb_tpu_torch.bench import oracles as O
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
    phase_s = report.setdefault("phase_s", {})
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
    pool = ThreadPoolExecutor(ORACLE_THREADS)
    # each oracle once, on the pool, for the cold and the warm runs alike
    q6_f, sk_f, q3_f, q5_f = (pool.submit(O.numpy_q6, blk), pool.submit(O.numpy_suppkey, blk),
                              pool.submit(O.numpy_q3, cat), pool.submit(O.numpy_q5, cat))
    queries = [("q1", Q1_SQL, q1_check(blk, li, pool)),
               ("q6", Q6_SQL, lambda r: _check_q6_value(r, q6_f.result())),
               ("l_suppkey", SUPPKEY_SQL, lambda r: check_suppkey(r, blk, sk_f.result())),
               ("q3", Q3_SQL, lambda r: check_q3(r, cat, q3_f.result())),
               ("q5", Q5_SQL, lambda r: check_q5(r, cat, q5_f.result()))]
    for name, q in TPCH_QUERIES.items():
        params = spec_params(name, SF)
        queries.append((name, q.sql.format(**params), oracle_check(cat, q, params, pool)))
    queries = [(name, sql, check, sess) for name, sql, check in queries]
    slice6 = [(name, q.sql, oracle_check(cat, q, {}, pool), sess)
              for name, q in REPORT_QUERIES.items()]

    def tpcds():
        # TPC-DS's own generator and seed: its tables and Q95's oracle
        # beside TPC-H's oracles
        t1 = time.perf_counter()
        ds = Catalog()
        load_tpcds(ds, sf=TPCDS_SF, seed=1)
        log(f"datagen: TPC-DS SF{TPCDS_SF:g}, " + ", ".join(
            f"{t} {ds.table('test', t).nrows}" for t in TPCDS_TABLES
        ) + f" rows in {time.perf_counter() - t1:.1f}s")
        t1 = time.perf_counter()
        want = O.numpy_q95(ds)
        log(f"  oracle: {want} in {time.perf_counter() - t1:.1f}s")
        return ds, want

    ds_fut = pool.submit(tpcds)
    oracles_first(pool, f"TPC-H SF{SF:g}, the reports, TPC-DS SF{TPCDS_SF:g} and Q95",
                  ORACLE_THREADS)

    def analyze_first(name):
        if name == "q3":
            t0 = time.perf_counter()
            for t in TABLES:
                sess.execute(f"analyze table {t}")
            torch.cuda.synchronize()
            log(f"analyze: {len(TABLES)} tables in {time.perf_counter() - t0:.1f}s")

    launches = {"tpch": run_phase(queries, report, lambda n: cat.table(
        "tpch", BASE_TABLE.get(n, "lineitem")), before=analyze_first)}
    phase_s["tpch"] = time.perf_counter() - t0  # datagen and oracles included

    # --- 6. main path: window and set-operation reports, TPC-DS Q95 ---
    t0 = time.perf_counter()
    ds, q95_want = ds_fut.result()
    ds_sess = Session(ds, db="test")
    slice6.append(("q95", Q95_SQL, q95_check(ds, q95_want), ds_sess))

    def base6(name):
        if name == "q95":
            return ds.table("test", "web_sales")
        return cat.table("tpch", REPORT_BASE_TABLE[name])

    launches["reports_q95"] = run_phase(slice6, report, base6)
    phase_s["reports_q95"] = time.perf_counter() - t0  # TPC-DS datagen: with the oracles
    A.slot_sums, A.prefix_sum = K.slot_sums, K.prefix_sum
    streamed = [n for n, _s, _c, _q in queries + slice6 if report[n]["stream"]]
    assert not streamed, f"SF10/TPC-DS statements streamed: {streamed}"

    def timed(name, fn, *a):
        t1 = time.perf_counter()
        launches[name] = fn(*a)
        phase_s[name] = time.perf_counter() - t1

    # --- the builtins phase: B1-B9 over the same SF10 tables ---
    timed("builtins", builtins_phase, cat, sess, report)

    # --- the statements phase: X1-X10 over the same SF10 tables ---
    timed("statements", statements_phase, cat, sess, report)

    # --- the MySQL server over the same SF10 tables ---
    timed("server", server_phase, cat, blk, sess,
          {n: (sql, c) for n, sql, c, _q in queries}, report)

    # --- the refresh phase: writes over the same SF10 tables ---
    timed("refresh", refresh_phase, cat, sess, report)

    # --- the operator phase: information_schema, SHOW, users, bindings,
    # KILL and stale reads over the same SF10 tables ---
    timed("operator", operator_phase, cat, sess, report)

    # --- the index phase: access paths over indexes and the writes that
    # keep them, over the same SF10 tables ---
    timed("indexes", index_phase, cat, sess, report)

    # --- the constraint phase: TPC-H's keys, FOREIGN KEYs and CHECKs,
    # views and a generated column over the same SF10 tables ---
    timed("constraints", constraint_phase, cat, sess, report)

    # --- the partition phase: tpch_p partitioned as TiDB's guide deploys
    # it, pruned reads, routed writes, partition DDL, sequences and
    # temporary tables over the same SF10 tables ---
    timed("partitions", partition_phase, cat, sess, report)

    # --- the load phase: IMPORT INTO, LOAD DATA, ADMIN CHECK / CHECKSUM,
    # TTL and the background workers over the same SF10 tables ---
    timed("loads", load_phase, cat, sess, report)

    # --- the durability phase: BACKUP / RESTORE, the server binary's
    # --path across a restart, the status API and the watchdog over the
    # same SF10 tables ---
    timed("durability", durability_phase, cat, sess, report)

    # --- the observability phase: the statement summary, the slow log,
    # TRACE, the engine watch, resource groups, /metrics and PLAN
    # REPLAYER over the same SF10 tables ---
    timed("observability", observability_phase, cat, sess, report)

    if args.profile:
        for name, sql, _check, qs in queries + slice6:
            profile_query(qs, name, sql, args.profile)
    return launches


#: the builtins phase's time limit (seconds), oracles included
BUILTINS_LIMIT_S = 120.0


def builtins_phase(cat, sess, report) -> dict:
    """The builtins phase: the BI reports B1-B9 (oracles.BUILTIN_REPORTS)
    over the SF10 tables through `sess`, each cold once and warm three
    times, every run checked against its numpy oracle, the oracles
    computed on threads before the timed runs. Prints per
    report the warm ms, cold s, the host seconds spent building dictionary
    tables during the cold run (warm runs reuse the compiled plan's),
    fetches and host->device bytes per warm run, and the phase's kernel
    launches, which it returns."""
    from tidb_tpu_torch.bench.oracles import BUILTIN_BASE_TABLE, BUILTIN_REPORTS
    from tidb_tpu_torch.expression import kernels as EK

    t0 = time.perf_counter()
    luts = {}

    def lut_after_cold(name, check):
        def first(res):
            luts.setdefault(name, dict(EK.LUT_BUILD))
            check(res)

        return first

    pool = ThreadPoolExecutor(ORACLE_THREADS)
    queries = [(f"builtins_{n}", q.sql,
                lut_after_cold(f"builtins_{n}", oracle_check(cat, q, {}, pool)), sess)
               for n, q in BUILTIN_REPORTS.items()]
    oracles_first(pool, "builtins B1-B9", ORACLE_THREADS)
    launches = run_phase(
        queries, report, lambda n: cat.table("tpch", BUILTIN_BASE_TABLE[n[len("builtins_"):]]),
        before=lambda n: EK.reset_lut_stats())
    for name, *_ in queries:
        r = report[name]
        r["lut_build_s"], r["lut_tables"] = luts[name]["seconds"], luts[name]["tables"]
        log(f"{name}: warm ms {[round(w * 1e3, 2) for w in r['warm_s']]}, cold s "
            f"{r['cold_s']:.3f} (dictionary tables {r['lut_build_s']:.3f} s, "
            f"{r['lut_tables']} built), d2h fetches {r['d2h_fetches_per_warm_run']:.4g} and "
            f"h2d {r['h2d_bytes_per_warm_run']:.4g} B per warm run, rows {r['rows']}")
    took = time.perf_counter() - t0
    log(f"builtins: phase {took:.1f}s of {BUILTINS_LIMIT_S:g}, launches {launches}")
    return launches


def builtins_only(report) -> dict:
    """The SF10 tables, ANALYZEd, and the builtins phase alone: the short
    loop for expression work. Returns the phase's launches."""
    from tidb_tpu_torch.bench import load_tpch
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage import Catalog

    t0 = time.perf_counter()
    cat = Catalog()
    load_tpch(cat, sf=SF, seed=1, tables=TABLES)
    sess = Session(cat, db="tpch")
    for t in TABLES:
        sess.execute(f"analyze table {t}")
    log(f"datagen and analyze: SF{SF:g} in {time.perf_counter() - t0:.1f}s")
    launches = builtins_phase(cat, sess, report)
    for k, n in launches.items():
        assert n > 0, f"kernel {k} was not launched in the builtins phase"
    return launches


#: the statements phase's time limit (seconds), generation and oracles
#: included
STATEMENTS_LIMIT_S = 150.0
#: the queries X10 runs EXPLAIN ANALYZE of
EXPLAIN_ANALYZED = ("q1", "q3", "q18")


def statements_phase(cat, sess, report) -> dict:
    """The statements phase: X1-X9 (oracles.STATEMENT_QUERIES) over the
    SF10 tables through `sess`, X7's profile table and X8's access log
    made first, each statement cold once and warm once (PHASE_WARM_RUNS)
    and every run checked against its numpy oracle; X7's refused writes; X10's
    EXPLAIN and EXPLAIN ANALYZE. Both tables are dropped at the end.
    Returns the phase's kernel launches (from the first of X1-X9's runs to
    the last EXPLAIN ANALYZE)."""
    import torch

    from tidb_tpu_torch.bench import oracles as O
    from tidb_tpu_torch.executor import kernels as K
    from tidb_tpu_torch.expression import kernels as EK
    from tidb_tpu_torch.storage import add_table

    t_phase = time.perf_counter()
    log(f"statements: card {card_line()}")
    # --- X7's table: DDL, then INSERT ... SELECT of every customer ---
    t0 = time.perf_counter()
    sess.execute(O.X7_DDL)
    filled = sess.execute(O.X7_FILL).affected
    nprof = cat.table("tpch", "customer").nrows
    assert filled == nprof, (filled, nprof)
    log(f"statements: cust_profile {filled} rows by INSERT ... SELECT in "
        f"{time.perf_counter() - t0:.2f}s")
    # --- X8's table: generated with numpy, loaded through storage.convert ---
    t0 = time.perf_counter()
    spec = O.access_log(SF)
    t_gen = time.perf_counter() - t0
    t0 = time.perf_counter()
    alog = add_table(cat, "tpch", "access_log", spec)
    log(f"statements: access_log {alog.nrows} rows, "
        f"{len(alog.dictionaries['ip'])} addresses, {len(alog.dictionaries['sid'])} sessions: "
        f"generated in {t_gen:.2f}s, loaded in {time.perf_counter() - t0:.2f}s")
    del spec

    # --- X1-X9 ---
    base = {n: b for n, (b, _r) in O.REGEXP_RESTATED.items()}
    luts, cte = {}, {}

    def checked(name, check):
        def first(res):
            luts.setdefault(name, dict(EK.LUT_BUILD))
            if sess.cte_log:
                cte.setdefault(name, [dict(r) for r in sess.cte_log])
            check(res)

        return first

    queries = []
    pool = ThreadPoolExecutor(ORACLE_THREADS)
    for n, q in O.STATEMENT_QUERIES.items():
        params = O.spec_params(base[n], SF) if n in base else {}
        sql = q.sql.format(**params) if n in base else q.sql
        queries.append((f"stmt_{n}", sql,
                        checked(f"stmt_{n}", oracle_check(cat, q, params, pool)), sess))
    oracles_first(pool, "statements X1-X9", ORACLE_THREADS)
    run_phase(
        queries, report, lambda n: cat.table("tpch", O.STATEMENT_BASE_TABLE[n[len("stmt_"):]]),
        before=lambda n: EK.reset_lut_stats(), warm_runs=PHASE_WARM_RUNS)
    for name, *_ in queries:
        r = report[name]
        r["lut_build_s"], r["lut_tables"] = luts[name]["seconds"], luts[name]["tables"]
        extra = ""
        if name in cte:
            r["cte"] = cte[name]
            c = cte[name][0]
            extra = (f", recursion {c['steps']} steps in {c['seconds']:.3f}s "
                     f"({c['seconds'] / max(c['steps'], 1) * 1e3:.2f} ms a step, first "
                     f"{c['first_step_s'] * 1e3:.2f}, slowest {c['max_step_s'] * 1e3:.2f})")
        log(f"{name}: warm ms {[round(w * 1e3, 2) for w in r['warm_s']]}, cold s "
            f"{r['cold_s']:.3f} (dictionary tables {r['lut_build_s']:.3f} s, "
            f"{r['lut_tables']} built), d2h fetches {r['d2h_fetches_per_warm_run']:.4g} and "
            f"h2d {r['h2d_bytes_per_warm_run']:.4g} B per warm run, rows {r['rows']}{extra}")

    # --- X7's refused writes: the JAX package's errors, no row written ---
    for sql, err in O.X7_REFUSED:
        try:
            sess.execute(sql)
        except ValueError as e:
            assert str(e) == err, (str(e), err)
        else:
            raise AssertionError(f"not refused: {sql}")
        (n,), = sess.execute("select count(*) from cust_profile").rows
        assert n == nprof, (n, nprof)
        log(f"statements: refused as the JAX package refuses it: {err}")

    # --- X10: EXPLAIN of the 22 queries, EXPLAIN ANALYZE of three ---
    tpch = {"q1": O.Q1_SQL, "q3": O.Q3_SQL, "q5": O.Q5_SQL, "q6": O.Q6_SQL}
    for n, q in O.TPCH_QUERIES.items():
        tpch[n] = q.sql.format(**O.spec_params(n, SF))
    t0 = time.perf_counter()
    explained = {n: [r[0] for r in sess.execute("explain " + sql).rows] for n, sql in tpch.items()}
    log(f"statements: EXPLAIN of {len(explained)} TPC-H queries in "
        f"{time.perf_counter() - t0:.2f}s, {sum(map(len, explained.values()))} lines")
    for n in EXPLAIN_ANALYZED:
        log(f"explain {n}:\n  " + "\n  ".join(explained[n]))
    want_rows = {
        "q1": len(O.numpy_q1(raw_columns(cat, ["l_shipdate", "l_returnflag", "l_linestatus",
                                              "l_quantity", "l_extendedprice", "l_discount",
                                              "l_tax"])[0])["cnt"].nonzero()[0]),
        "q3": len(O.numpy_q3(cat)[0]),
        "q18": min(len(O.TPCH_QUERIES["q18"].oracle(cat, **O.spec_params("q18", SF))), 100),
    }
    analyzed = {}
    for n in EXPLAIN_ANALYZED:
        sess.execute(tpch[n])  # cold where no earlier phase ran it
        t0 = time.perf_counter()
        rows = len(sess.execute(tpch[n]).rows)
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        lines = [r[0] for r in sess.execute("explain analyze " + tpch[n]).rows]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log(f"explain analyze {n} ({wall * 1e3:.2f} ms; the query {warm * 1e3:.2f} ms):\n  "
            + "\n  ".join(lines))
        root = lines[0]
        assert f" rows={want_rows[n]} " in root and rows == want_rows[n], (n, root, want_rows[n])
        assert all(line.rstrip().endswith("calls=1") for line in lines), (n, lines)
        analyzed[n] = {"wall_s": wall, "query_s": warm, "nodes": len(lines)}
    report["stmt_x10"] = {"explain_lines": {n: len(v) for n, v in explained.items()},
                          "analyze": analyzed}
    # run_phase zeroed the counts before X1: they now hold X1-X10's
    launches = dict(K.LAUNCHES)

    for t in ("cust_profile", "access_log"):
        sess.execute(f"drop table {t}")
    took = time.perf_counter() - t_phase
    log(f"statements: phase {took:.1f}s of {STATEMENTS_LIMIT_S:g}, launches {launches}")
    return launches


def statements_only(report) -> dict:
    """The SF10 tables, ANALYZEd, and the statements phase alone: the
    short loop for statement work. Returns the phase's launches."""
    from tidb_tpu_torch.bench import load_tpch
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage import Catalog

    t0 = time.perf_counter()
    cat = Catalog()
    load_tpch(cat, sf=SF, seed=1, tables=TABLES)
    sess = Session(cat, db="tpch")
    for t in TABLES:
        sess.execute(f"analyze table {t}")
    log(f"datagen and analyze: SF{SF:g} in {time.perf_counter() - t0:.1f}s")
    launches = statements_phase(cat, sess, report)
    for k, n in launches.items():
        assert n > 0, f"kernel {k} was not launched in the statements phase"
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
    pool = ThreadPoolExecutor(SPILL_ORACLE_THREADS)
    q1_oracle = q1_check(blk, li, pool)
    queries = [("q18_sf100", q18.sql.format(**params), oracle_check(cat, q18, params, pool), sess),
               ("q1_sf100", Q1_SQL, q1_oracle, sess),
               ("q21_sf100", q21.sql, oracle_check(cat, q21, {}, pool), sess),
               ("r1_sf100", r1.sql, oracle_check(cat, r1, {}, pool), sess),
               ("q1_quota_sf100", Q1_SQL, q1_oracle, qsess)]
    oracles_first(pool, f"spill SF{SPILL_SF:g}", SPILL_ORACLE_THREADS)
    expect = {"q18_sf100": ("streamed", "device"), "q1_sf100": ("streamed", "device"),
              "q21_sf100": ("partitioned", "device"), "r1_sf100": ("sort", "device"),
              "q1_quota_sf100": ("streamed", "host")}
    h0 = TRANSFERS["h2d_bytes"]
    # every run, cold and warm, is checked and its path asserted
    launches = run_phase(queries, report, lambda n: li, warm_runs=SPILL_WARM_RUNS)
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
        # no run leaves its staged batch, partials or partitions behind:
        # the last run ends where the first did
        assert r["resident_after"][-1] <= r["resident_after"][0] + (256 << 20), gb
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


# ---------------------------------------------------------------------------
# the MySQL server
# ---------------------------------------------------------------------------


class WireError(Exception):
    def __init__(self, errno: int, sqlstate: str, message: str):
        super().__init__(f"server error {errno} ({sqlstate}): {message}")
        self.errno, self.sqlstate, self.message = errno, sqlstate, message


class MysqlWire:
    """A raw-socket MySQL client on the port's protocol module (the card's
    machine has no MySQL client package): the handshake (as root, or as a
    user with a mysql_native_password password), COM_QUERY, COM_INIT_DB,
    COM_PING and the prepared-statement commands. A resultset's packets
    are read whole before its rows are decoded by their column types, so
    a statement's wire time is the server's. ``conn_id`` is the
    handshake's id; KILL takes the session's, CONNECTION_ID()."""

    def __init__(self, port: int, db=None, user: str = "root", password=None):
        from tidb_tpu_torch.server import protocol as P

        self.P = P
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=900)
        self.io = P.PacketIO(self.sock)
        greeting = self._read()
        assert greeting[0] == 0x0A, greeting
        self.conn_id = struct.unpack_from("<I", greeting, greeting.index(b"\x00", 1) + 1)[0]
        auth = b""
        if password is not None:
            h1 = hashlib.sha1(password.encode()).digest()
            mask = hashlib.sha1(P.scramble_from_handshake(greeting)
                                + hashlib.sha1(h1).digest()).digest()
            auth = bytes(a ^ b for a, b in zip(h1, mask))
        caps = P.CLIENT_PROTOCOL_41 | P.CLIENT_SECURE_CONNECTION
        if db:
            caps |= P.CLIENT_CONNECT_WITH_DB
        body = (struct.pack("<II", caps, 1 << 24) + bytes([0xFF]) + bytes(23)
                + user.encode() + b"\x00" + bytes([len(auth)]) + auth)
        if db:
            body += db.encode() + b"\x00"
        self.io.write_packet(body)
        self._read()

    def _read(self) -> bytes:
        pkt = self.io.read_packet()
        if pkt is None:
            raise ConnectionError("the server closed the connection")
        if pkt[0] == 0xFF:
            raise WireError(struct.unpack_from("<H", pkt, 1)[0], pkt[4:9].decode(),
                            pkt[9:].decode("utf-8", "replace"))
        return pkt

    def _send(self, cmd: int, payload: bytes = b"") -> None:
        self.io.reset_seq()
        self.io.write_packet(bytes([cmd]) + payload)

    @staticmethod
    def _lenenc(data: bytes, pos: int):
        v = data[pos]
        if v < 251:
            return v, pos + 1
        if v == 0xFC:
            return struct.unpack_from("<H", data, pos + 1)[0], pos + 3
        if v == 0xFD:
            return int.from_bytes(data[pos + 1:pos + 4], "little"), pos + 4
        return struct.unpack_from("<Q", data, pos + 1)[0], pos + 9

    def _column(self, d: bytes):
        pos, strs = 0, []
        for _ in range(6):
            ln, pos = self._lenenc(d, pos)
            strs.append(d[pos:pos + ln])
            pos += ln
        return strs[4].decode(), d[pos + 7]

    def _resultset(self, first: bytes, cursor: bool = False):
        """(column names, MySQL types, row packets) after `first`."""
        if first[0] == 0x00:
            return [], [], []
        n, _ = self._lenenc(first, 0)
        cols = [self._column(self._read()) for _ in range(n)]
        self._read()  # EOF
        rows = []
        if not cursor:
            while True:
                pkt = self._read()
                if pkt[0] == 0xFE and len(pkt) < 9:
                    break
                rows.append(pkt)
        return [c[0] for c in cols], [c[1] for c in cols], rows

    def _text_value(self, raw: bytes, t: int):
        P = self.P
        if t in (P.MYSQL_TYPE_LONGLONG, P.MYSQL_TYPE_TINY):
            return int(raw)
        if t in (P.MYSQL_TYPE_DOUBLE, P.MYSQL_TYPE_NEWDECIMAL):
            return float(raw)
        return raw.decode()

    def text_rows(self, pkts, types_):
        out = []
        for pkt in pkts:
            row, pos = [], 0
            for t in types_:
                if pkt[pos] == 0xFB:
                    row.append(None)
                    pos += 1
                    continue
                ln, pos = self._lenenc(pkt, pos)
                row.append(self._text_value(pkt[pos:pos + ln], t))
                pos += ln
            out.append(tuple(row))
        return out

    def binary_rows(self, pkts, types_):
        P, out = self.P, []
        nb = (len(types_) + 9) // 8
        for pkt in pkts:
            bitmap, pos, row = pkt[1:1 + nb], 1 + nb, []
            for i, t in enumerate(types_):
                if bitmap[(i + 2) // 8] & (1 << ((i + 2) % 8)):
                    row.append(None)
                elif t == P.MYSQL_TYPE_LONGLONG:
                    row.append(struct.unpack_from("<q", pkt, pos)[0])
                    pos += 8
                elif t == P.MYSQL_TYPE_DOUBLE:
                    row.append(struct.unpack_from("<d", pkt, pos)[0])
                    pos += 8
                elif t == P.MYSQL_TYPE_TINY:
                    row.append(struct.unpack_from("<b", pkt, pos)[0])
                    pos += 1
                elif t == P.MYSQL_TYPE_DATE:
                    y, m, d = struct.unpack_from("<HBB", pkt, pos + 1)
                    row.append(f"{y:04d}-{m:02d}-{d:02d}")
                    pos += 1 + pkt[pos]
                else:
                    ln, pos = self._lenenc(pkt, pos)
                    row.append(self._text_value(pkt[pos:pos + ln], t))
                    pos += ln
            out.append(tuple(row))
        return out

    def command(self, cmd: int, payload: bytes = b"") -> bytes:
        self._send(cmd, payload)
        return self._read()

    def write(self, sql: str):
        """A statement answered by an OK packet: (affected rows,
        last_insert_id, seconds)."""
        t0 = time.perf_counter()
        self._send(0x03, sql.encode())
        ok = self._read()
        secs = time.perf_counter() - t0
        assert ok[0] == 0x00, ok
        affected, pos = self._lenenc(ok, 1)
        last_id, _pos = self._lenenc(ok, pos)
        return affected, last_id, secs

    def query(self, sql: str):
        """(column names, rows, seconds from the command to the last packet)."""
        t0 = time.perf_counter()
        self._send(0x03, sql.encode())
        cols, types_, pkts = self._resultset(self._read())
        secs = time.perf_counter() - t0
        return cols, self.text_rows(pkts, types_), secs

    def prepare(self, sql: str):
        """COM_STMT_PREPARE: (statement id, parameter count)."""
        ok = self.command(0x16, sql.encode())
        sid, ncols, nparams = struct.unpack_from("<IHH", ok, 1)
        for n in (nparams, ncols):
            if n:
                for _ in range(n + 1):
                    self._read()
        return sid, nparams

    def execute(self, sid: int, params, cursor: bool = False):
        """COM_STMT_EXECUTE with (MySQL type, value) parameters: (rows,
        seconds), or the column types alone when a read-only cursor holds
        the rows."""
        P = self.P
        payload = struct.pack("<IBI", sid, P.CURSOR_TYPE_READ_ONLY if cursor else 0, 1)
        if params:
            vals = b""
            for t, v in params:
                if t == P.MYSQL_TYPE_LONGLONG:
                    vals += struct.pack("<q", v)
                elif t == P.MYSQL_TYPE_DOUBLE:
                    vals += struct.pack("<d", v)
                elif t == P.MYSQL_TYPE_DATE:
                    y, m, d = (int(x) for x in v.split("-"))
                    vals += bytes([4]) + struct.pack("<HBB", y, m, d)
                else:
                    vals += P.lenenc_str(str(v).encode())
            payload += bytes((len(params) + 7) // 8) + b"\x01"
            payload += b"".join(struct.pack("<H", t) for t, _v in params) + vals
        t0 = time.perf_counter()
        self._send(0x17, payload)
        _cols, types_, pkts = self._resultset(self._read(), cursor)
        if cursor:
            return types_
        return self.binary_rows(pkts, types_), time.perf_counter() - t0

    def fetch_all(self, sid: int, types_, n: int):
        """COM_STMT_FETCH `n` rows at a time until the cursor is drained:
        (rows, fetches, seconds)."""
        rows, fetches, t0 = [], 0, time.perf_counter()
        while True:
            self._send(0x1C, struct.pack("<II", sid, n))
            fetches += 1
            pkts = []
            while True:
                pkt = self._read()
                if pkt[0] == 0xFE and len(pkt) < 9:
                    break
                pkts.append(pkt)
            rows += self.binary_rows(pkts, types_)
            if struct.unpack_from("<H", pkt, 3)[0] & self.P.SERVER_STATUS_LAST_ROW_SENT:
                return rows, fetches, time.perf_counter() - t0

    def close(self) -> None:
        self._send(0x01)
        self.sock.close()


#: TPC-H Q6 with its substitution parameters as '?': DATE, DATE + 1 year,
#: DISCOUNT - 0.01, DISCOUNT + 0.01, QUANTITY
Q6_PARAMS_SQL = (
    "select sum(l_extendedprice * l_discount) as revenue from lineitem "
    "where l_shipdate >= ? and l_shipdate < ? and l_discount between ? and ? "
    "and l_quantity < ?"
)
#: (DATE, DATE + 1 year, DISCOUNT in hundredths, QUANTITY): the
#: specification's validation values, then another set in its ranges
Q6_PARAMS = [("1994-01-01", "1995-01-01", 6, 24), ("1995-01-01", "1996-01-01", 4, 25)]
#: rows a COM_STMT_FETCH asks for
FETCH_ROWS = 10_000
#: the SF of the tidb_server subprocess's TPC-H (load_tpch's default seed)
BINARY_SF = 1.0
#: R1's runs over the text protocol, from this process's client and from
#: a client process of its own (7.4-10.3 s a run: one keeps its rows/s)
R1_WIRE_RUNS = 1


def start_binary(sf: float):
    """`python3 -m tidb_tpu_torch.tidb_server --tpch SF -P 0`: the process
    and the port it printed."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "tidb_tpu_torch.tidb_server", "--tpch", f"{sf:g}", "-P", "0"],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    lines = []
    while True:
        line = proc.stdout.readline()
        if not line:
            proc.wait(timeout=60)
            raise RuntimeError(f"tidb_server exited {proc.returncode}: {''.join(lines)[-3000:]}")
        lines.append(line)
        if "listening on" in line:
            return proc, int(line.rsplit(":", 1)[1])


def stop_binary(proc) -> int:
    proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise


#: a MysqlWire client in a process of its own: argv a file the server's
#: port will be written to, and the SQL; it imports while the phase runs,
#: waits for the port, and prints the rows and each run's wire seconds as
#: JSON
CLIENT_CHILD = """
import json, os, sys, time
sys.path.insert(0, {root!r})
import chip_smoke
from tidb_tpu_torch.server import protocol  # noqa: F401 (MysqlWire's import, before the wait)
deadline = time.monotonic() + 900
while not os.path.exists(sys.argv[1]):
    if time.monotonic() > deadline:
        sys.exit("no port")
    time.sleep(0.05)
with open(sys.argv[1]) as f:
    port = int(f.read())
c = chip_smoke.MysqlWire(port, db="tpch")
wire = []
for _ in range(chip_smoke.R1_WIRE_RUNS):
    _cols, rows, secs = c.query(sys.argv[2])
    wire.append(secs)
c.close()
print(json.dumps({{"wire_s": wire, "rows": rows}}))
"""


def encode_seconds(res) -> dict:
    """Seconds the server's row encoding takes for `res`, without a
    socket: text rows as _write_result builds them, and binary rows."""
    from tidb_tpu_torch.server import protocol as P

    types_ = res.types
    t0 = time.perf_counter()
    for row in res.rows:
        payload = b""
        for v, t in zip(row, types_):
            fv = P.format_value(v, t)
            payload += b"\xfb" if fv is None else P.lenenc_str(fv)
    t1 = time.perf_counter()
    for row in res.rows:
        P.binary_row(row, types_)
    return {"text_s": t1 - t0, "binary_s": time.perf_counter() - t1}


def server_phase(cat, blk, sess, checks, report) -> dict:
    """The server phase: the port's MySQL server on the card over the SF10
    tables phase 5 left resident, driven by MysqlWire. Returns the phase's
    launches."""
    import shutil
    import tempfile

    from tidb_tpu_torch.bench import load_tpch
    from tidb_tpu_torch.bench.oracles import (
        R1_SQL, SPILL_REPORTS, numpy_q1, numpy_q6,
    )
    from tidb_tpu_torch.dtypes import date_to_days
    from tidb_tpu_torch.executor import kernels as K
    from tidb_tpu_torch.server import Server
    from tidb_tpu_torch.server import protocol as P
    from tidb_tpu_torch.storage import Catalog

    out = report["server"] = {}
    r1_check = oracle_check(cat, SPILL_REPORTS["r1"], {})
    checks = dict(checks, r1=(R1_SQL, r1_check))
    # R1 in-process, for its wire time to stand beside (phase 5 ran no R1)
    warm = []
    for i in range(4):
        t0 = time.perf_counter()
        res = sess.execute(R1_SQL)
        if i:
            warm.append(time.perf_counter() - t0)
        r1_check(res)
    report["r1"] = {"rows": len(res.rows), "warm_s": warm}
    out["r1_encode"] = encode_seconds(res)
    log(f"r1 in-process: {len(res.rows)} rows, warm s {warm}; encoding its rows "
        + json.dumps(out["r1_encode"]))

    K.reset_launches()
    srv = Server(cat, port=0)
    srv.start_background()
    # R1's client in a process of its own, importing while the text
    # protocol runs below
    port_dir = tempfile.mkdtemp(prefix="chip_smoke_server_", dir=tempfile.gettempdir())
    port_file = os.path.join(port_dir, "port")
    child = subprocess.Popen(
        [sys.executable, "-c", CLIENT_CHILD.format(root=ROOT), port_file, R1_SQL],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
    try:
        # --- a client's first words ---
        c = MysqlWire(srv.port)
        _cols, rows, _s = c.query("select @@version_comment limit 1")
        assert rows == [(sess.vars.get("version_comment"),)], rows
        assert c.command(0x02, b"tpch")[0] == 0x00  # COM_INIT_DB
        assert c.command(0x0E)[0] == 0x00  # COM_PING
        log(f"server: listening on {srv.port}, connected as root: {rows[0][0]!r}")

        # --- text protocol ---
        for name in ("q1", "q6", "q3", "q18", "r1"):
            sql, check = checks[name]
            wire = []
            for _ in range(R1_WIRE_RUNS if name == "r1" else 3):
                _cols, rows, secs = c.query(sql)
                check(types.SimpleNamespace(rows=rows))
                wire.append(secs)
            local = float(np.median(report[name]["warm_s"]))
            out[name] = {"rows": len(rows), "wire_s": wire, "in_process_warm_s": report[name]["warm_s"],
                         "protocol_adds_s": float(np.median(wire)) - local,
                         "rows_per_s": len(rows) / float(np.median(wire))}
            log(f"server text {name}: " + json.dumps(out[name]))

        # R1 from a client in a process of its own: no interpreter lock
        # shared between the client's reads and the server's writes
        with open(port_file + ".tmp", "w") as f:
            f.write(str(srv.port))
        os.replace(port_file + ".tmp", port_file)
        child_out, child_err = child.communicate(timeout=900)
        assert child.returncode == 0, child_err[-3000:]
        sep = json.loads(child_out.strip().splitlines()[-1])
        r1_check(types.SimpleNamespace(rows=[tuple(r) for r in sep["rows"]]))
        out["r1_other_process"] = {"rows": len(sep["rows"]), "wire_s": sep["wire_s"],
                                   "rows_per_s": len(sep["rows"]) / float(np.median(sep["wire_s"]))}
        log("server text r1, client in another process: " + json.dumps(out["r1_other_process"]))

        # --- binary protocol: Q6 with parameters, R1 through a cursor ---
        sid, nparams = c.prepare(Q6_PARAMS_SQL)
        assert nparams == 5, nparams
        q6 = []
        for d0, d1, disc, qty in Q6_PARAMS:
            params = [(P.MYSQL_TYPE_DATE, d0), (P.MYSQL_TYPE_DATE, d1),
                      (P.MYSQL_TYPE_DOUBLE, (disc - 1) / 100), (P.MYSQL_TYPE_DOUBLE, (disc + 1) / 100),
                      (P.MYSQL_TYPE_LONGLONG, qty)]
            want = np.int64(numpy_q6(blk, date_to_days(d0), date_to_days(d1), disc, qty)) / 10**4
            for _ in range(3):
                rows, secs = c.execute(sid, params)
                assert rows == [(want,)], (rows, want, d0, disc, qty)
                q6.append(secs)
        out["q6_execute_s"] = q6
        sid, _n = c.prepare(R1_SQL)
        types_ = c.execute(sid, [], cursor=True)
        rows, fetches, secs = c.fetch_all(sid, types_, FETCH_ROWS)
        r1_check(types.SimpleNamespace(rows=rows))
        out["r1_cursor"] = {"rows": len(rows), "fetches": fetches, "s": secs, "rows_per_s": len(rows) / secs}
        log(f"server binary: Q6 EXECUTE s {q6} (each equal to numpy_q6 at its parameters); "
            f"R1 cursor " + json.dumps(out["r1_cursor"]))

        # --- errors: the JAX server's errno, and the connection lives ---
        try:
            c.query("select * from no_such_table")
            raise AssertionError("an unknown table returned rows")
        except WireError as e:
            assert e.errno == 1105 and e.sqlstate == "HY000" and "unknown table" in e.message, e
            log(f"server error: {e}")
        assert c.query("select 1 + 1")[1] == [("2",)]
        c.close()

        # --- the quota through SET, on a fresh connection ---
        c = MysqlWire(srv.port, db="tpch")
        c.query(f"set tidb_mem_quota_query = {SPILL_QUOTA}")
        sql, check = checks["q1"]
        _cols, rows, secs = c.query(sql)
        check(types.SimpleNamespace(rows=rows))
        ex = srv.sessions[c.conn_id].executor
        recs = ex.stream_log
        log(f"server quota'd q1: {secs:.3f} s; executor quota {ex.quota_bytes}; stream_log "
            + json.dumps([{k: r.get(k) for k in ("path", "mode", "chunks", "why", "quota_bytes")}
                          for r in recs]))
        assert ex.quota_bytes == SPILL_QUOTA and recs, (ex.quota_bytes, recs)
        assert all(r["quota_bytes"] == SPILL_QUOTA for r in recs), recs
        out["q1_quota"] = {"s": secs, "paths": [(r["path"], r["mode"]) for r in recs]}
        c.close()

        # --- four connections at once ---
        names = ["q1", "q6", "q5", "q3"]
        got = {n: [] for n in names}
        errors = []

        def client(n):
            try:
                w = MysqlWire(srv.port, db="tpch")
                for _ in range(3):
                    got[n].append(w.query(checks[n][0]))
                w.close()
            except BaseException as e:  # raised below, after the join
                errors.append((n, e))

        threads = [threading.Thread(target=client, args=(n,)) for n in names]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        assert not errors, errors
        for n in names:
            for _cols, rows, _s in got[n]:
                checks[n][1](types.SimpleNamespace(rows=rows))
        out["concurrent"] = {"wall_s": wall, "statements": 12,
                             "wire_s": {n: [s for _c, _r, s in got[n]] for n in names}}
        log("server concurrent: " + json.dumps(out["concurrent"]))
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=60)
        shutil.rmtree(port_dir, ignore_errors=True)
        srv.shutdown()
    launches = dict(K.LAUNCHES)

    # --- the binary ---
    def sf1_oracle():
        sf1 = Catalog()
        load_tpch(sf1, sf=BINARY_SF, tables=["orders", "lineitem"])
        blk1, li1 = raw_columns(sf1, ["l_shipdate", "l_returnflag", "l_linestatus", "l_quantity",
                                      "l_extendedprice", "l_discount", "l_tax"])
        return numpy_q1(blk1), li1

    # the same SF1 data generated here for the oracle, on a thread while
    # the binary generates its own and boots
    with ThreadPoolExecutor(1) as one:
        oracle1 = one.submit(sf1_oracle)
        t0 = time.perf_counter()
        proc, port = start_binary(BINARY_SF)
        try:
            started = time.perf_counter() - t0
            want1, li1 = oracle1.result()
            w = MysqlWire(port, db="tpch")
            _cols, rows, secs = w.query(checks["q1"][0])
            w.close()
            check_q1(types.SimpleNamespace(rows=rows), want1, li1)
        finally:
            rc = stop_binary(proc)
    assert rc == 0, rc
    out["binary"] = {"sf": BINARY_SF, "start_s": started, "q1_cold_s": secs, "exit": rc}
    log("server binary: " + json.dumps(out["binary"]))
    return launches


# ---------------------------------------------------------------------------
# the refresh phase: TPC-H's refresh functions through Session
# ---------------------------------------------------------------------------

#: orders RF1 inserts and RF2 deletes: SF x 1500 (TPC-H v3 clause 2.5)
RF_ORDERS = int(SF * 1500)
#: rows per INSERT ... VALUES and keys per IN (...) list
RF_BATCH = 1000
#: the columns the refresh phase's oracles read, captured before it
RF_COLUMNS = {
    "lineitem": ["l_orderkey", "l_quantity", "l_extendedprice", "l_discount", "l_tax",
                 "l_returnflag", "l_linestatus", "l_shipdate"],
    "orders": ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority", "o_totalprice"],
    "customer": ["c_custkey", "c_mktsegment"],
}
#: a query over tables the phase never writes: after a write it must
#: copy nothing host->device
UNWRITTEN_SQL = ("select n_name, count(*) from supplier, nation "
                 "where s_nationkey = n_nationkey group by n_name")
#: the summary table of the DDL step: Q1's groups, an AUTO_INCREMENT id
SUMMARY_DDL = (
    "create table rf_summary (id bigint primary key auto_increment, "
    "l_returnflag char(1) not null, l_linestatus char(1) not null, "
    "sum_qty decimal(15,2), sum_base_price decimal(15,2), count_order bigint)"
)
SUMMARY_FILL = (
    "insert into rf_summary (l_returnflag, l_linestatus, sum_qty, sum_base_price, count_order) "
    "select l_returnflag, l_linestatus, sum(l_quantity), sum(l_extendedprice), count(*) "
    "from lineitem where l_shipdate <= date '1998-12-01' - interval '90' day "
    "group by l_returnflag, l_linestatus order by l_returnflag, l_linestatus"
)


def rf1_data(cat, rng, sf: float, n: int, fresh: int, db: str = "tpch"):
    """RF1's new rows at scale `sf`, drawn with the port generator's
    distributions: `n` orders above the table's largest o_orderkey, one
    to seven line items each. The first `fresh` orders' o_comment values
    are new to the table's dictionary and sort inside it. Returns
    {table: {column: array}} (strings as str objects, decimals as scaled
    integers)."""
    from tidb_tpu_torch.bench import tpch as G

    top = max(int(b.columns["o_orderkey"].data.max()) for b in cat.table(db, "orders").blocks())
    n_cust = max(int(150_000 * sf), 100)
    n_parts = max(int(200_000 * sf), 1000)
    n_supps = max(int(10_000 * sf), 100)

    def pick(words, k):
        return np.array(words, dtype=object)[rng.integers(0, len(words), k)]

    keys = np.arange(top + 1, top + 1 + n, dtype=np.int64)
    comment = pick(G._O_COMMENTS, n)
    comment[:fresh] = [f"rf1 fresh comment {i % 97}" for i in range(min(fresh, n))]
    orders = {
        "o_orderkey": keys,
        "o_custkey": rng.integers(1, n_cust + 1, n),
        "o_orderstatus": pick(["F", "O", "P"], n),
        "o_totalprice": rng.integers(90_000, 50_000_000, n),
        "o_orderdate": rng.integers(G._D_LO, G._D_HI - 151, n),
        "o_orderpriority": pick(G._PRIORITIES, n),
        "o_shippriority": np.zeros(n, dtype=np.int64),
        "o_comment": comment,
    }
    per = rng.integers(1, 8, n)
    m = int(per.sum())
    starts = np.repeat(np.cumsum(per) - per, per)
    partkey = rng.integers(1, n_parts + 1, m)
    lineitem = {
        "l_orderkey": np.repeat(keys, per),
        "l_partkey": partkey,
        "l_suppkey": G._supp_for_part(partkey, rng.integers(0, 4, m), n_supps),
        "l_linenumber": np.arange(m) - starts + 1,
        "l_quantity": rng.integers(1, 51, m) * 100,
        "l_extendedprice": rng.integers(90_000, 10_500_000, m),
        "l_discount": rng.integers(0, 11, m),
        "l_tax": rng.integers(0, 9, m),
        "l_returnflag": pick(["A", "N", "R"], m),
        "l_linestatus": pick(["F", "O"], m),
        "l_shipdate": rng.integers(G._D_LO, G._D_HI, m),
        "l_commitdate": rng.integers(G._D_LO, G._D_HI, m),
        "l_receiptdate": rng.integers(G._D_LO, G._D_HI, m),
        "l_shipmode": pick(G._SHIPMODES, m),
        "l_shipinstruct": pick(G._SHIPINSTRUCT, m),
    }
    return {"orders": orders, "lineitem": lineitem}


def insert_sql(table, kinds, cols, lo, hi) -> str:
    """INSERT ... VALUES of rows [lo, hi) of `cols`, each column rendered
    by its kind (int, dec: a scale-2 integer, date: epoch days, str)."""

    def render(kind, values):
        if kind == "int":
            return [str(int(v)) for v in values]
        if kind == "dec":
            return [f"{int(v) // 100}.{int(v) % 100:02d}" for v in values]
        if kind == "date":
            return [f"'{present_date(v)}'" for v in values]
        return [f"'{v}'" for v in values]

    parts = [render(kind, cols[name][lo:hi]) for name, kind in kinds]
    rows = ", ".join("(" + ", ".join(r) + ")" for r in zip(*parts))
    return f"insert into {table} ({', '.join(n for n, _k in kinds)}) values {rows}"


ORDERS_KINDS = [("o_orderkey", "int"), ("o_custkey", "int"), ("o_orderstatus", "str"),
                ("o_totalprice", "dec"), ("o_orderdate", "date"), ("o_orderpriority", "str"),
                ("o_shippriority", "int"), ("o_comment", "str")]
LINEITEM_KINDS = [("l_orderkey", "int"), ("l_partkey", "int"), ("l_suppkey", "int"),
                  ("l_linenumber", "int"), ("l_quantity", "dec"), ("l_extendedprice", "dec"),
                  ("l_discount", "dec"), ("l_tax", "dec"), ("l_returnflag", "str"),
                  ("l_linestatus", "str"), ("l_shipdate", "date"), ("l_commitdate", "date"),
                  ("l_receiptdate", "date"), ("l_shipmode", "str"), ("l_shipinstruct", "str")]


def oracle_catalog(cat, arrays, db: str = "tpch"):
    """A catalog of one block per table built from numpy arrays with
    replace_blocks (never through the DML under test): `arrays` maps
    table -> column -> data; strings are codes into the SF10 table's
    dictionary, which these columns never grow."""
    from tidb_tpu_torch.chunk import HostBlock, HostColumn
    from tidb_tpu_torch.storage import Catalog, TableSchema

    ocat = Catalog()
    ocat.create_database("tpch")
    for name, cols in arrays.items():
        src = cat.table(db, name)
        types_ = src.schema.types
        hc = {c: HostColumn(types_[c], d, np.ones(len(d), dtype=bool), src.dictionaries.get(c))
              for c, d in cols.items()}
        t = ocat.create_table("tpch", name, TableSchema([(c, types_[c]) for c in cols]))
        t.dictionaries.update({c: src.dictionaries[c] for c in cols if c in src.dictionaries})
        t.replace_blocks([HostBlock.from_columns(hc)])
    return ocat


def oracle_append(ora, cat, rows) -> None:
    """The oracle's arrays after RF1: `rows` appended, strings as codes
    of the committed tables' dictionaries."""
    for name, arrays in rows.items():
        t = cat.table("tpch", name)
        for c in list(ora.get(name, ())):
            add = arrays[c]
            if c in t.dictionaries:
                add = np.searchsorted(t.dictionaries[c], add).astype(np.int32)
            ora[name][c] = np.concatenate([ora[name][c], add.astype(ora[name][c].dtype)])


#: the refresh phase's UPDATE of l_extendedprice
PRICE_UPDATE = "update lineitem set l_extendedprice = l_extendedprice * 1.05"


def oracle_price_update(ora, keys, exact: bool = False) -> None:
    """The oracle's l_extendedprice after PRICE_UPDATE on the orders
    `keys`: a DOUBLE product (a literal with a fraction is a DOUBLE),
    cast back to the column's DECIMAL(2) rounding half to even, as the
    engine's CAST does. `exact`: after ``* cast(1.05 as decimal(3,2))``
    instead, a scale-4 integer product cast back by floor division."""
    li = ora["lineitem"]
    hit = np.isin(li["l_orderkey"], keys)
    price = li["l_extendedprice"].copy()
    if exact:
        price[hit] = price[hit] * 105 // 100
    else:
        price[hit] = np.round(price[hit].astype(np.float64) / 100 * 1.05 * 100).astype(np.int64)
    li["l_extendedprice"] = price


def oracle_delete(ora, keys) -> None:
    """The oracle's arrays after RF2: the orders `keys` and their line
    items gone."""
    for name, kc in (("lineitem", "l_orderkey"), ("orders", "o_orderkey")):
        keep = ~np.isin(ora[name][kc], keys)
        ora[name] = {c: d[keep] for c, d in ora[name].items()}


def rss_gb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024 / 1e9
    return 0.0


def refresh_phase(cat, sess, report) -> dict:
    """The refresh phase: DDL, TPC-H RF1 and RF2 (SF x 1500 orders each,
    one transaction each), UPDATEs of the RF1 rows, a rolled-back DELETE
    and writes over the wire, on phase 5's SF10 tables through Session
    on the card. Every query after a write is checked against the numpy
    oracles over an oracle catalog built from arrays. Returns the
    phase's launches."""
    import torch

    from tidb_tpu_torch.bench.oracles import (
        Q1_SQL, Q3_SQL, Q6_SQL, TPCH_QUERIES, check_rows, numpy_q1, numpy_q3, numpy_q6,
        spec_params,
    )
    from tidb_tpu_torch.chunk import TRANSFERS
    from tidb_tpu_torch.executor import kernels as K
    from tidb_tpu_torch.server import Server
    from tidb_tpu_torch.storage import scan

    out = report["refresh"] = {"statements": {}, "queries": {}, "steps": {}}
    phase_t0 = time.perf_counter()
    K.reset_launches()
    li_t = cat.table("tpch", "lineitem")
    ora = {name: {c: cat.table("tpch", name).blocks()[0].columns[c].data for c in cols}
           for name, cols in RF_COLUMNS.items()}
    rf1 = rf1_data(cat, np.random.default_rng(7), SF, RF_ORDERS, RF_BATCH)
    q18 = TPCH_QUERIES["q18"]
    q18_params = spec_params("q18", SF)
    sqls = {"q1": Q1_SQL, "q6": Q6_SQL, "q3": Q3_SQL, "q18": q18.sql.format(**q18_params)}
    # what each path took, by the columnar UPDATE's answer
    paths = []
    columnar = sess._try_columnar_update

    def spy(*a):
        r = columnar(*a)
        paths.append("columnar" if r is not None else "rewrite")
        return r

    sess._try_columnar_update = spy
    shadows = set()

    def note_shadows():
        shadows.update(sh.uid for sh in sess._txn["shadows"].values())

    def checks_now(names):
        """The checks of `names` against the oracle catalog of now: each
        oracle computed once, all of them side by side on threads, and
        done before the step's timed runs."""
        ocat = oracle_catalog(cat, ora)
        blk = ora["lineitem"]
        with ThreadPoolExecutor(len(names)) as pool:
            fut = {"q1": lambda: numpy_q1(blk), "q6": lambda: numpy_q6(blk),
                   "q3": lambda: numpy_q3(ocat),
                   "q18": lambda: q18.oracle(ocat, **q18_params)}
            want = {n: pool.submit(fut[n]) for n in names}
        want = {n: f.result() for n, f in want.items()}
        return {"q1": lambda r: check_q1(r, want["q1"], li_t),
                "q6": lambda r: _check_q6_value(r, want["q6"]),
                "q3": lambda r: check_q3(r, ocat, want["q3"]),
                "q18": lambda r: check_rows(r.rows, want["q18"], q18.order, q18.limit)}

    def stmt(step, sql, affected=None, label=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sess.execute(sql)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        if affected is not None:
            assert res.affected == affected, (label or sql[:80], res.affected, affected)
        out["statements"].setdefault(step, []).append(
            [label or sql.split(" (")[0][:60], secs, res.affected])
        return res

    def queries(step, names, warm_runs=PHASE_WARM_RUNS, checks=None):
        """Each of `names` cold once and warm `warm_runs` times, every run
        checked (against `checks` when given, else the oracles of now);
        returns the checks."""
        checks = checks or checks_now(names)
        rows = out["queries"].setdefault(step, {})
        for name in names:
            torch.cuda.synchronize()
            h0 = TRANSFERS["h2d_bytes"]
            t0 = time.perf_counter()
            res = sess.execute(sqls[name])
            torch.cuda.synchronize()
            cold = time.perf_counter() - t0
            h2d_cold = TRANSFERS["h2d_bytes"] - h0
            checks[name](res)
            warm, f0 = [], TRANSFERS["d2h_fetches"]
            for _ in range(warm_runs):
                t0 = time.perf_counter()
                res = sess.execute(sqls[name])
                torch.cuda.synchronize()
                warm.append((time.perf_counter() - t0) * 1e3)
                checks[name](res)
            rows[name] = {"cold_s": cold, "warm_ms": warm, "h2d_bytes_cold": h2d_cold,
                          "d2h_fetches_per_warm_run": (TRANSFERS["d2h_fetches"] - f0) / max(warm_runs, 1)}
            log(f"refresh {step} {name}: " + json.dumps(rows[name]))
        return checks

    def unwritten(step):
        h0 = TRANSFERS["h2d_bytes"]
        sess.execute(UNWRITTEN_SQL)
        moved = TRANSFERS["h2d_bytes"] - h0
        assert moved == 0, f"{step}: a query over unwritten tables copied {moved} B host->device"

    def step_done(step, t0):
        torch.cuda.synchronize()
        names = {cat.table("tpch", n).uid: n for n in cat.tables("tpch")}
        by_table = {}
        for uid, nbytes in scan.device_bytes_by_table().items():
            key = names.get(uid, "other")
            by_table[key] = by_table.get(key, 0) + nbytes
        out["steps"][step] = {
            "s": time.perf_counter() - t0,
            "peak_device_gb": torch.cuda.max_memory_allocated() / 1e9,
            "cache_bytes_by_table": by_table,
            "rss_gb": rss_gb(),
            "statements": len(out["statements"].get(step, [])),
            "statement_s": sum(x[1] for x in out["statements"].get(step, [])),
        }
        log(f"refresh step {step}: " + json.dumps(out["steps"][step]))
        torch.cuda.reset_peak_memory_stats()

    sess.execute(UNWRITTEN_SQL)  # its columns resident before any write
    torch.cuda.reset_peak_memory_stats()

    # --- 1. DDL: a summary table from Q1's groups ---
    t0 = time.perf_counter()
    stmt("ddl", SUMMARY_DDL, 0, "create table")
    o = numpy_q1(ora["lineitem"])
    groups = [k for k in range(6) if o["cnt"][k]]
    stmt("ddl", SUMMARY_FILL, len(groups), "insert ... select")
    got = sess.execute("select id, l_returnflag, l_linestatus, sum_qty, sum_base_price, "
                       "count_order from rf_summary order by id").rows
    rf, ls = li_t.dictionaries["l_returnflag"], li_t.dictionaries["l_linestatus"]
    want = [(i + 1, rf[k // 2], ls[k % 2], o["sum_qty"][k] / 100, o["sum_base"][k] / 100,
             o["cnt"][k]) for i, k in enumerate(groups)]
    assert [tuple(r) for r in got] == want, (got, want)
    stmt("ddl", "truncate table rf_summary", 0, "truncate")
    stmt("ddl", "insert into rf_summary (l_returnflag, l_linestatus, count_order) "
                "values ('A', 'F', 1), ('N', 'O', 2), ('R', 'F', 3)", 3, "insert 3 rows")
    assert sess.execute("select last_insert_id()").rows == [(1,)]
    assert sess.execute("select max(id), count(*) from rf_summary").rows == [(3, 3)]
    stmt("ddl", "drop table rf_summary", 0, "drop table")
    step_done("ddl", t0)

    # --- 2. RF1: one transaction, batches of RF_BATCH rows ---
    t0 = time.perf_counter()
    n_li0, n_o0 = li_t.nrows, cat.table("tpch", "orders").nrows
    stmt("rf1", "begin")
    new_o, new_li = rf1["orders"], rf1["lineitem"]
    for lo in range(0, RF_ORDERS, RF_BATCH):
        hi = min(lo + RF_BATCH, RF_ORDERS)
        stmt("rf1", insert_sql("orders", ORDERS_KINDS, new_o, lo, hi), hi - lo, "insert orders")
    n_new_li = len(new_li["l_orderkey"])
    for lo in range(0, n_new_li, RF_BATCH):
        hi = min(lo + RF_BATCH, n_new_li)
        stmt("rf1", insert_sql("lineitem", LINEITEM_KINDS, new_li, lo, hi), hi - lo,
             "insert lineitem")
    assert sess.execute("select count(*) from lineitem").rows == [(n_li0 + n_new_li,)]
    note_shadows()
    stmt("rf1", "commit")
    assert li_t.nrows == n_li0 + n_new_li
    assert cat.table("tpch", "orders").nrows == n_o0 + RF_ORDERS
    assert any(str(x).startswith("rf1 fresh") for x in cat.table("tpch", "orders").dictionaries["o_comment"])
    oracle_append(ora, cat, rf1)
    step_done("rf1", t0)
    t0 = time.perf_counter()
    unwritten("rf1")
    queries("rf1", ["q1", "q6", "q3", "q18"])
    step_done("after_rf1", t0)

    # --- 3. UPDATE: the RF1 orders, in batches of RF_BATCH keys ---
    t0 = time.perf_counter()
    keys = new_o["o_orderkey"]
    li_keys = new_li["l_orderkey"]
    for lo in range(0, RF_ORDERS, RF_BATCH):
        batch = keys[lo:lo + RF_BATCH]
        in_list = ", ".join(str(int(k)) for k in batch)
        stmt("update", f"update orders set o_orderstatus = 'F' where o_orderkey in ({in_list})",
             len(batch), "update orders o_orderstatus")
        stmt("update", f"{PRICE_UPDATE} where l_orderkey in ({in_list})",
             int(np.isin(li_keys, batch).sum()),
             "update lineitem l_extendedprice")
    out["update_paths"] = sorted(set(paths))
    log(f"refresh update paths: {paths.count('columnar')} columnar, {paths.count('rewrite')} rewrite")
    assert paths and set(paths) == {"columnar"}, paths
    assert sess.execute(
        f"select count(*) from orders where o_orderkey > {int(keys[0]) - 1} and o_orderstatus = 'F'"
    ).rows == [(RF_ORDERS,)]
    oracle_price_update(ora, keys)
    li = ora["lineitem"]
    step_done("update", t0)
    t0 = time.perf_counter()
    update_checks = queries("update", ["q1", "q6"])
    step_done("after_update", t0)

    # --- 4. a rolled-back DELETE ---
    t0 = time.perf_counter()
    rb = np.arange(RF_ORDERS + 1, RF_ORDERS + 1 + RF_BATCH, dtype=np.int64)
    n_li = li_t.nrows
    n_rb = int(np.isin(li["l_orderkey"], rb).sum())
    stmt("rollback", "begin")
    stmt("rollback", "delete from lineitem where l_orderkey in ("
         + ", ".join(str(int(k)) for k in rb) + ")", n_rb, "delete lineitem")
    assert sess.execute("select count(*) from lineitem").rows == [(n_li - n_rb,)]
    note_shadows()
    stmt("rollback", "rollback")
    assert sess.execute("select count(*) from lineitem").rows == [(n_li,)]
    # the rolled-back DELETE leaves the rows the UPDATEs left: their oracles
    queries("rollback", ["q1"], warm_runs=0, checks=update_checks)
    step_done("rollback", t0)

    # --- 5. RF2: one transaction, batches of RF_BATCH keys ---
    t0 = time.perf_counter()
    old = np.arange(1, RF_ORDERS + 1, dtype=np.int64)
    stmt("rf2", "begin")
    # each batch's line items, counted in one pass over lineitem's keys
    # (old holds the keys 1..RF_ORDERS, RF_BATCH to a batch)
    lk = li["l_orderkey"]
    in_old = (lk >= 1) & (lk <= RF_ORDERS)
    per_batch = np.bincount((lk[in_old] - 1) // RF_BATCH, minlength=-(-RF_ORDERS // RF_BATCH))
    for lo in range(0, RF_ORDERS, RF_BATCH):
        batch = old[lo:lo + RF_BATCH]
        in_list = ", ".join(str(int(k)) for k in batch)
        stmt("rf2", f"delete from lineitem where l_orderkey in ({in_list})",
             int(per_batch[lo // RF_BATCH]), "delete lineitem")
        stmt("rf2", f"delete from orders where o_orderkey in ({in_list})", len(batch),
             "delete orders")
    note_shadows()
    stmt("rf2", "commit")
    oracle_delete(ora, old)
    for name in ("lineitem", "orders"):
        assert cat.table("tpch", name).nrows == len(next(iter(ora[name].values())))
    step_done("rf2", t0)
    t0 = time.perf_counter()
    unwritten("rf2")
    queries("rf2", ["q1", "q6", "q3", "q18"])
    step_done("after_rf2", t0)
    sess._try_columnar_update = columnar

    # --- 6. over the wire ---
    t0 = time.perf_counter()
    srv = Server(cat, port=0)
    srv.start_background()
    try:
        c = MysqlWire(srv.port, db="tpch")
        c.write("create table rf_wire (id bigint primary key auto_increment, v bigint)")
        wire = {"insert": c.write("insert into rf_wire (v) values (10), (20), (30)")}
        assert wire["insert"][:2] == (3, 1), wire
        wire["update"] = c.write("update rf_wire set v = v + 1 where id >= 2")
        assert wire["update"][0] == 2, wire
        wire["delete"] = c.write("delete from rf_wire where id = 3")
        assert wire["delete"][0] == 1, wire
        assert c.query("select id, v from rf_wire order by id")[1] == [(1, 10), (2, 21)]
        # two transactions on one table: the second waits for the first
        c2 = MysqlWire(srv.port, db="tpch")
        c.write("begin")
        c.write("update rf_wire set v = v + 100 where id = 1")
        done, errors = [], []

        def second():
            try:
                t1 = time.perf_counter()
                c2.write("begin")
                c2.write("update rf_wire set v = v + 5 where id = 1")
                c2.write("commit")
                done.append(time.perf_counter() - t1)
            except BaseException as e:  # raised below, after the join
                errors.append(e)

        th = threading.Thread(target=second)
        th.start()
        time.sleep(1.0)
        assert not done and not errors, (done, errors)
        c.write("commit")
        th.join(timeout=30)
        assert not errors and done, (done, errors)
        assert done[0] < 10, f"the waiting writer took {done[0]:.1f} s"
        assert c.query("select v from rf_wire where id = 1")[1] == [(115,)]
        wire["second_writer_s"] = done[0]
        c.write("drop table rf_wire")
        c.close()
        c2.close()
    finally:
        srv.shutdown()
    out["wire"] = wire
    log("refresh wire: " + json.dumps(wire))
    step_done("wire", t0)

    # --- the cache: one version per table, no shadow's columns ---
    live = {cat.table("tpch", n).uid: cat.table("tpch", n) for n in cat.tables("tpch")}
    versions = scan.cached_versions()
    assert not shadows & set(versions), "a transaction's shadow left columns in the cache"
    for uid, vs in versions.items():
        assert len(vs) == 1, f"table uid {uid} has cached versions {vs}"
        if uid in live:
            assert vs == {live[uid].version}, (live[uid].name, vs, live[uid].version)
    out["cache_tables"] = sorted(live[u].name for u in versions if u in live)
    out["cache_other_uids"] = sorted(u for u in versions if u not in live)
    out["seconds"] = time.perf_counter() - phase_t0
    out["launches"] = dict(K.LAUNCHES)
    log(f"refresh: {out['seconds']:.1f}s, launches {out['launches']}, cached tables "
        f"{out['cache_tables']}, other cached uids {out['cache_other_uids']}")
    for step, rows in out["statements"].items():
        log(f"refresh statements {step}: " + json.dumps(rows))
    return dict(K.LAUNCHES)


#: the operator phase's time limit (seconds), oracles included
OPERATOR_LIMIT_S = 150.0

#: O3-O5's Q18 streams lineitem in about this many chunks (STREAM_ROWS)
OPERATOR_CHUNKS = 8
#: the password O2's user logs in with
ANALYST_PASSWORD = "op-pass-13"
#: the columns the operator phase's oracles read (Q1, Q6 and Q18)
OPERATOR_COLUMNS = {
    "lineitem": ["l_orderkey", "l_quantity", "l_extendedprice", "l_discount", "l_tax",
                 "l_returnflag", "l_linestatus", "l_shipdate"],
    "orders": ["o_orderkey", "o_custkey", "o_orderdate", "o_totalprice"],
    "customer": ["c_custkey"],
}


def capture_arrays(cat, columns, db: str = "tpch") -> dict:
    """{table: {column: array}} of the tables' current rows, every block
    in order (strings as codes of the table's dictionary)."""
    return {name: {c: np.concatenate([b.columns[c].data for b in cat.table(db, name).blocks()])
                   for c in cols} for name, cols in columns.items()}


def tpch_schema(name: str):
    """A TPC-H table's schema as bench/tpch.py generates it (a tiny
    draw of the same generator)."""
    from tidb_tpu_torch.bench import tpch as G
    from tidb_tpu_torch.storage import Catalog

    c = Catalog()
    G.load_tpch(c, sf=0.001, seed=0, tables=[name])
    return c.table("tpch", name).schema


def operator_phase(cat, sess, report) -> dict:
    """The operator phase over the SF10 tables: what a MySQL client and
    its operator send around the queries. O1 schema discovery over the
    wire (information_schema, SHOW); O2 a read-only user and its grants;
    O3 a binding that streams Q18; O4 max_execution_time and its hint;
    O5 KILL from another connection; O6 stale reads around RF1's inserts;
    O7 SHOW WARNINGS, DO, FLUSH, OPTIMIZE TABLE, SHOW STATUS and USE
    information_schema. Every statement is checked on every run. Returns
    the phase's kernel launches."""
    import torch

    from tidb_tpu_torch.bench import oracles as O
    from tidb_tpu_torch.chunk import TRANSFERS
    from tidb_tpu_torch.executor import kernels as K
    from tidb_tpu_torch.server import Server
    from tidb_tpu_torch.storage.table import set_gc_life
    from tidb_tpu_torch.utils import collate
    from tidb_tpu_torch.utils.sqlkiller import QueryKilled

    out = report["operator"] = {}
    t_phase = time.perf_counter()
    log(f"operator: card {card_line()}")
    K.reset_launches()
    li_t = cat.table("tpch", "lineitem")
    t0 = time.perf_counter()
    ora = capture_arrays(cat, OPERATOR_COLUMNS)
    ocat = oracle_catalog(cat, ora)
    blk = ora["lineitem"]
    o_q1 = O.numpy_q1(blk)
    q18 = O.TPCH_QUERIES["q18"]
    q18_params = O.spec_params("q18", SF)
    q18_sql = q18.sql.format(**q18_params)
    check_q18 = oracle_check(ocat, q18, q18_params)
    log(f"operator: oracle arrays and Q1 in {time.perf_counter() - t0:.1f}s")

    def timed(fn):
        """(fn's result, its seconds up to the card's completion)"""
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t1

    srv = Server(cat, port=0)
    srv.start_background()
    conns = []
    try:
        # --- O1: schema discovery over the wire ---
        t0 = time.perf_counter()
        c = MysqlWire(srv.port, db="tpch")
        conns.append(c)
        names = cat.tables("tpch")
        _cols, rows, _s = c.query("select table_name, table_rows from information_schema.tables "
                                  "where table_schema = 'tpch' order by table_name")
        want = [(n, cat.table("tpch", n).nrows) for n in names]
        assert rows == want and len(rows) == 8, (rows, want)
        li_schema = tpch_schema("lineitem")
        _cols, rows, _s = c.query(
            "select column_name, ordinal_position, data_type from information_schema.columns "
            "where table_schema = 'tpch' and table_name = 'lineitem' order by ordinal_position")
        want = [(n, i, repr(t).lower()) for i, (n, t) in enumerate(li_schema.columns, 1)]
        # bench/tpch.py generates lineitem's 15 columns without l_comment
        assert rows == want and len(rows) == 15, (rows, want)
        _cols, rows, _s = c.query("show columns from lineitem")
        assert [r[:4] for r in rows] == [(n, ty, "YES", "") for n, _i, ty in want], rows
        _cols, rows, _s = c.query("show create table orders")
        o_schema = tpch_schema("orders")
        ddl = rows[0][1]
        assert rows[0][0] == "orders" and "primary key (o_orderkey)" in ddl, rows
        assert [ln.split("`")[1] for ln in ddl.splitlines()[1:] if "`" in ln] == o_schema.names, ddl
        _cols, rows, _s = c.query("show table status like 'lineitem'")
        assert len(rows) == 1 and rows[0][0] == "lineitem" and int(rows[0][4]) == li_t.nrows, rows
        _cols, rows, _s = c.query("show collation like 'utf8mb4%'")
        assert [r[0] for r in rows] == sorted(n for n in collate._REGISTRY if n.startswith("utf8mb4"))
        _cols, rows, _s = c.query("show charset")
        assert [r[0] for r in rows] == sorted(collate.CHARSET_DEFAULTS), rows
        _cols, rows, _s = c.query("show engines")
        assert [r[:2] for r in rows] == [("InnoDB", "DEFAULT")], rows
        c.write("create table op_scratch (id bigint primary key, k bigint, v varchar(16))")
        c.write("insert into op_scratch values (1, 10, 'a'), (2, 20, 'b')")
        _cols, rows, _s = c.query("show index from op_scratch")
        assert rows == [("op_scratch", "primary", "1", "id", "0")], rows
        _cols, rows, _s = c.query("select * from information_schema.statistics "
                                  "where table_name = 'op_scratch'")
        assert rows == [("tpch", "op_scratch", "primary", 1, "id", 0)], rows
        _cols, rows, _s = c.query("select * from information_schema.key_column_usage "
                                  "where table_schema = 'tpch' order by table_name")
        assert ("PRIMARY", "tpch", "op_scratch", "id", 1, None, None, None) in rows, rows
        assert [r[2] for r in rows] == sorted(["customer", "nation", "op_scratch", "orders", "part",
                                               "region", "supplier"]), rows
        out["o1_s"] = time.perf_counter() - t0
        log(f"operator O1: schema discovery over the wire in {out['o1_s']:.2f}s "
            f"({len(names)} tables, lineitem {li_t.nrows} rows)")

        # --- O2: a read-only user over the wire ---
        t0 = time.perf_counter()
        c.write(f"create user analyst identified by '{ANALYST_PASSWORD}'")
        c.write("grant select on tpch.* to analyst")
        a = MysqlWire(srv.port, db="tpch", user="analyst", password=ANALYST_PASSWORD)
        conns.append(a)
        _cols, rows, q6_s = a.query(O.Q6_SQL)
        check_q6(types.SimpleNamespace(rows=rows), blk)
        _cols, rows, q1_s = a.query(O.Q1_SQL)
        check_q1(types.SimpleNamespace(rows=rows), o_q1, li_t)
        try:
            a.write("insert into region values (9, 'OPS', 'denied')")
            raise AssertionError("analyst's INSERT was not refused")
        except WireError as e:
            assert e.message == "INSERT command denied to user 'analyst' for table tpch.region", e
        _cols, rows, _s = c.query("show grants for analyst")
        assert rows == [("GRANT SELECT ON tpch.* TO 'analyst'@'%'",)], rows
        c.write("revoke select on tpch.* from analyst")
        try:
            a.query(O.Q6_SQL)
            raise AssertionError("Q6 ran after REVOKE")
        except WireError as e:
            assert e.message.startswith("SELECT command denied to user 'analyst'"), e
        c.write("drop user analyst")
        try:
            MysqlWire(srv.port, db="tpch", user="analyst", password=ANALYST_PASSWORD)
            raise AssertionError("a dropped user logged in")
        except WireError as e:
            assert e.errno == 1045, e
        out["o2"] = {"s": time.perf_counter() - t0, "q6_wire_s": q6_s, "q1_wire_s": q1_s}
        log("operator O2: user, grants, refusals: " + json.dumps(out["o2"]))

        # --- O3: a binding streams Q18 ---
        t0 = time.perf_counter()
        stream_rows = -(-li_t.nrows // OPERATOR_CHUNKS)
        hinted = q18_sql.replace("select ", f"select /*+ STREAM_ROWS({stream_rows}) */ ", 1)
        sess.execute(f"create binding for {q18_sql} using {hinted}")
        assert len(sess.execute("show bindings").rows) == 1
        checks = sess.killer.check
        stamps = []

        def stamped():
            stamps.append(time.perf_counter())
            checks()

        sess.executor.kill_check = stamped
        runs, gaps, chunk_s = [], [], []
        try:
            for i in range(4):
                stamps.clear()
                res, secs = timed(lambda: sess.execute(q18_sql))
                end = time.perf_counter()
                check_q18(res)
                log_ = sess.executor.stream_log
                assert log_ and all(r["path"] == "streamed" and r["chunks"] > 1 for r in log_), log_
                runs.append(secs)
                gaps.append(max(np.diff(stamps + [end])))
                if i:  # the warm runs' chunks
                    chunk_s.extend(s for r in log_ for s in r["chunk_s"])
        finally:
            sess.executor.kill_check = checks
        slowest = max(chunk_s)
        out["o3"] = {"stream_rows": stream_rows, "chunks": [r["chunks"] for r in log_],
                     "cold_s": runs[0], "warm_s": runs[1:], "slowest_chunk_s": slowest,
                     "longest_gap_between_safepoints_s": max(gaps[1:]),
                     "safepoints": len(stamps)}
        sess.execute(f"drop binding for {q18_sql}")
        assert sess.execute("show bindings").rows == []
        res = sess.execute(q18_sql)
        check_q18(res)
        assert sess.executor.stream_log == [], sess.executor.stream_log
        out["o3"]["s"] = time.perf_counter() - t0
        log("operator O3: binding, Q18 streamed: " + json.dumps(out["o3"]))

        # --- O4: max_execution_time and its hint ---
        t0 = time.perf_counter()
        warm = float(np.median(runs[1:]))
        m_ms = max(int(warm / 3 * 1000), 1)
        bound = m_ms / 1000 + slowest + 0.5
        o4 = out["o4"] = {"limit_ms": m_ms, "bound_s": bound}
        for how, sql in (("variable", hinted),
                         ("hint", hinted.replace("*/", f"MAX_EXECUTION_TIME({m_ms}) */", 1))):
            torch.cuda.synchronize()
            m0 = torch.cuda.memory_allocated()
            if how == "variable":
                sess.execute(f"set max_execution_time = {m_ms}")
            t1 = time.perf_counter()
            try:
                sess.execute(sql)
                raise AssertionError(f"Q18 ran past max_execution_time ({how})")
            except QueryKilled as e:
                took = time.perf_counter() - t1
                assert str(e) == "query interrupted (max_execution_time exceeded)", e
            sess.execute("set max_execution_time = 0")
            assert took <= bound, (how, took, bound)
            res = sess.execute(hinted)
            check_q18(res)
            torch.cuda.synchronize()
            m1 = torch.cuda.memory_allocated()
            assert abs(m1 - m0) <= 0.01 * m0, (how, m0, m1)
            o4[how] = {"to_error_s": took, "memory_before": m0, "memory_after_rerun": m1}
        o4["s"] = time.perf_counter() - t0
        log("operator O4: max_execution_time: " + json.dumps(o4))

        # --- O5: KILL from another connection ---
        t0 = time.perf_counter()
        a = MysqlWire(srv.port, db="tpch")
        b = MysqlWire(srv.port, db="tpch")
        conns += [a, b]
        a_id = int(a.query("select connection_id()")[1][0][0])
        # A's stream plan warm first, as O3's runs were: a cold first
        # chunk discovers its capacities
        check_q18(types.SimpleNamespace(rows=a.query(hinted)[1]))
        got = {}

        def run_a():
            t1 = time.perf_counter()
            try:
                got["rows"] = a.query(hinted)[1]
            except WireError as e:
                got["error"] = e
            got["at"] = time.perf_counter()
            got["s"] = got["at"] - t1

        th = threading.Thread(target=run_a)
        th.start()
        try:
            listed = None
            deadline = time.perf_counter() + 60
            while listed is None and time.perf_counter() < deadline:
                rows = b.query("show processlist")[1]
                listed = next((r for r in rows if int(r[0]) == a_id and r[3] == "Query"
                               and str(r[5]).startswith("select /*+ STREAM_ROWS")), None)
                if listed is None:
                    time.sleep(0.01)
            assert listed is not None and th.is_alive(), "A's Q18 never showed in the processlist"
            # into A's chunks: half its warm time after B saw it
            time.sleep(warm / 2)
            assert th.is_alive(), "A's Q18 ended before B's KILL"
            t_kill = time.perf_counter()
            b.write(f"kill query {a_id}")
            kill_s = time.perf_counter() - t_kill
            assert th.is_alive(), "KILL returned only after A's statement had ended"
        finally:
            th.join(timeout=600)
        assert not th.is_alive()
        err = got.get("error")
        assert err is not None and err.message == "query interrupted (killed)", got
        after_kill = got["at"] - t_kill
        assert after_kill <= slowest + 0.5, (after_kill, slowest)
        rows = a.query(hinted)[1]
        check_q18(types.SimpleNamespace(rows=rows))
        b.write(f"kill connection {a_id}")
        try:
            a.query("select 1")
            raise AssertionError("a killed connection ran a statement")
        except WireError as e:
            assert e.message == f"connection {a_id} was killed", e
        out["o5"] = {"kill_returned_s": kill_s, "a_ran_s": got["s"], "error_after_kill_s": after_kill,
                     "bound_s": slowest + 0.5, "s": time.perf_counter() - t0}
        log("operator O5: KILL over the wire: " + json.dumps(out["o5"]))
    finally:
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass
        srv.shutdown()

    # --- O6: stale reads around RF1's inserts ---
    t0 = time.perf_counter()
    sess.execute("set global tidb_gc_life_time = 600")
    time.sleep(1.0)
    ts0 = time.time()
    time.sleep(1.0)
    rf1 = rf1_data(cat, np.random.default_rng(13), SF, RF_ORDERS, 0)
    t1 = time.perf_counter()
    sess.execute("begin")
    new_o, new_li = rf1["orders"], rf1["lineitem"]
    for lo in range(0, RF_ORDERS, RF_BATCH):
        sess.execute(insert_sql("orders", ORDERS_KINDS, new_o, lo, min(lo + RF_BATCH, RF_ORDERS)))
    n_new = len(new_li["l_orderkey"])
    for lo in range(0, n_new, RF_BATCH):
        sess.execute(insert_sql("lineitem", LINEITEM_KINDS, new_li, lo, min(lo + RF_BATCH, n_new)))
    sess.execute("commit")
    insert_s = time.perf_counter() - t1
    after = {n: dict(cols) for n, cols in ora.items()}
    oracle_append(after, cat, rf1)
    o_q1_after = O.numpy_q1(after["lineitem"])
    o_q6, o_q6_after = O.numpy_q6(blk), O.numpy_q6(after["lineitem"])
    stale = {"q1": lambda r: check_q1(r, o_q1, li_t), "q6": lambda r: _check_q6_value(r, o_q6)}
    fresh = {"q1": lambda r: check_q1(r, o_q1_after, li_t),
             "q6": lambda r: _check_q6_value(r, o_q6_after)}
    sqls = {"q1": O.Q1_SQL, "q6": O.Q6_SQL}
    o6 = out["o6"] = {"insert_s": insert_s, "rows_inserted": n_new + RF_ORDERS, "runs": []}

    def read(label, sql, check):
        h0 = TRANSFERS["h2d_bytes"]
        res, secs = timed(lambda: sess.execute(sql))
        check(res)
        o6["runs"].append([label, secs, TRANSFERS["h2d_bytes"] - h0])

    as_of = f"from lineitem as of timestamp '{ts0}'"
    for name in ("q1", "q6"):
        read(f"{name} as of", sqls[name].replace("from lineitem", as_of), stale[name])
    sess.execute(f"set tidb_snapshot = '{ts0}'")
    for name in ("q1", "q6"):
        read(f"{name} tidb_snapshot", sqls[name], stale[name])
    try:
        sess.execute("insert into region values (9, 'OPS', 'refused')")
        raise AssertionError("a write ran under tidb_snapshot")
    except ValueError as e:
        assert str(e) == "can not execute write statement when 'tidb_snapshot' is set", e
    sess.execute("set tidb_snapshot = ''")
    read("q1 current", sqls["q1"], fresh["q1"])
    read("q1 current, warm", sqls["q1"], fresh["q1"])
    back = int(time.time() - ts0)
    sess.execute(f"set tidb_read_staleness = -{back}")
    read(f"q1 tidb_read_staleness -{back}", sqls["q1"], stale["q1"])
    sess.execute("set tidb_read_staleness = 0")
    read("q1 current again", sqls["q1"], fresh["q1"])
    sess.execute("set global tidb_gc_life_time = 0")
    set_gc_life(0)
    o6["s"] = time.perf_counter() - t0
    log("operator O6: stale reads (label, s, h2d bytes): " + json.dumps(o6))

    # --- O7: the rest ---
    t0 = time.perf_counter()
    sess.execute("insert ignore into op_scratch values (null, 30, 'c')")
    assert sess.execute("show warnings").rows == [("Warning", 1048, "Column 'id' cannot be null")]
    sess.execute("do 1 + 1")
    sess.execute("flush tables")
    res, opt_s = timed(lambda: sess.execute("optimize table orders"))
    assert res.rows[-1] == ("tpch.orders", "optimize", "status", "OK"), res.rows
    (name, value), = sess.execute("show status like 'Threads_connected'").rows
    assert name == "Threads_connected" and int(value) >= 1, value
    sess.execute("use information_schema")
    got = [r[0] for r in sess.execute("select schema_name from schemata order by schema_name").rows]
    assert got == [d for d in cat.databases() if not d.startswith("_")], got
    sess.execute("use tpch")
    sess.execute("drop table op_scratch")
    out["o7"] = {"optimize_orders_s": opt_s, "threads_connected": int(value),
                 "s": time.perf_counter() - t0}
    log("operator O7: " + json.dumps(out["o7"]))

    launches = dict(K.LAUNCHES)
    out["seconds"] = time.perf_counter() - t_phase
    out["launches"] = launches
    log(f"operator: phase {out['seconds']:.1f}s of {OPERATOR_LIMIT_S:g}, launches {launches}")
    return launches


def operator_only(report) -> dict:
    """The SF10 tables, ANALYZEd, and the operator phase alone: the short
    loop for session and server work. Returns the phase's launches."""
    from tidb_tpu_torch.bench import load_tpch
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage import Catalog

    t0 = time.perf_counter()
    cat = Catalog()
    load_tpch(cat, sf=SF, seed=1, tables=TABLES)
    sess = Session(cat, db="tpch")
    for t in TABLES:
        sess.execute(f"analyze table {t}")
    log(f"datagen and analyze: SF{SF:g} in {time.perf_counter() - t0:.1f}s")
    launches = operator_phase(cat, sess, report)
    for k, n in launches.items():
        assert n > 0, f"kernel {k} was not launched in the operator phase"
    return launches


def refresh_only(report) -> dict:
    """The SF10 tables, ANALYZEd, and the refresh phase alone: the short
    loop for write-path work. Returns the phase's launches."""
    from tidb_tpu_torch.bench import load_tpch
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage import Catalog

    t0 = time.perf_counter()
    cat = Catalog()
    load_tpch(cat, sf=SF, seed=1, tables=TABLES)
    sess = Session(cat, db="tpch")
    for t in TABLES:
        sess.execute(f"analyze table {t}")
    log(f"datagen and analyze: SF{SF:g} in {time.perf_counter() - t0:.1f}s")
    launches = refresh_phase(cat, sess, report)
    for k, n in launches.items():
        assert n > 0, f"kernel {k} was not launched in the refresh phase"
    return launches


#: the index phase's time limit (seconds), oracles included
INDEX_LIMIT_S = 120.0
#: I1's point gets: how many, and one in this many asks for an absent key
POINT_GETS = 200
POINT_ABSENT_EVERY = 8
#: the columns the index phase's oracles read
INDEX_COLUMNS = {
    "orders": ["o_orderkey", "o_orderstatus", "o_totalprice", "o_orderdate",
               "o_orderpriority"],
    "lineitem": ["l_orderkey", "l_commitdate", "l_receiptdate", "l_shipdate",
                 "l_extendedprice"],
    "supplier": ["s_suppkey", "s_name", "s_address", "s_nationkey", "s_phone", "s_acctbal",
                 "s_comment"],
    "nation": ["n_nationkey", "n_regionkey"],
    "region": ["r_regionkey", "r_name"],
    "partsupp": ["ps_partkey", "ps_suppkey", "ps_supplycost"],
}
#: I4's upsert ETL: daily revenue by ship date over two overlapping windows
DAILY_REV_SQL = (
    "insert into {table} select l_shipdate, sum(l_extendedprice), count(*) from lineitem "
    "where l_shipdate >= '{d0}' and l_shipdate < '{d1}' group by l_shipdate{odku}")
DAILY_REV_ODKU = " on duplicate key update rev = rev + values(rev), n = n + values(n)"
I4_WINDOWS = (("1992-01-01", "1995-01-01"), ("1994-07-01", "1995-07-01"),
              ("1995-07-01", "1996-01-01"))


def index_phase(cat, sess, report) -> dict:
    """The index phase over the SF10 tables: the access paths that read
    indexes and the writes that keep them. I1 point gets by primary key
    (EXECUTE of a prepared statement per seeded key, some absent); I2 a
    secondary index on o_orderdate and a one-week range; I3 an OR of a
    key range and a date (IndexMerge), then TPC-H Q4 over the index; I4
    an upsert ETL (INSERT ... SELECT ... ON DUPLICATE KEY UPDATE over two
    overlapping windows); I5 a UNIQUE index and REPLACE; I6 multi-table
    UPDATE and DELETE; I7 ALTER TABLE, a failing multi-spec ALTER that
    rolls back, RENAME TABLE and DROP INDEX. Every step is checked
    against a numpy oracle over the tables' arrays, and prints its
    seconds and host->device bytes. Returns the phase's kernel launches."""
    import torch

    from tidb_tpu_torch.bench import oracles as O
    from tidb_tpu_torch.chunk import TRANSFERS
    from tidb_tpu_torch.dtypes import date_to_days
    from tidb_tpu_torch.executor import kernels as K
    from tidb_tpu_torch.planner import physical as P
    from tidb_tpu_torch.planner.physical import NARROWED
    from tidb_tpu_torch.storage.table import INDEX_SORTS

    out = report["indexes"] = {}
    share = P.NARROW_SHARE_CACHED
    t_phase = time.perf_counter()
    log(f"indexes: card {card_line()}")
    K.reset_launches()
    t0 = time.perf_counter()
    ora = capture_arrays(cat, INDEX_COLUMNS)
    dicts = {(n, c): cat.table("tpch", n).dictionaries.get(c)
             for n, cols in INDEX_COLUMNS.items() for c in cols}
    log(f"indexes: oracle arrays in {time.perf_counter() - t0:.1f}s")
    orders_t = cat.table("tpch", "orders")

    def step(name, fn):
        """Run fn, recording under `name` its seconds (to the card's
        completion), the seconds of its statements alone (``stmt_s``:
        the rest is its numpy oracles), host->device bytes, narrowed
        reads (rows, host seconds of search and gather, ranges read by a
        full scan instead), the index sorts it paid for and the
        interpreter's full garbage collections."""
        stmt = {"s": 0.0, "depth": 0}

        def timed(f):
            def run(*a, **kw):
                stmt["depth"] += 1
                t2 = time.perf_counter()
                try:
                    return f(*a, **kw)
                finally:
                    torch.cuda.synchronize()
                    stmt["depth"] -= 1
                    if not stmt["depth"]:
                        stmt["s"] += time.perf_counter() - t2
            return run

        torch.cuda.synchronize()
        h0, t1 = TRANSFERS["h2d_bytes"], time.perf_counter()
        n0, s0 = dict(NARROWED), dict(INDEX_SORTS)
        g0 = gc.get_stats()[2]["collections"]
        sess.execute, sess.execute_prepared = timed(sess.execute), timed(sess.execute_prepared)
        try:
            extra = fn() or {}
        finally:
            del sess.execute, sess.execute_prepared
        torch.cuda.synchronize()
        out[name] = {"s": time.perf_counter() - t1, "stmt_s": stmt["s"],
                     "h2d_bytes": TRANSFERS["h2d_bytes"] - h0,
                     "narrowed": {k: NARROWED[k] - n0[k] for k in NARROWED},
                     "index_sorts": {k: INDEX_SORTS[k] - s0[k] for k in INDEX_SORTS},
                     "gen2_collections": gc.get_stats()[2]["collections"] - g0, **extra}
        log(f"indexes {name}: " + json.dumps(out[name]))

    def explain(sql):
        return "\n".join(r[0] for r in sess.execute("explain " + sql).rows)

    def dec(name, col, codes):
        d = dicts[(name, col)]
        return [str(d[c]) for c in codes]

    # --- I1: point gets by primary key ---
    ok_, ostat, oprice, odate = (ora["orders"][c] for c in (
        "o_orderkey", "o_orderstatus", "o_totalprice", "o_orderdate"))
    order = np.argsort(ok_, kind="stable")
    ok_sorted = ok_[order]
    rng = np.random.default_rng(14)
    keys = ok_[rng.integers(0, len(ok_), POINT_GETS)].copy()
    absent = np.arange(POINT_GETS) % POINT_ABSENT_EVERY == 0
    keys[absent] = int(ok_.max()) + 1 + np.arange(int(absent.sum()))
    sql = "select o_orderstatus, o_totalprice, o_orderdate from orders where o_orderkey = ?"
    sess.prepare("pk_get", sql)

    def i1():
        per_run, first = [], None
        for i, k in enumerate(keys.tolist()):
            h0, t1 = TRANSFERS["h2d_bytes"], time.perf_counter()
            res = sess.execute_prepared("pk_get", [k])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t1
            if first is None:
                first = dt
            per_run.append((dt, TRANSFERS["h2d_bytes"] - h0))
            p = np.searchsorted(ok_sorted, k)
            want = []
            if p < len(order) and ok_sorted[p] == k:
                j = order[p]
                want = [(dec("orders", "o_orderstatus", [ostat[j]])[0], int(oprice[j]) / 100,
                         present_date(int(odate[j])))]
            O.check_rows(res.rows, want)
            if i % 20 == 0:
                plan = explain(sql.replace("?", str(k)))
                assert f"access=IndexRangeScan(o_orderkey in [{k}, {k}])" in plan, plan
        secs = sorted(d for d, _b in per_run)
        h2d = max(b for _d, b in per_run[1:])
        assert h2d <= 16 << 10, f"a warm point get copied {h2d} B host->device"
        return {"gets": len(keys), "absent": int(absent.sum()), "first_s": first,
                "median_ms": secs[len(secs) // 2] * 1e3, "max_ms": secs[-1] * 1e3,
                "max_h2d_bytes_warm": h2d, "orders_rows": orders_t.nrows}

    step("i1_point_gets", i1)

    # --- I2: a secondary index and a one-week range ---
    d0, d1 = "1995-03-01", "1995-03-07"
    range_sql = ("select count(*), sum(o_totalprice) from orders "
                 f"where o_orderdate between '{d0}' and '{d1}'")

    def i2():
        t1 = time.perf_counter()
        sess.execute("create index idx_odate on orders (o_orderdate)")
        create_s = time.perf_counter() - t1
        plan = explain(range_sql)
        lo, hi = int(date_to_days(d0)), int(date_to_days(d1))
        assert f"access=IndexRangeScan(o_orderdate in [{lo}, {hi}])" in plan, plan
        m = (odate >= lo) & (odate <= hi)
        want = [(int(m.sum()), int(oprice[m].sum()) / 100)]
        l0 = K.LAUNCHES["slot_sums"]
        runs = []
        for _ in range(3):
            t1, g1 = time.perf_counter(), NARROWED["seconds"]
            res = sess.execute(range_sql)
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t1, NARROWED["seconds"] - g1))
            O.check_rows(res.rows, want)
        assert K.LAUNCHES["slot_sums"] > l0, "the range's scalar aggregate launched no slot_sums"
        rows = sess.execute("select index_name, seq_in_index, column_name, non_unique from "
                            "information_schema.statistics where table_schema = 'tpch' "
                            "and table_name = 'orders' order by index_name").rows
        assert rows == [("idx_odate", 1, "o_orderdate", 1), ("primary", 1, "o_orderkey", 0)], rows
        rows = sess.execute("show index from orders").rows
        assert ("orders", "idx_odate", 1, "o_orderdate", 1) in rows, rows
        return {"create_index_s": create_s, "rows_in_range": int(m.sum()),
                "runs_s_gather_s": runs}

    step("i2_range", i2)

    # --- I3: IndexMerge, then Q4 over the index ---
    k_lo, k_hi = int(ok_[order[1000]]), int(ok_[order[1999]])
    merge_sql = ("select count(*), sum(o_totalprice) from orders "
                 f"where o_orderkey between {k_lo} and {k_hi} or o_orderdate = '1996-01-01'")
    q4 = O.TPCH_QUERIES["q4"]
    q4_params = O.spec_params("q4", SF)
    q4_sql = q4.sql.format(**q4_params)

    def i3():
        plan = explain(merge_sql)
        dd = int(date_to_days("1996-01-01"))
        assert (f"access=IndexMerge(union: o_orderkey[{k_lo},{k_hi}] | "
                f"o_orderdate[{dd},{dd}])") in plan, plan
        m = ((ok_ >= k_lo) & (ok_ <= k_hi)) | (odate == dd)
        O.check_rows(sess.execute(merge_sql).rows, [(int(m.sum()), int(oprice[m].sum()) / 100)])
        plan = explain(q4_sql)
        lo = int(date_to_days("1993-07-01"))
        hi = int(date_to_days("1993-10-01")) - 1
        assert f"access=IndexRangeScan(o_orderdate in [{lo}, {hi}])" in plan, plan
        ocat = oracle_catalog(cat, {
            "orders": {c: ora["orders"][c] for c in ("o_orderkey", "o_orderdate",
                                                     "o_orderpriority")},
            "lineitem": {c: ora["lineitem"][c] for c in ("l_orderkey", "l_commitdate",
                                                         "l_receiptdate")}})
        check = oracle_check(ocat, q4, q4_params)
        # each read both ways: the default rule (a range past a 64th of
        # orders whose columns are cached reads the cached full scan) and
        # the range forced narrowed
        wide_sql = ("select count(*), sum(o_totalprice) from orders "
                    f"where o_orderkey between 1 and {int(ok_.max())}")
        wide_want = [(len(ok_), int(oprice.sum()) / 100)]
        warm = sess.execute("select count(o_orderkey), count(o_orderdate), "
                            "count(o_orderpriority), count(o_totalprice) from orders").rows
        assert warm == [(len(ok_),) * 4], warm

        def runs(sql, checked):
            got = []
            for _ in range(3):
                h0, t1, d0 = TRANSFERS["h2d_bytes"], time.perf_counter(), NARROWED["declined"]
                checked(sess.execute(sql))
                torch.cuda.synchronize()
                got.append((time.perf_counter() - t1, TRANSFERS["h2d_bytes"] - h0,
                            NARROWED["declined"] - d0))
            return got

        both = {}
        for way in ("cached_full_scan", "forced_narrowed"):
            if way == "forced_narrowed":
                P.NARROW_SHARE_CACHED = 1.0
            try:
                both[way] = {
                    "q4_s_h2d_declined": runs(q4_sql, check),
                    "wide_pk_s_h2d_declined": runs(
                        wide_sql, lambda r: O.check_rows(r.rows, wide_want))}
            finally:
                P.NARROW_SHARE_CACHED = share
        assert all(d == 1 for _s, _h, d in both["cached_full_scan"]["q4_s_h2d_declined"])
        assert all(d == 0 for _s, _h, d in both["forced_narrowed"]["q4_s_h2d_declined"])
        narrowed = int(((odate >= lo) & (odate <= hi)).sum())
        return {"merge_rows": int(m.sum()), "q4_orders_rows": narrowed, **both}

    step("i3_merge_q4", i3)

    # --- I4: the upsert ETL ---
    ship, price = ora["lineitem"]["l_shipdate"], ora["lineitem"]["l_extendedprice"]

    def daily(w):
        lo, hi = int(date_to_days(w[0])), int(date_to_days(w[1]))
        m = (ship >= lo) & (ship < hi)
        # by day offset: a count over the window's days, not a sort of
        # its ~28M rows
        off = ship[m].astype(np.int64) - lo
        n = np.bincount(off, minlength=hi - lo)
        cents = np.bincount(off, price[m], hi - lo)
        days = np.flatnonzero(n)
        return dict(zip((days + lo).tolist(), zip(n[days].tolist(), cents[days].tolist())))

    def i4():
        sess.execute("create table daily_rev (d date primary key, rev decimal(18,2), n bigint)")
        want: dict = {}
        affected = []
        p0 = K.LAUNCHES["prefix_sum"]
        for w in I4_WINDOWS[:2]:
            add = daily(w)
            expect = sum(2 if d in want else 1 for d in add)
            for d, (n, cents) in add.items():
                pn, pc = want.get(d, (0, 0))
                want[d] = (pn + n, pc + cents)
            res = sess.execute(DAILY_REV_SQL.format(table="daily_rev", d0=w[0], d1=w[1],
                                                    odku=DAILY_REV_ODKU))
            assert res.affected == expect, (res.affected, expect)
            affected.append(res.affected)
        assert K.LAUNCHES["prefix_sum"] > p0, "the dense GROUP BY launched no prefix_sum"
        O.check_rows(sess.execute("select d, rev, n from daily_rev").rows,
                     [(present_date(d), c / 100, int(n)) for d, (n, c) in want.items()])
        return {"affected": affected, "days": len(want)}

    step("i4_upsert", i4)

    # --- I5: a UNIQUE index and REPLACE ---
    sup = ora["supplier"]
    names = [n for n in INDEX_COLUMNS["supplier"]]

    def sup_rows(mask, bump=0):
        cols = []
        for c in names:
            v = sup[c][mask]
            if (("supplier", c) in dicts) and dicts[("supplier", c)] is not None:
                cols.append(dec("supplier", c, v))
            elif c == "s_acctbal":
                cols.append([(int(x) + bump) / 100 for x in v])
            else:
                cols.append([int(x) for x in v])
        return list(zip(*cols))

    def i5():
        sess.execute("create table supplier_dim like supplier")
        res = sess.execute("insert into supplier_dim select * from supplier where s_nationkey = 7")
        base = sup["s_nationkey"] == 7
        assert res.affected == int(base.sum()), res.affected
        sess.execute("create unique index ux_name on supplier_dim (s_name)")
        cols = ", ".join(c if c != "s_acctbal" else "s_acctbal + 1" for c in names)
        res = sess.execute(f"replace into supplier_dim select {cols} from supplier "
                           "where s_nationkey in (7, 8) and s_suppkey % 2 = 0")
        even = sup["s_suppkey"] % 2 == 0
        incoming = np.isin(sup["s_nationkey"], [7, 8]) & even
        assert res.affected == int(incoming.sum()), (res.affected, int(incoming.sum()))
        O.check_rows(sess.execute("select * from supplier_dim").rows,
                     sup_rows(base & ~even) + sup_rows(incoming, bump=100))
        try:
            sess.execute("create unique index ux_nation on supplier_dim (s_nationkey)")
            raise AssertionError("a UNIQUE index over duplicates was created")
        except ValueError as e:
            assert str(e) == ("cannot create unique index ux_nation: duplicate entries in "
                              "columns (s_nationkey)"), e
        assert sorted(cat.table("tpch", "supplier_dim").indexes) == ["ux_name"]
        return {"rows": int((base & ~even).sum() + incoming.sum()),
                "replaced": int((base & even).sum()), "incoming": int(incoming.sum())}

    step("i5_unique_replace", i5)

    # --- I6: multi-table UPDATE and DELETE ---
    def i6():
        reg = ora["region"]["r_regionkey"][
            np.array(dec("region", "r_name", ora["region"]["r_name"])) == "EUROPE"]
        nat = ora["nation"]["n_nationkey"][np.isin(ora["nation"]["n_regionkey"], reg)]
        hit = np.isin(sup["s_nationkey"], nat)
        res = sess.execute(
            "update supplier s join nation n on s.s_nationkey = n.n_nationkey "
            "join region r on n.n_regionkey = r.r_regionkey "
            "set s.s_acctbal = s.s_acctbal + 1 where r.r_name = 'EUROPE'")
        assert res.affected == int(hit.sum()), (res.affected, int(hit.sum()))
        want = sup["s_acctbal"] + np.where(hit, 100, 0)
        got = capture_arrays(cat, {"supplier": ["s_suppkey", "s_acctbal"]})["supplier"]
        assert np.array_equal(got["s_suppkey"], sup["s_suppkey"])
        assert np.array_equal(got["s_acctbal"], want), "supplier's acctbal after the UPDATE"
        comments = np.array(dec("supplier", "s_comment", sup["s_comment"]), dtype=object)
        bad = sup["s_suppkey"][np.array(["Customer" in c and "Complaints" in c.split(
            "Customer", 1)[1] for c in comments])]
        ps = ora["partsupp"]
        gone = np.isin(ps["ps_suppkey"], bad)
        res = sess.execute("delete ps from partsupp ps join supplier s on ps.ps_suppkey = "
                           "s.s_suppkey where s.s_comment like '%Customer%Complaints%'")
        assert res.affected == int(gone.sum()), (res.affected, int(gone.sum()))
        O.check_rows(sess.execute("select count(*), sum(ps_supplycost) from partsupp").rows,
                     [(int((~gone).sum()), int(ps["ps_supplycost"][~gone].sum()) / 100)])
        return {"updated": int(hit.sum()), "deleted": int(gone.sum()),
                "partsupp_rows": int((~gone).sum())}

    step("i6_multitable", i6)

    # --- I7: ALTER TABLE, a rolled-back ALTER, RENAME TABLE, DROP INDEX ---
    def i7():
        dim = cat.table("tpch", "supplier_dim")
        before = sess.execute("select * from supplier_dim").rows
        cents = capture_arrays(cat, {"supplier_dim": ["s_suppkey", "s_acctbal"]})["supplier_dim"]
        sess.execute("alter table supplier_dim add column tier int not null default 0, "
                     "modify column s_acctbal decimal(15,3)")
        assert dim.schema.names == names + ["tier"], dim.schema.names
        assert dim.schema.types["s_acctbal"].scale == 3, dim.schema.types["s_acctbal"]
        mills = capture_arrays(cat, {"supplier_dim": ["s_suppkey", "s_acctbal"]})["supplier_dim"]
        assert np.array_equal(mills["s_suppkey"], cents["s_suppkey"])
        assert np.array_equal(mills["s_acctbal"], cents["s_acctbal"] * 10), "s_acctbal's mills"
        O.check_rows(sess.execute("select * from supplier_dim").rows,
                     [tuple(r) + (0,) for r in before])
        try:
            sess.execute("alter table supplier_dim add column note varchar(8), "
                         "modify column s_name int")
            raise AssertionError("a failing ALTER succeeded")
        except ValueError as e:
            msg = str(e)
            assert (msg.startswith("Truncated incorrect int value: 'Supplier#")
                    and msg.endswith("' for column s_name")), msg
        assert dim.schema.names == names + ["tier"], dim.schema.names
        O.check_rows(sess.execute("select * from supplier_dim").rows,
                     [tuple(r) + (0,) for r in before])
        ddl = sess.execute("show create table supplier_dim").rows[0][1]
        assert ("`tier` bigint default 0" in ddl and "`s_acctbal` decimal(38,3)" in ddl
                and "unique index ux_name (s_name)" in ddl), ddl
        sess.execute("create table daily_rev_new like daily_rev")
        w = I4_WINDOWS[2]
        sess.execute(DAILY_REV_SQL.format(table="daily_rev_new", d0=w[0], d1=w[1], odku=""))
        old_rows = sess.execute("select * from daily_rev").rows
        sess.execute("rename table daily_rev to daily_rev_old, daily_rev_new to daily_rev")
        O.check_rows(sess.execute("select d, rev, n from daily_rev").rows,
                     [(present_date(d), c / 100, int(n)) for d, (n, c) in daily(w).items()])
        O.check_rows(sess.execute("select * from daily_rev_old").rows, old_rows)
        sess.execute("drop index idx_odate on orders")
        plan = explain(q4_sql)
        assert "IndexRangeScan(o_orderdate" not in plan and "idx_odate" not in plan, plan
        sess.execute("drop table daily_rev")
        sess.execute("drop table daily_rev_old")
        sess.execute("drop table supplier_dim")
        return {}

    step("i7_alter_rename", i7)

    launches = dict(K.LAUNCHES)
    out["seconds"] = time.perf_counter() - t_phase
    out["launches"] = launches
    log(f"indexes: phase {out['seconds']:.1f}s of {INDEX_LIMIT_S:g}, launches {launches}")
    assert out["seconds"] <= INDEX_LIMIT_S, out["seconds"]
    return launches


def indexes_only(report) -> dict:
    """The SF10 tables, ANALYZEd, and the index phase alone: the short
    loop for index and write-path work. Returns the phase's launches."""
    from tidb_tpu_torch.bench import load_tpch
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage import Catalog

    t0 = time.perf_counter()
    cat = Catalog()
    load_tpch(cat, sf=SF, seed=1, tables=TABLES)
    sess = Session(cat, db="tpch")
    for t in TABLES:
        sess.execute(f"analyze table {t}")
    log(f"datagen and analyze: SF{SF:g} in {time.perf_counter() - t0:.1f}s")
    launches = index_phase(cat, sess, report)
    for k, n in launches.items():
        assert n > 0, f"kernel {k} was not launched in the index phase"
    return launches


# ---------------------------------------------------------------------------
# the constraint phase: TPC-H's declared keys, FOREIGN KEYs and CHECKs
# ---------------------------------------------------------------------------

#: the constraint phase's time limit (seconds), oracles included
CONSTRAINT_LIMIT_S = 120.0
#: the database the constraint phase declares its tables in
CDB = "tpch_c"
#: TPC-H clause 1.4.2's single-column FOREIGN KEYs: (table, column,
#: parent, parent column, ON DELETE action)
TPCH_FKS = [
    ("lineitem", "l_orderkey", "orders", "o_orderkey", "cascade"),
    ("lineitem", "l_partkey", "part", "p_partkey", None),
    ("lineitem", "l_suppkey", "supplier", "s_suppkey", None),
    ("orders", "o_custkey", "customer", "c_custkey", "set null"),
    ("customer", "c_nationkey", "nation", "n_nationkey", None),
    ("supplier", "s_nationkey", "nation", "n_nationkey", None),
    ("partsupp", "ps_partkey", "part", "p_partkey", None),
    ("partsupp", "ps_suppkey", "supplier", "s_suppkey", None),
    ("nation", "n_regionkey", "region", "r_regionkey", None),
]
#: TPC-H clause 1.4.2.4's CHECKs, by table, as (name, expression)
TPCH_CHECKS = {
    "lineitem": [("l_qty_nonneg", "l_quantity >= 0"), ("l_price_nonneg", "l_extendedprice >= 0"),
                 ("l_tax_nonneg", "l_tax >= 0"),
                 ("l_discount_range", "l_discount between 0.00 and 1.00"),
                 ("l_ship_before_receipt", "l_shipdate <= l_receiptdate")],
    "orders": [("o_price_nonneg", "o_totalprice >= 0")],
    "partsupp": [("ps_qty_nonneg", "ps_availqty >= 0"), ("ps_cost_nonneg", "ps_supplycost >= 0")],
    "part": [("p_price_nonneg", "p_retailprice >= 0"), ("p_size_nonneg", "p_size >= 0")],
}
#: parents before children: the order CREATE TABLE needs
CONSTRAINT_TABLES = ["region", "nation", "part", "supplier", "customer", "orders", "partsupp",
                     "lineitem"]
#: C4's customers deleted (their orders' o_custkey goes NULL)
C4_CUSTOMERS = 100
#: C3's INSERT IGNORE: rows, and how many of them violate (half a CHECK,
#: half a FOREIGN KEY)
C3_IGNORE_ROWS = 1000
C3_IGNORE_BAD = 100


def _sql_type(typ) -> str:
    from tidb_tpu_torch.dtypes import Kind

    return {Kind.INT: "bigint", Kind.DATE: "date", Kind.FLOAT: "double",
            Kind.STRING: "varchar(199)"}.get(typ.kind, f"decimal(15,{typ.scale})")


def constraint_ddl(cat, name: str) -> str:
    """CREATE TABLE of `name` in the constraint phase's database: the
    tpch table's columns and types and primary key, its FOREIGN KEYs and
    CHECKs."""
    t = cat.table("tpch", name)
    parts = [f"{c} {_sql_type(ty)}" for c, ty in t.schema.columns]
    if t.schema.primary_key:
        parts.append("primary key (" + ", ".join(t.schema.primary_key) + ")")
    for tbl, col, parent, pcol, act in TPCH_FKS:
        if tbl == name:
            parts.append(f"constraint {col}_fk foreign key ({col}) references {parent} ({pcol})"
                         + (f" on delete {act}" if act else ""))
    for cname, expr in TPCH_CHECKS.get(name, ()):
        parts.append(f"constraint {cname} check ({expr})")
    return f"create table {CDB}.{name} (" + ", ".join(parts) + ")"


def member(values, keys):
    """np.isin for non-negative integer keys, by a lookup table over
    their range (np.isin sorts: seconds at 60M values)."""
    table = np.zeros(int(max(values.max(initial=0), keys.max(initial=0))) + 2, dtype=bool)
    table[keys] = True
    return table[values]


def spec_receiptdate(ship, receipt):
    """l_receiptdate by TPC-H clause 4.2.3's rule (l_shipdate + 1..30
    days), derived from the generator's own draw where that draw falls
    before the ship date: bench/tpch.py draws the two independently."""
    return np.where(receipt >= ship, receipt, ship + 1 + receipt % 30).astype(receipt.dtype)


def constraint_phase(cat, sess, report) -> dict:
    """The constraint phase over the SF10 tables. C1 declares TPC-H's
    keys, FOREIGN KEYs and CHECKs on copies of the eight tables that
    share their blocks (database tpch_c) and proves the data meets them;
    C2 runs RF1 under them (INSERT ... SELECT of the generator's rows);
    C3 has each kind of constraint refuse a write
    and leave the tables as they were, INSERT IGNORE keep the rows that
    pass, and a constrained UPDATE take the columnar path; C4 runs RF2 as
    one DELETE of orders that cascades to lineitem, then a customer
    DELETE that sets their orders' o_custkey NULL; C5 runs TPC-H Q15 as
    the spec writes it, over a view, on the tpch tables; C6 adds a stored
    generated column to supplier and writes through it. Every statement
    is checked against numpy; each step prints its seconds, its
    statements' seconds, host->device bytes and kernel launches. Returns
    the phase's launches."""
    import torch

    from tidb_tpu_torch.bench import oracles as O
    from tidb_tpu_torch.chunk import TRANSFERS, HostBlock, HostColumn
    from tidb_tpu_torch.dtypes import date_to_days
    from tidb_tpu_torch.executor import kernels as K
    from tidb_tpu_torch.storage import scan

    out = report["constraints"] = {}
    t_phase = time.perf_counter()
    log(f"constraints: card {card_line()}")
    K.reset_launches()

    def step(name, fn):
        """Run fn, recording under `name` its seconds, its statements'
        seconds alone (``stmt_s``: the rest is its numpy oracles),
        host->device bytes and kernel launches."""
        stmt = {"s": 0.0, "depth": 0}

        def timed(f):
            def run(*a, **kw):
                stmt["depth"] += 1
                t2 = time.perf_counter()
                try:
                    return f(*a, **kw)
                finally:
                    torch.cuda.synchronize()
                    stmt["depth"] -= 1
                    if not stmt["depth"]:
                        stmt["s"] += time.perf_counter() - t2
            return run

        torch.cuda.synchronize()
        h0, t1, l0 = TRANSFERS["h2d_bytes"], time.perf_counter(), dict(K.LAUNCHES)
        sess.execute = timed(sess.execute)
        try:
            extra = fn() or {}
        finally:
            del sess.execute
        torch.cuda.synchronize()
        out[name] = {"s": time.perf_counter() - t1, "stmt_s": stmt["s"],
                     "h2d_bytes": TRANSFERS["h2d_bytes"] - h0,
                     "launches": {k: K.LAUNCHES[k] - l0[k] for k in K.LAUNCHES}, **extra}
        log(f"constraints {name}: " + json.dumps(out[name]))

    def refused(sql, want):
        try:
            sess.execute(sql)
        except ValueError as e:
            assert str(e) == want, (sql[:80], str(e), want)
            return
        raise AssertionError(f"not refused: {sql[:80]}")

    def one(sql):
        (row,) = sess.execute(sql).rows
        return row

    # --- C1: declared constraints at SF10, on the tpch tables' blocks ---
    def c1():
        sess.execute(f"create database {CDB}")
        for name in CONSTRAINT_TABLES:
            sess.execute(constraint_ddl(cat, name))
        for name in CONSTRAINT_TABLES:
            src, dst = cat.table("tpch", name), cat.table(CDB, name)
            blocks = []
            for b in src.blocks():
                cols = dict(b.columns)  # a block of its own over the same arrays
                if name == "lineitem":
                    c = cols["l_receiptdate"]
                    cols["l_receiptdate"] = HostColumn(c.type, spec_receiptdate(
                        cols["l_shipdate"].data, c.data), c.valid, c.dictionary)
                blocks.append(HostBlock(cols, b.nrows, part_id=b.part_id))
            dst.dictionaries.update(src.dictionaries)
            dst.replace_blocks(blocks)
        arr = capture_arrays(cat, {"lineitem": ["l_quantity", "l_extendedprice", "l_tax",
                                                "l_discount", "l_shipdate", "l_receiptdate"],
                                   "orders": ["o_totalprice"],
                                   "partsupp": ["ps_availqty", "ps_supplycost"],
                                   "part": ["p_retailprice", "p_size"]}, db=CDB)
        want = {"l_qty_nonneg": arr["lineitem"]["l_quantity"] < 0,
                "l_price_nonneg": arr["lineitem"]["l_extendedprice"] < 0,
                "l_tax_nonneg": arr["lineitem"]["l_tax"] < 0,
                "l_discount_range": (arr["lineitem"]["l_discount"] < 0)
                | (arr["lineitem"]["l_discount"] > 100),
                "l_ship_before_receipt": arr["lineitem"]["l_shipdate"]
                > arr["lineitem"]["l_receiptdate"],
                "o_price_nonneg": arr["orders"]["o_totalprice"] < 0,
                "ps_qty_nonneg": arr["partsupp"]["ps_availqty"] < 0,
                "ps_cost_nonneg": arr["partsupp"]["ps_supplycost"] < 0,
                "p_price_nonneg": arr["part"]["p_retailprice"] < 0,
                "p_size_nonneg": arr["part"]["p_size"] < 0}
        bad = {}
        for name, checks in TPCH_CHECKS.items():
            for cname, expr in checks:
                (n,) = one(f"select count(*) from {CDB}.{name} where not ({expr})")
                assert n == int(want[cname].sum()) == 0, (cname, n, int(want[cname].sum()))
                bad[cname] = n
        orphans, keys = {}, {}
        for tbl, col, parent, pcol, _act in TPCH_FKS:
            keys.setdefault(tbl, set()).add(col)
            keys.setdefault(parent, set()).add(pcol)
        a = capture_arrays(cat, {n: sorted(c) for n, c in keys.items()}, db=CDB)
        for tbl, col, parent, pcol, _act in TPCH_FKS:
            (n,) = one(f"select count(*) from {CDB}.{tbl} c left join {CDB}.{parent} p "
                       f"on c.{col} = p.{pcol} where c.{col} is not null and p.{pcol} is null")
            expect = int((~member(a[tbl][col], a[parent][pcol])).sum())
            assert n == expect == 0, (tbl, col, n, expect)
            orphans[f"{tbl}.{col}"] = n
        ddl = sess.execute(f"show create table {CDB}.lineitem").rows[0][1]
        log("constraints: SHOW CREATE TABLE tpch_c.lineitem\n" + ddl)
        assert "constraint l_orderkey_fk foreign key (l_orderkey) references tpch_c.orders " \
               "(o_orderkey) on delete cascade" in ddl, ddl
        assert "constraint l_ship_before_receipt check (l_shipdate <= l_receiptdate)" in ddl, ddl
        refs = sess.execute("select constraint_name, update_rule, delete_rule, table_name, "
                            "referenced_table_name from information_schema.referential_constraints "
                            f"where constraint_schema = '{CDB}'").rows
        log(f"constraints: referential_constraints {refs}")
        assert sorted(refs) == sorted(
            (f"{col}_fk", "NO ACTION", {"cascade": "CASCADE", "set null": "SET NULL"}.get(
                act, "NO ACTION"), tbl, parent) for tbl, col, parent, _p, act in TPCH_FKS), refs
        return {"violating_rows": bad, "orphans": orphans}

    step("c1_declare", c1)

    # --- C2: RF1 under the constraints ---
    ora_li_cols = ["l_orderkey", "l_quantity", "l_extendedprice", "l_discount", "l_tax",
                   "l_returnflag", "l_linestatus", "l_shipdate"]

    def staged(name, cols, like):
        """A table of RF1's rows in the constraint phase's database, made
        through the storage layer (no statement, no constraint): the rows
        INSERT ... SELECT then writes under the constraints."""
        from tidb_tpu_torch.chunk import column_from_values
        from tidb_tpu_torch.storage import TableSchema

        src = cat.table(CDB, like)
        t = cat.create_table(CDB, name, TableSchema(list(src.schema.columns)))
        n = len(next(iter(cols.values())))
        vals = {}
        for c, typ in src.schema.columns:
            v = cols.get(c)
            if v is None:
                vals[c] = [None] * n
            elif typ.kind.name == "DECIMAL":
                vals[c] = (v / 10 ** typ.scale).tolist()
            else:
                vals[c] = v.tolist()
        t.append_block(HostBlock.from_columns(
            {c: column_from_values(vals[c], typ) for c, typ in src.schema.columns}))
        return t

    def c2():
        rng = np.random.default_rng(17)
        rf1 = rf1_data(cat, rng, SF, RF_ORDERS, 0, db=CDB)
        li = rf1["lineitem"]
        li["l_receiptdate"] = li["l_shipdate"] + rng.integers(1, 31, len(li["l_shipdate"]))
        n_o, n_l = RF_ORDERS, len(li["l_orderkey"])
        for name, like, cols in (("rf1_orders", "orders", rf1["orders"]),
                                 ("rf1_lineitem", "lineitem", li)):
            staged(name, cols, like)
            cat.create_table(CDB, f"plain_{like}", cat.table(CDB, name).schema)
        # the same rows into tables without constraints: what the
        # constraints add to the statements
        t0 = time.perf_counter()
        for like in ("orders", "lineitem"):
            sess.execute(f"insert into {CDB}.plain_{like} select * from {CDB}.rf1_{like}")
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        before = cat.table(CDB, "lineitem").nrows
        t0 = time.perf_counter()
        sess.execute("begin")
        res = sess.execute(f"insert into {CDB}.orders select * from {CDB}.rf1_orders")
        assert res.affected == n_o, res.affected
        res = sess.execute(f"insert into {CDB}.lineitem select * from {CDB}.rf1_lineitem")
        assert res.affected == n_l, res.affected
        sess.execute("commit")
        torch.cuda.synchronize()
        rf1_s = time.perf_counter() - t0
        for name in ("rf1_orders", "rf1_lineitem", "plain_orders", "plain_lineitem"):
            scan.release(cat.table(CDB, name))
            sess.execute(f"drop table {CDB}.{name}")
        assert cat.table(CDB, "lineitem").nrows == before + n_l
        ora = capture_arrays(cat, {"lineitem": ora_li_cols}, db=CDB)
        t_li = cat.table(CDB, "lineitem")
        check_q1(sess.execute(O.Q1_SQL.replace("from lineitem", f"from {CDB}.lineitem")),
                 O.numpy_q1(ora["lineitem"]), t_li)
        values_s = report.get("refresh", {}).get("steps", {}).get("rf1", {}).get("s")
        log(f"constraints: RF1 by INSERT ... SELECT under the constraints {rf1_s:.2f}s, without "
            f"them {plain_s:.2f}s ({n_o} orders, {n_l} lineitems); the refresh phase's RF1 "
            f"(INSERT ... VALUES, no constraints) {values_s}")
        rf1_keys.extend(rf1["orders"]["o_orderkey"].tolist())
        return {"rf1_s": rf1_s, "plain_s": plain_s, "orders": n_o, "lineitems": n_l,
                "refresh_rf1_s": values_s}

    rf1_keys: list = []
    step("c2_rf1", c2)
    rf1_keys = np.array(rf1_keys, dtype=np.int64)

    # --- C3: refused writes leave the tables unchanged ---
    sums = {"orders": "count(*), sum(o_totalprice), sum(o_custkey)",
            "lineitem": "count(*), sum(l_discount), sum(l_extendedprice), sum(l_partkey)",
            "nation": "count(*), sum(n_nationkey)", "customer": "count(*), sum(c_nationkey)"}

    def state():
        return {n: one(f"select {e} from {CDB}.{n}") for n, e in sums.items()}

    def c3():
        before = state()
        ok = int(rf1_keys[0])
        cust_max = int(one(f"select max(c_custkey) from {CDB}.customer")[0])
        absent = cust_max + 1000
        refused(f"insert into {CDB}.orders (o_orderkey, o_custkey, o_orderstatus, o_totalprice, "
                f"o_orderdate) values ({int(rf1_keys[-1]) + 10}, {absent}, 'O', 100.00, "
                f"'1996-01-02')",
                f"FOREIGN KEY 'o_custkey_fk' violated: [{absent}] not in {CDB}.customer.c_custkey")
        refused(f"insert into {CDB}.lineitem (l_orderkey, l_partkey, l_suppkey, l_linenumber, "
                f"l_quantity, l_extendedprice, l_discount, l_tax, l_shipdate, l_receiptdate) "
                f"values ({ok}, 1, 1, 9, 1.00, 100.00, 0.05, 0.01, '1996-02-10', '1996-02-01')",
                "CHECK constraint 'l_ship_before_receipt' violated")
        refused(f"delete from {CDB}.nation where n_nationkey = 3",
                f"FOREIGN KEY 'c_nationkey_fk' on {CDB}.customer restricts this statement: "
                "[3] still referenced")
        paths = []
        columnar = sess._try_columnar_update

        def spy(*a):
            # "refused": the columnar path itself raised (its CHECK)
            try:
                r = columnar(*a)
            except ValueError:
                paths.append("refused")
                raise
            paths.append("columnar" if r is not None else "rewrite")
            return r

        sess._try_columnar_update = spy
        try:
            refused(f"update {CDB}.lineitem set l_discount = 1.5 where l_orderkey = {ok}",
                    "CHECK constraint 'l_discount_range' violated")
            assert paths == ["refused"], paths
            refused(f"drop table {CDB}.orders",
                    f"cannot drop {CDB}.orders: referenced by FOREIGN KEY 'l_orderkey_fk' on "
                    f"{CDB}.lineitem")
            after = state()
            assert after == before, (before, after)
            # INSERT IGNORE: C3_IGNORE_BAD of C3_IGNORE_ROWS rows violate
            rng = np.random.default_rng(23)
            n, bad = C3_IGNORE_ROWS, C3_IGNORE_BAD
            part_max = int(one(f"select max(p_partkey) from {CDB}.part")[0])
            keys = rng.choice(rf1_keys, n)
            ship = rng.integers(date_to_days("1995-01-01"), date_to_days("1996-01-01"), n)
            rows = {"l_orderkey": keys, "l_partkey": rng.integers(1, part_max + 1, n),
                    "l_suppkey": np.ones(n, dtype=np.int64),
                    "l_linenumber": 10 + np.arange(n), "l_quantity": rng.integers(1, 51, n) * 100,
                    "l_extendedprice": rng.integers(90_000, 10_500_000, n),
                    "l_discount": rng.integers(0, 11, n), "l_tax": rng.integers(0, 9, n),
                    "l_returnflag": np.array(["N"] * n, dtype=object),
                    "l_linestatus": np.array(["O"] * n, dtype=object),
                    "l_shipdate": ship, "l_commitdate": ship,
                    "l_receiptdate": ship + rng.integers(1, 31, n),
                    "l_shipmode": np.array(["MAIL"] * n, dtype=object),
                    "l_shipinstruct": np.array(["NONE"] * n, dtype=object)}
            which = rng.choice(n, bad, replace=False)
            rows["l_receiptdate"][which[: bad // 2]] = ship[which[: bad // 2]] - 1
            rows["l_partkey"][which[bad // 2:]] = part_max + 1 + np.arange(bad - bad // 2)
            keep = np.ones(n, dtype=bool)
            keep[which] = False
            res = sess.execute(insert_sql(f"{CDB}.lineitem", LINEITEM_KINDS, rows, 0, n)
                               .replace("insert into", "insert ignore into", 1))
            assert res.affected == n - bad, res.affected
            got = one(f"select count(*), sum(l_extendedprice), sum(l_linenumber) from "
                      f"{CDB}.lineitem where l_linenumber >= 10")
            want = (int(keep.sum()), int(rows["l_extendedprice"][keep].sum()) / 100,
                    int(rows["l_linenumber"][keep].sum()))
            assert tuple(got) == want, (got, want)
            # a constrained UPDATE on the columnar path, against numpy
            li = capture_arrays(cat, {"lineitem": ["l_shipdate", "l_discount"]}, db=CDB)["lineitem"]
            hit = (li["l_shipdate"] >= date_to_days("1998-08-01")) & (li["l_discount"] <= 9)
            n_paths = len(paths)
            res = sess.execute(f"update {CDB}.lineitem set l_discount = l_discount + 0.01 "
                               "where l_shipdate >= '1998-08-01' and l_discount <= 0.09")
            assert paths[n_paths:] == ["columnar"], paths
            assert res.affected == int(hit.sum()), (res.affected, int(hit.sum()))
            got = capture_arrays(cat, {"lineitem": ["l_discount"]}, db=CDB)["lineitem"]["l_discount"]
            assert np.array_equal(got, li["l_discount"] + hit), "l_discount after the UPDATE"
        finally:
            del sess._try_columnar_update
        return {"ignore_kept": int(keep.sum()), "updated": int(hit.sum())}

    step("c3_refusals", c3)

    # --- C4: RF2 by cascade, and SET NULL ---
    def c4():
        a = capture_arrays(cat, {"orders": ["o_orderkey"], "lineitem": ["l_orderkey"]}, db=CDB)
        rf2 = np.sort(a["orders"]["o_orderkey"])[:RF_ORDERS]
        cascaded = int(member(a["lineitem"]["l_orderkey"], rf2).sum())
        n_li = len(a["lineitem"]["l_orderkey"])
        t0 = time.perf_counter()
        res = sess.execute(f"delete from {CDB}.orders where o_orderkey in ("
                           + ", ".join(str(int(k)) for k in rf2) + ")")
        torch.cuda.synchronize()
        cascade_s = time.perf_counter() - t0
        assert res.affected == len(rf2), res.affected
        rf2_last.append(int(rf2[-1]))
        assert cat.table(CDB, "lineitem").nrows == n_li - cascaded
        qcols = {"lineitem": ["l_orderkey", "l_quantity", "l_extendedprice", "l_discount", "l_tax",
                              "l_returnflag", "l_linestatus", "l_shipdate"],
                 "orders": ["o_orderkey", "o_custkey", "o_orderdate", "o_shippriority",
                            "o_totalprice"],
                 "customer": ["c_custkey", "c_mktsegment"]}
        ora = capture_arrays(cat, qcols, db=CDB)
        assert not member(ora["lineitem"]["l_orderkey"], rf2).any()
        ocat = oracle_catalog(cat, ora, db=CDB)
        t_li = cat.table(CDB, "lineitem")
        q18 = O.TPCH_QUERIES["q18"]
        q18_params = O.spec_params("q18", SF)
        in_c = (lambda sql: sql.replace("from lineitem", f"from {CDB}.lineitem")
                .replace("customer, orders, lineitem", f"{CDB}.customer, {CDB}.orders, "
                         f"{CDB}.lineitem"))
        # the three oracles side by side, before the three queries
        with ThreadPoolExecutor(3) as pool:
            o1, o3 = pool.submit(O.numpy_q1, ora["lineitem"]), pool.submit(O.numpy_q3, ocat)
            o18 = pool.submit(q18.oracle, ocat, **q18_params)
        check_q1(sess.execute(in_c(O.Q1_SQL)), o1.result(), t_li)
        check_q3(sess.execute(in_c(O.Q3_SQL)), ocat, o3.result())
        sess.execute(f"use {CDB}")
        try:
            O.check_rows(sess.execute(q18.sql.format(**q18_params)).rows, o18.result(),
                         q18.order, q18.limit)
            # SET NULL: the orders of C4_CUSTOMERS deleted customers
            cust = np.sort(ora["customer"]["c_custkey"])
            gone = cust[np.linspace(0, len(cust) - 1, C4_CUSTOMERS).astype(np.int64)]
            hit = member(ora["orders"]["o_custkey"], gone)
            t1 = time.perf_counter()
            res = sess.execute("delete from customer where c_custkey in ("
                               + ", ".join(str(int(k)) for k in gone) + ")")
            torch.cuda.synchronize()
            set_null_s = time.perf_counter() - t1
            assert res.affected == C4_CUSTOMERS, res.affected
            (nulls,) = one("select count(*) from orders where o_custkey is null")
            assert nulls == int(hit.sum()), (nulls, int(hit.sum()))
            q13 = O.TPCH_QUERIES["q13"]
            q13_cols = {"orders": ["o_custkey", "o_comment"], "customer": ["c_custkey"]}
            ocat13 = oracle_catalog(cat, capture_arrays(cat, q13_cols, db=CDB), db=CDB)
            oracle_check(ocat13, q13, {})(sess.execute(q13.sql))
        finally:
            sess.execute("use tpch")
        refresh_rf2 = report.get("refresh", {}).get("steps", {}).get("rf2", {}).get("s")
        log(f"constraints: RF2 as one cascading DELETE {cascade_s:.2f}s ({len(rf2)} orders, "
            f"{cascaded} lineitems); the refresh phase's RF2 {refresh_rf2}")
        return {"cascade_s": cascade_s, "orders_deleted": len(rf2), "lineitems_cascaded": cascaded,
                "refresh_rf2_s": refresh_rf2, "set_null_s": set_null_s,
                "orders_nulled": int(hit.sum())}

    rf2_last: list = []
    step("c4_cascade", c4)

    # --- C5: Q15 over a view, on the tpch tables ---
    def c5():
        d0, d1 = "1996-01-01", "1996-04-01"
        create = ("create view revenue0 (supplier_no, total_revenue) as select l_suppkey, "
                  "sum(l_extendedprice * (1 - l_discount)) from lineitem where l_shipdate >= "
                  f"date '{d0}' and l_shipdate < date '{d1}' "
                  "group by l_suppkey")
        q15 = ("select s_suppkey, s_name, s_address, s_phone, total_revenue from supplier, "
               "revenue0 where s_suppkey = supplier_no and total_revenue = "
               "(select max(total_revenue) from revenue0) order by s_suppkey")
        cols = {"lineitem": ["l_suppkey", "l_shipdate", "l_extendedprice", "l_discount"],
                "supplier": ["s_suppkey", "s_name", "s_address", "s_phone"]}
        arr = capture_arrays(cat, cols)
        ocat = oracle_catalog(cat, arr)
        want = O.numpy_q15(ocat, d0, d1)
        sup = arr["supplier"]
        s_row = {int(k): i for i, k in enumerate(sup["s_suppkey"].tolist())}
        t_s = cat.table("tpch", "supplier")

        def check(res):
            O.check_rows([(r[0], r[1], r[4]) for r in res.rows], want, (0,), None)
            for r in res.rows:
                i = s_row[int(r[0])]
                assert r[2] == t_s.dictionaries["s_address"][sup["s_address"][i]], r
                assert r[3] == t_s.dictionaries["s_phone"][sup["s_phone"][i]], r

        sess.execute(create)
        times = []
        for _ in range(4):
            t0 = time.perf_counter()
            res = sess.execute(q15)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            check(res)
        cte = []
        for _ in range(4):
            t0 = time.perf_counter()
            res = sess.execute(O.Q15_SQL)
            torch.cuda.synchronize()
            cte.append(time.perf_counter() - t0)
            O.check_rows(res.rows, want, (0,), None)
        sess.execute("create view top_supplier as select supplier_no from revenue0 where "
                     "total_revenue = (select max(total_revenue) from revenue0)")
        O.check_rows(sess.execute("select supplier_no from top_supplier").rows,
                     [(w[0],) for w in want], None, None)
        shown = sess.execute("show create view revenue0").rows
        assert shown[0][0] == "revenue0" and shown[0][1].startswith(
            "CREATE VIEW `revenue0` (supplier_no, total_revenue) AS select l_suppkey"), shown
        vrow = sess.execute("select table_schema, table_name, definer from "
                            "information_schema.views where table_name = 'revenue0'").rows
        assert vrow == [("tpch", "revenue0", "root")], vrow
        sess.execute("drop view top_supplier")
        sess.execute("drop view revenue0")
        # a view over tpch_c.lineitem sees C4's cascade: RF2 took the
        # oldest orders, so no line item is left at or below its last key
        sess.execute(f"create view {CDB}.li_old as select count(*) n, min(l_orderkey) k "
                     f"from {CDB}.lineitem where l_orderkey <= {rf2_last[0]}")
        lk = capture_arrays(cat, {"lineitem": ["l_orderkey"]}, db=CDB)["lineitem"]["l_orderkey"]
        assert int((lk <= rf2_last[0]).sum()) == 0
        assert tuple(one(f"select n, k from {CDB}.li_old")) == (0, None)
        sess.execute(f"drop view {CDB}.li_old")
        log(f"constraints: Q15 over a view cold {times[0]:.3f}s, warm ms "
            f"{[round(x * 1e3, 2) for x in times[1:]]}; as a CTE warm ms "
            f"{[round(x * 1e3, 2) for x in cte[1:]]}")
        return {"view_cold_s": times[0], "view_warm_ms": [x * 1e3 for x in times[1:]],
                "cte_cold_s": cte[0], "cte_warm_ms": [x * 1e3 for x in cte[1:]],
                "rows": len(want)}

    step("c5_views", c5)

    # --- C6: a stored generated column on supplier ---
    def c6():
        t0 = time.perf_counter()
        sess.execute(f"alter table {CDB}.supplier add column s_acct_band int "
                     "as (floor(s_acctbal / 1000)) stored")
        backfill_s = time.perf_counter() - t0
        scale = cat.table(CDB, "supplier").schema.types["s_acctbal"].scale

        def band_check():
            a = capture_arrays(cat, {"supplier": ["s_acctbal", "s_acct_band", "s_nationkey"]},
                               db=CDB)["supplier"]
            band = np.floor(a["s_acctbal"] / 10**scale / 1000).astype(np.int64)
            assert np.array_equal(a["s_acct_band"], band), "s_acct_band"
            keys, inv = np.unique(band, return_inverse=True)
            cnt = np.bincount(inv)
            tot = np.bincount(inv, weights=a["s_acctbal"].astype(np.float64))
            want = [(int(k), int(c), int(round(s)) / 10**scale) for k, c, s in zip(keys, cnt, tot)]
            O.check_rows(sess.execute(f"select s_acct_band, count(*), sum(s_acctbal) from "
                                      f"{CDB}.supplier group by s_acct_band").rows, want, None, None)
            return a

        band_check()
        top = int(one(f"select max(s_suppkey) from {CDB}.supplier")[0])
        res = sess.execute(f"insert into {CDB}.supplier (s_suppkey, s_name, s_address, "
                           f"s_nationkey, s_phone, s_acctbal, s_comment) values "
                           f"({top + 1}, 'Supplier#c6a', 'addr', 3, '13-000', 4321.50, 'c6'), "
                           f"({top + 2}, 'Supplier#c6b', 'addr', 4, '14-000', -871.25, 'c6')")
        assert res.affected == 2
        assert sess.execute(f"select s_acct_band from {CDB}.supplier where s_suppkey > {top} "
                            "order by s_suppkey").rows == [(4,), (-1,)]
        paths = []
        columnar = sess._try_columnar_update

        def spy(*a):
            r = columnar(*a)
            paths.append(r is not None)
            return r

        sess._try_columnar_update = spy
        try:
            before = band_check()
            nat = before["s_nationkey"] == 7
            res = sess.execute(f"update {CDB}.supplier set s_acctbal = s_acctbal + 2500 "
                               "where s_nationkey = 7")
            assert paths == [True], paths
            assert res.affected == int(nat.sum()), (res.affected, int(nat.sum()))
            after = band_check()
            assert np.array_equal(after["s_acctbal"],
                                  before["s_acctbal"] + np.where(nat, 2500 * 10**scale, 0))
        finally:
            del sess._try_columnar_update
        refused(f"insert into {CDB}.supplier (s_suppkey, s_name, s_address, s_nationkey, "
                f"s_phone, s_acctbal, s_comment, s_acct_band) values ({top + 3}, 'Supplier#c6c', "
                "'addr', 3, '13-000', 10.00, 'c6', 7)",
                "the value specified for generated column 's_acct_band' is not allowed")
        return {"backfill_s": backfill_s, "suppliers": cat.table(CDB, "supplier").nrows,
                "updated": int(nat.sum())}

    step("c6_generated", c6)

    # the phase's tables go, with their cached device columns
    for name in CONSTRAINT_TABLES:
        scan.release(cat.table(CDB, name))
    sess.execute(f"drop database {CDB}")
    launches = dict(K.LAUNCHES)
    out["seconds"] = time.perf_counter() - t_phase
    out["launches"] = launches
    log(f"constraints: phase {out['seconds']:.1f}s of {CONSTRAINT_LIMIT_S:g}, launches {launches}")
    assert out["seconds"] <= CONSTRAINT_LIMIT_S, out["seconds"]
    return launches


def constraints_only(report) -> dict:
    """The SF10 tables, ANALYZEd, and the constraint phase alone: the
    short loop for constraint work. Returns the phase's launches."""
    from tidb_tpu_torch.bench import load_tpch
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage import Catalog

    t0 = time.perf_counter()
    cat = Catalog()
    load_tpch(cat, sf=SF, seed=1, tables=TABLES)
    sess = Session(cat, db="tpch")
    for t in TABLES:
        sess.execute(f"analyze table {t}")
    log(f"datagen and analyze: SF{SF:g} in {time.perf_counter() - t0:.1f}s")
    launches = constraint_phase(cat, sess, report)
    for k, n in launches.items():
        assert n > 0, f"kernel {k} was not launched in the constraint phase"
    return launches


#: the partition phase's time limit (seconds), oracles included
PARTITION_LIMIT_S = 100.0
#: the database the partition phase declares its tables in
PDB = "tpch_p"
#: lineitem and orders: one RANGE partition per year, p1992 ... p1998,
#: with no MAXVALUE (TiDB's "Partitioning" guide: RANGE by date)
PARTITION_YEARS = list(range(1992, 1999))
#: customer: HASH (c_custkey) over this many partitions
CUSTOMER_BUCKETS = 16
#: supplier: LIST (s_nationkey), one partition per region (r_regionkey
#: order) listing its five nations
REGION_PARTS = ["p_africa", "p_america", "p_asia", "p_europe", "p_middle_east"]
#: warm runs of each P2 read over tpch_p, and of the same read over the
#: unpartitioned tpch tables (the TPC-H phase timed those already)
PARTITION_WARM_RUNS = 2
PARTITION_FLAT_WARM_RUNS = 1
#: threads of P2's numpy oracles (beside P1's load)
PARTITION_ORACLE_THREADS = 6
#: P2's reads beyond TPC-H: a HASH point get and a LIST range
HASH_POINT_KEY = 42
HASH_POINT_SQL = f"select c_custkey, c_name, c_acctbal from customer where c_custkey = {HASH_POINT_KEY}"
LIST_RANGE_SQL = ("select s_nationkey, count(*), sum(s_acctbal) from supplier "
                  "where s_nationkey >= 6 and s_nationkey <= 7 group by s_nationkey "
                  "order by s_nationkey")
#: each P2 read's EXPLAIN partition lists (one per pruned scan, sorted),
#: as the JAX package's pruning gives them (tests/test_torch_partition.py)
PARTITION_LISTS = {
    "q6": ["[p1994]"], "q14": ["[p1995]"], "q7": ["[p1995,p1996]"],
    "q3": ["[p1992,p1993,p1994,p1995]", "[p1995,p1996,p1997,p1998]"],
    "q4": ["[p1993]"], "q5": ["[p1994]"], "q10": ["[p1993]"], "q8": ["[p1995,p1996]"],
    "q1": [], "q12": [], "hash_point": ["[p10]"], "list_range": ["[p_europe]"],
}


def _col_sql(typ) -> str:
    """A column's type in the partition phase's DDL, by kind name (the
    JAX package's schemas render the same)."""
    return {"INT": "bigint", "DATE": "date", "FLOAT": "double",
            "STRING": "varchar(199)"}.get(typ.kind.name, f"decimal(15,{typ.scale})")


def _year_bounds(years=PARTITION_YEARS) -> np.ndarray:
    """The RANGE partitions' upper bounds in epoch days."""
    return np.array([(np.datetime64(f"{y + 1}-01-01") - np.datetime64("1970-01-01")).astype(int)
                     for y in years], dtype=np.int64)


def _region_nations(cat):
    """r_regionkey -> its nation keys, from the tpch nation table."""
    nation = cat.table("tpch", "nation")
    nk = np.concatenate([b.columns["n_nationkey"].data for b in nation.blocks()])
    rk = np.concatenate([b.columns["n_regionkey"].data for b in nation.blocks()])
    return {r: sorted(int(n) for n in nk[rk == r]) for r in range(len(REGION_PARTS))}


def partition_ddl(cat) -> list:
    """The partition phase's DDL over `cat`'s tpch tables: database
    tpch_p with lineitem and orders RANGE-partitioned by year, customer
    HASH-partitioned by key, supplier LIST-partitioned by region and the
    other four tables unpartitioned, with the tpch tables' columns and
    primary keys."""
    years = PARTITION_YEARS

    def by_year(col):
        return (f" partition by range ({col}) ("
                + ", ".join(f"partition p{y} values less than ('{y + 1}-01-01')" for y in years)
                + ")")

    regions = _region_nations(cat)
    clause = {
        "lineitem": by_year("l_shipdate"), "orders": by_year("o_orderdate"),
        "customer": f" partition by hash (c_custkey) partitions {CUSTOMER_BUCKETS}",
        "supplier": " partition by list (s_nationkey) (" + ", ".join(
            f"partition {p} values in (" + ", ".join(map(str, regions[r])) + ")"
            for r, p in enumerate(REGION_PARTS)) + ")",
    }
    out = [f"create database {PDB}"]
    for name in TABLES:
        t = cat.table("tpch", name)
        parts = [f"{c} {_col_sql(ty)}" for c, ty in t.schema.columns]
        if t.schema.primary_key:
            parts.append("primary key (" + ", ".join(t.schema.primary_key) + ")")
        out.append(f"create table {PDB}.{name} (" + ", ".join(parts) + ")" + clause.get(name, ""))
    return out


def partition_load(cat) -> None:
    """tpch_p's rows: the tpch tables' blocks, split through each
    partitioned table's own split_by_partition (the others' blocks
    shared), installed through the storage layer as C1 installs its
    copies: no statement over 60M rows."""
    for name in TABLES:
        src, dst = cat.table("tpch", name), cat.table(PDB, name)

        def split(b, dst=dst):
            # a block of its own over the same arrays: a dictionary merge
            # rewrites the blocks of the table it lands in
            own = type(b)(dict(b.columns), b.nrows)
            return dst.split_by_partition(own) if dst.partition is not None else [own]

        # the many small blocks the earlier phases' writes left split side
        # by side (a long block's columns are gathered on threads already)
        with ThreadPoolExecutor(4) as ex:
            blocks = [nb for part in ex.map(split, src.blocks()) for nb in part]
        dst.dictionaries.update(src.dictionaries)
        dst.replace_blocks(blocks)


def partition_reads(sf: float) -> list:
    """P2's reads as (name, SQL): TPC-H Q6, Q14, Q7, Q3, Q4, Q5, Q10 and
    Q8, whose date ranges prune; Q1 and Q12, which prune nothing; a HASH
    point query and a LIST range query."""
    from tidb_tpu_torch.bench import oracles as O

    out = []
    for name in ("q6", "q14", "q7", "q3", "q4", "q5", "q10", "q8", "q1", "q12"):
        sql = {"q1": O.Q1_SQL, "q3": O.Q3_SQL, "q5": O.Q5_SQL, "q6": O.Q6_SQL}.get(name)
        if sql is None:
            sql = O.TPCH_QUERIES[name].sql.format(**O.spec_params(name, sf))
        out.append((name, sql))
    return out + [("hash_point", HASH_POINT_SQL), ("list_range", LIST_RANGE_SQL)]


def _explain_lists(sess, sql) -> list:
    """The `partitions=[...]` labels of a read's EXPLAIN, sorted."""
    return sorted(r[0].split("partitions=")[1].split(" ")[0]
                  for r in sess.execute("explain " + sql).rows if "partitions=" in r[0])


def _want_counts(arrays, regions) -> dict:
    """Rows per partition id, by numpy: per year of l_shipdate and
    o_orderdate, per c_custkey bucket and per region of s_nationkey."""
    n_of_region = {n: r for r, ns in regions.items() for n in ns}
    out = {}
    bounds = _year_bounds()
    for name, col in (("lineitem", "l_shipdate"), ("orders", "o_orderdate")):
        pid = np.searchsorted(bounds, arrays[name][col], side="right")
        out[name] = np.bincount(pid, minlength=len(bounds)).tolist()
    keys = arrays["customer"]["c_custkey"]
    out["customer"] = np.bincount(keys % CUSTOMER_BUCKETS, minlength=CUSTOMER_BUCKETS).tolist()
    reg = np.array([n_of_region[int(n)] for n in range(max(n_of_region) + 1)])
    out["supplier"] = np.bincount(reg[arrays["supplier"]["s_nationkey"]],
                                  minlength=len(REGION_PARTS)).tolist()
    return out


def _infoschema_counts(sess) -> dict:
    """tpch_p's rows per partition, by table, from information_schema."""
    rows = sess.execute("select table_name, partition_ordinal_position, table_rows from "
                        f"information_schema.partitions where table_schema = '{PDB}' "
                        "and partition_name is not null "
                        "order by table_name, partition_ordinal_position").rows
    out: dict = {}
    for tn, _pos, n in rows:
        out.setdefault(tn, []).append(int(n))
    return out


PARTITION_COUNT_COLUMNS = {"lineitem": ["l_shipdate"], "orders": ["o_orderdate"],
                           "customer": ["c_custkey"], "supplier": ["s_nationkey"]}


def partition_prove(cat, sess, arrays=None) -> dict:
    """P1's proof of the routing: every block of tpch_p's partitioned
    tables holds only rows inside its partition (RANGE bounds by numpy,
    the hash bucket, the region's nations); information_schema's
    table_rows equal numpy's counts per year, bucket and region (of
    `arrays`, else of the tpch tables' rows); SHOW CREATE TABLE renders
    each clause. Returns the counts."""
    bounds = _year_bounds()
    lower = np.concatenate([[np.iinfo(np.int64).min], bounds[:-1]])
    regions = _region_nations(cat)
    for name, col in (("lineitem", "l_shipdate"), ("orders", "o_orderdate")):
        for b in cat.table(PDB, name).blocks():
            d = b.columns[col].data
            assert b.part_id is not None and (d >= lower[b.part_id]).all() and (
                d < bounds[b.part_id]).all(), (name, b.part_id)
    for b in cat.table(PDB, "customer").blocks():
        assert (b.columns["c_custkey"].data % CUSTOMER_BUCKETS == b.part_id).all()
    for b in cat.table(PDB, "supplier").blocks():
        assert np.isin(b.columns["s_nationkey"].data, regions[b.part_id]).all()
    if arrays is None:
        arrays = capture_arrays(cat, PARTITION_COUNT_COLUMNS)
    want = _want_counts(arrays, regions)
    got = _infoschema_counts(sess)
    assert got == want, (got, want)
    ddl = {n: sess.execute(f"show create table {PDB}.{n}").rows[0][1]
           for n in ("lineitem", "orders", "customer", "supplier")}
    assert ("partition by range (l_shipdate) (partition p1992 values less than "
            "(date '1993-01-01'), partition p1993") in ddl["lineitem"], ddl["lineitem"]
    assert "partition p1998 values less than (date '1999-01-01'))" in ddl["orders"], ddl["orders"]
    assert ddl["customer"].endswith(f"partition by hash (c_custkey) partitions "
                                    f"{CUSTOMER_BUCKETS}"), ddl["customer"]
    assert (f"partition by list (s_nationkey) (partition p_africa values in "
            f"({', '.join(map(str, regions[0]))})") in ddl["supplier"], ddl["supplier"]
    return got


def partition_phase(cat, sess, report) -> dict:
    """The partition phase over the SF10 tables: database tpch_p as TiDB's
    partitioning guide deploys TPC-H (lineitem and orders RANGE by year,
    customer HASH by key, supplier LIST by region). P1 declares and loads
    it from the tpch tables' blocks and proves the routing; P2 runs eight
    pruning TPC-H queries, two controls and a HASH and a LIST read over
    it, cold once and warm twice, each against its numpy oracle and
    beside the same query over the unpartitioned tables (cold once, warm
    once); P3 routes RF1's
    rows and RF2's deletes; P4 runs ADD, TRUNCATE, DROP and EXCHANGE
    PARTITION and a stale read pinned before the DROP; P5 runs a
    sequence, a temporary table under Q18, an advisory lock and a SLEEP
    cut by KILL. Each step prints its seconds, its statements' seconds,
    host->device bytes, kernel launches and every read's partition list.
    The database is dropped at the end. Returns the phase's launches."""
    import torch

    from tidb_tpu_torch.bench import oracles as O
    from tidb_tpu_torch.chunk import TRANSFERS, HostBlock, column_from_values
    from tidb_tpu_torch.executor import kernels as K
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage import TableSchema, scan

    out = report["partitions"] = {}
    t_phase = time.perf_counter()
    log(f"partitions: card {card_line()}")
    K.reset_launches()
    sf = SF

    def step(name, fn):
        """Run fn, recording under `name` its seconds, its statements'
        seconds alone (``stmt_s``), host->device bytes, launches, and
        what fn returns (the reads' partition lists among it)."""
        stmt = {"s": 0.0, "depth": 0}

        def timed(f):
            def run(*a, **kw):
                stmt["depth"] += 1
                t2 = time.perf_counter()
                try:
                    return f(*a, **kw)
                finally:
                    torch.cuda.synchronize()
                    stmt["depth"] -= 1
                    if not stmt["depth"]:
                        stmt["s"] += time.perf_counter() - t2
            return run

        torch.cuda.synchronize()
        h0, t1, l0 = TRANSFERS["h2d_bytes"], time.perf_counter(), dict(K.LAUNCHES)
        sess.execute = timed(sess.execute)
        try:
            extra = fn() or {}
        finally:
            del sess.execute
        torch.cuda.synchronize()
        out[name] = {"s": time.perf_counter() - t1, "stmt_s": stmt["s"],
                     "h2d_bytes": TRANSFERS["h2d_bytes"] - h0,
                     "launches": {k: K.LAUNCHES[k] - l0[k] for k in K.LAUNCHES}, **extra}
        log(f"partitions {name}: " + json.dumps(out[name]))

    reads = partition_reads(sf)
    text = " ".join(sql for _n, sql in reads)
    ora_cols = {n: [c for c in cat.table("tpch", n).schema.names if c in text] for n in TABLES}
    ora_cols["lineitem"] = sorted(set(ora_cols["lineitem"]) | {"l_tax", "l_shipdate"})
    # tpch_p holds the tpch tables' rows, which this phase never writes:
    # P2's oracles run over them on threads from the start, beside P1
    state: dict = {"arr": capture_arrays(cat, ora_cols)}
    arr = state["arr"]
    ocat = state["ocat"] = oracle_catalog(cat, arr)
    pool = ThreadPoolExecutor(PARTITION_ORACLE_THREADS)
    state["oracles"] = {
        "q1": pool.submit(O.numpy_q1, arr["lineitem"]),
        "q6": pool.submit(O.numpy_q6, arr["lineitem"]),
        "q3": pool.submit(O.numpy_q3, ocat), "q5": pool.submit(O.numpy_q5, ocat),
        **{n: pool.submit(O.TPCH_QUERIES[n].oracle, ocat, **O.spec_params(n, sf))
           for n, _s in reads if n in O.TPCH_QUERIES}}

    # --- P1: declare, load, prove ---
    def p1():
        for sql in partition_ddl(cat):
            sess.execute(sql)
        t0 = time.perf_counter()
        partition_load(cat)
        load_s = time.perf_counter() - t0
        # statistics, as bench.py takes them before measuring (Q5's join
        # order reads them)
        t0 = time.perf_counter()
        for name in TABLES:
            sess.execute(f"analyze table {PDB}.{name}")
        analyze_s = time.perf_counter() - t0
        counts = state["counts"] = partition_prove(cat, sess, arr)
        return {"load_s": load_s, "analyze_s": analyze_s, "rows_per_partition": counts,
                "blocks": {n: len(cat.table(PDB, n).blocks()) for n in TABLES}}

    step("p1_declare", p1)

    def checker(name):
        arr, ocat, ora = state["arr"], state["ocat"], state["oracles"]
        t_li = cat.table(PDB, "lineitem")
        if name == "q1":
            return lambda r: check_q1(r, ora["q1"].result(), t_li)
        if name == "q6":
            return lambda r: _check_q6_value(r, ora["q6"].result())
        if name == "q3":
            return lambda r: check_q3(r, ocat, ora["q3"].result())
        if name == "q5":
            return lambda r: check_q5(r, ocat, ora["q5"].result())
        if name == "hash_point":
            c = arr["customer"]
            i = int(np.flatnonzero(c["c_custkey"] == HASH_POINT_KEY)[0])
            nm = cat.table("tpch", "customer").dictionaries["c_name"][c["c_name"][i]]
            want = [(HASH_POINT_KEY, nm, int(c["c_acctbal"][i]) / 100)]
            return lambda r: _assert_rows(r.rows, want)
        if name == "list_range":
            s_ = arr["supplier"]
            want = [(n, int((s_["s_nationkey"] == n).sum()),
                     int(s_["s_acctbal"][s_["s_nationkey"] == n].sum()) / 100) for n in (6, 7)]
            return lambda r: _assert_rows(r.rows, want)
        q = O.TPCH_QUERIES[name]
        return lambda r: O.check_rows(r.rows, ora[name].result(), q.order, q.limit)

    # --- P2: pruned reads beside the unpartitioned tables ---
    def p2():
        oracles_first_s = time.perf_counter()
        for f in state["oracles"].values():
            f.result()
        oracle_s = time.perf_counter() - oracles_first_s
        per, lists = {}, {}
        for name, sql in reads:
            check = checker(name)
            row = {}
            for db in (PDB, "tpch"):
                sess.execute(f"use {db}")
                if db == PDB:
                    lists[name] = _explain_lists(sess, sql)
                    assert lists[name] == PARTITION_LISTS[name], (name, lists[name])
                h0 = TRANSFERS["h2d_bytes"]
                t0 = time.perf_counter()
                res = sess.execute(sql)
                torch.cuda.synchronize()
                cold = time.perf_counter() - t0
                cold_h2d = TRANSFERS["h2d_bytes"] - h0
                check(res)
                warm = []
                for _ in range(PARTITION_WARM_RUNS if db == PDB else PARTITION_FLAT_WARM_RUNS):
                    t0 = time.perf_counter()
                    res = sess.execute(sql)
                    torch.cuda.synchronize()
                    warm.append((time.perf_counter() - t0) * 1e3)
                    check(res)
                row["p" if db == PDB else "flat"] = {
                    "cold_s": cold, "cold_h2d_bytes": cold_h2d, "warm_ms": warm}
            per[name] = row
            log(f"partitions p2 {name}: partitions {lists[name]} " + json.dumps(row))
        sess.execute("use tpch")
        sets = scan.cached_partition_sets()
        cached = {n: {str(k): v for k, v in sets.get(cat.table(PDB, n).uid, {}).items()}
                  for n in ("lineitem", "orders", "customer", "supplier")}
        return {"reads": per, "partitions": lists, "oracle_wait_s": oracle_s,
                "cached_bytes_by_partition_set": cached}

    step("p2_pruned_reads", p2)
    pool.shutdown(wait=True)

    # --- P3: routed writes (RF1 by INSERT ... SELECT, RF2's DELETEs) ---
    # The oracles follow the writes by their deltas: Q1's sums and counts
    # and Q6's revenue add over rows, and so do the rows per year. The
    # rows live are the captured ones under a mask plus the rows written
    # since (`extra`), so no step scans all 60M rows again.
    q16 = ["l_orderkey", "l_quantity", "l_extendedprice", "l_discount", "l_tax",
           "l_returnflag", "l_linestatus", "l_shipdate"]
    arr = state["arr"]
    rows = {"lineitem": {c: arr["lineitem"][c] for c in q16},
            "orders": {c: arr["orders"][c] for c in ("o_orderkey", "o_orderdate")}}
    live = {n: np.ones(len(rows[n]["l_orderkey" if n == "lineitem" else "o_orderkey"]), bool)
            for n in rows}
    extra = {n: {c: v[:0] for c, v in rows[n].items()} for n in rows}
    date_col = {"lineitem": "l_shipdate", "orders": "o_orderdate"}
    all_years = list(range(PARTITION_YEARS[0], PARTITION_YEARS[-1] + 2))  # and 1999
    bounds_all = _year_bounds(all_years)

    def year_hist(d):
        return np.bincount(np.searchsorted(bounds_all, d, side="right"),
                           minlength=len(all_years))[:len(all_years)]

    ref = {"q1": state["oracles"]["q1"].result(), "q6": state["oracles"]["q6"].result(),
           # P1's counts per year, and none in 1999 yet
           "hist": {n: np.array(state["counts"][n] + [0], dtype=np.int64) for n in rows},
           "fixed": state["counts"]}

    def apply(name, part, sign):
        """Add (+1) or remove (-1) the rows `part` of `name` in the oracles."""
        ref["hist"][name] = ref["hist"][name] + sign * year_hist(part[date_col[name]])
        if name == "lineitem" and len(part["l_orderkey"]):
            d = O.numpy_q1(part)
            q1 = ref["q1"] = {k: ref["q1"][k] + sign * d[k] for k in (
                "sum_qty", "sum_base", "sum_disc", "sum_charge", "sum_disc_rate", "cnt")}
            den = np.maximum(q1["cnt"], 1)
            q1.update(avg_qty=q1["sum_qty"] / den, avg_base=q1["sum_base"] / den,
                      avg_disc=q1["sum_disc_rate"] / den)
            ref["q6"] += sign * O.numpy_q6(part)

    def add(name, part):
        extra[name] = {c: np.concatenate([extra[name][c], np.asarray(part[c]).astype(
            rows[name][c].dtype)]) for c in rows[name]}
        apply(name, {c: extra[name][c][-len(part[c]):] for c in rows[name]}, 1)

    def remove(name, pick):
        """Remove the live rows `pick(arrays)` selects; returns how many
        and the rows themselves."""
        gone = []
        for arrays, is_extra in ((rows[name], False), (extra[name], True)):
            m = pick(arrays)
            if not is_extra:
                m &= live[name]
            gone.append({c: v[m] for c, v in arrays.items()})
            apply(name, gone[-1], -1)
            if is_extra:
                extra[name] = {c: v[~m] for c, v in arrays.items()}
            else:
                live[name] &= ~m
        out = {c: np.concatenate([g[c] for g in gone]) for c in rows[name]}
        return len(next(iter(out.values()))), out

    def in_year(name, y, first=False):
        lo, hi = (_year_bounds([y - 1])[0] if not first else np.iinfo(np.int64).min,
                  _year_bounds([y])[0])
        return lambda a: (a[date_col[name]] >= lo) & (a[date_col[name]] < hi)

    def counts_now(years=None):
        """information_schema's counts against the oracle's, under the
        partitions each table has (`years`: table -> its years)."""
        years = years or {}
        want = dict(ref["fixed"])
        for n in ("lineitem", "orders"):
            ys = years.get(n, PARTITION_YEARS)
            want[n] = [int(ref["hist"][n][all_years.index(y)]) for y in ys]
        got = _infoschema_counts(sess)
        assert got == want, (got, want)
        return got

    def q1_q6(step_lists, when):
        """Q1 and Q6 over tpch_p against the oracles, their partition
        lists (Q1 prunes nothing, Q6 keeps p1994) noted under `when`."""
        t_li = cat.table(PDB, "lineitem")
        sess.execute(f"use {PDB}")
        try:
            step_lists[when] = {n: _explain_lists(sess, q) for n, q in (("q1", O.Q1_SQL),
                                                                         ("q6", O.Q6_SQL))}
            assert step_lists[when] == {"q1": [], "q6": ["[p1994]"]}, step_lists[when]
            check_q1(sess.execute(O.Q1_SQL), ref["q1"], t_li)
            _check_q6_value(sess.execute(O.Q6_SQL), ref["q6"])
        finally:
            sess.execute("use tpch")

    def staged(name, cols, like):
        src = cat.table(PDB, like)
        t = cat.create_table(PDB, name, TableSchema(list(src.schema.columns)))
        n = len(next(iter(cols.values())))
        vals = {}
        for c, typ in src.schema.columns:
            v = cols.get(c)
            if v is None:
                vals[c] = [None] * n
            elif typ.kind.name == "DECIMAL":
                vals[c] = (v / 10 ** typ.scale).tolist()
            else:
                vals[c] = v.tolist()
        t.append_block(HostBlock.from_columns(
            {c: column_from_values(vals[c], typ) for c, typ in src.schema.columns}))

    def p3():
        lists = {}
        rng = np.random.default_rng(23)
        rf1 = rf1_data(cat, rng, sf, RF_ORDERS, 0, db=PDB)
        for name, like in (("rf1_orders", "orders"), ("rf1_lineitem", "lineitem")):
            staged(name, rf1[like], like)
        t0 = time.perf_counter()
        res_o = sess.execute(f"insert into {PDB}.orders select * from {PDB}.rf1_orders")
        res_l = sess.execute(f"insert into {PDB}.lineitem select * from {PDB}.rf1_lineitem")
        torch.cuda.synchronize()
        rf1_s = time.perf_counter() - t0
        n_l1 = len(rf1["lineitem"]["l_orderkey"])
        assert res_o.affected == RF_ORDERS and res_l.affected == n_l1
        for name in ("rf1_orders", "rf1_lineitem"):
            scan.release(cat.table(PDB, name))
            sess.execute(f"drop table {PDB}.{name}")
        li_t = cat.table(PDB, "lineitem")
        new = {c: rf1["lineitem"][c] for c in q16}
        for c in ("l_returnflag", "l_linestatus"):
            new[c] = np.searchsorted(li_t.dictionaries[c], new[c])
        add("lineitem", new)
        add("orders", {c: rf1["orders"][c] for c in ("o_orderkey", "o_orderdate")})
        after_rf1 = counts_now()
        q1_q6(lists, "after_rf1")
        # RF2: the RF_ORDERS smallest old orders and their line items
        keys_o = rows["orders"]["o_orderkey"][live["orders"]]
        rf2 = np.sort(np.partition(keys_o, RF_ORDERS)[:RF_ORDERS])
        keys = ", ".join(str(int(k)) for k in rf2)
        t0 = time.perf_counter()
        n_l = sess.execute(f"delete from {PDB}.lineitem where l_orderkey in ({keys})").affected
        n_o = sess.execute(f"delete from {PDB}.orders where o_orderkey in ({keys})").affected
        torch.cuda.synchronize()
        rf2_s = time.perf_counter() - t0
        gone_l = remove("lineitem", lambda a: member(a["l_orderkey"], rf2))[0]
        gone_o = remove("orders", lambda a: member(a["o_orderkey"], rf2))[0]
        assert (n_o, n_l) == (gone_o, gone_l) == (RF_ORDERS, gone_l), (n_o, n_l, gone_o, gone_l)
        after_rf2 = counts_now()
        q1_q6(lists, "after_rf2")
        return {"partitions": lists, "rf1_s": rf1_s, "rf1_orders": RF_ORDERS, "rf1_lineitems": n_l1, "rf2_s": rf2_s,
                "rf2_orders": n_o, "rf2_lineitems": n_l,
                "rows_after_rf1": after_rf1, "rows_after_rf2": after_rf2}

    step("p3_routed_writes", p3)

    # --- P4: partition DDL ---
    def p4():
        lists = {}
        day = {y: int((np.datetime64(f"{y}-06-01") - np.datetime64("1970-01-01")).astype(int))
               for y in (1999, 2001)}
        t0 = time.perf_counter()
        for tbl in ("lineitem", "orders"):
            sess.execute(f"alter table {PDB}.{tbl} add partition (partition p1999 "
                         "values less than ('2000-01-01'))")
        add_s = time.perf_counter() - t0
        okey = int(max(rows["orders"]["o_orderkey"].max(), extra["orders"]["o_orderkey"].max())) + 1
        sess.execute(f"insert into {PDB}.orders (o_orderkey, o_custkey, o_orderstatus, "
                     f"o_totalprice, o_orderdate) values ({okey}, 1, 'O', 10.00, '1999-06-01')")
        sess.execute(f"insert into {PDB}.lineitem (l_orderkey, l_partkey, l_suppkey, l_linenumber, "
                     "l_quantity, l_extendedprice, l_discount, l_tax, l_returnflag, l_linestatus, "
                     f"l_shipdate) values ({okey}, 1, 1, 1, 1.00, 10.00, 0.05, 0.01, 'N', 'O', "
                     "'1999-06-01')")
        li_t = cat.table(PDB, "lineitem")
        add("orders", {"o_orderkey": [okey], "o_orderdate": [day[1999]]})
        add("lineitem", {
            "l_orderkey": [okey], "l_quantity": [100], "l_extendedprice": [1000],
            "l_discount": [5], "l_tax": [1], "l_shipdate": [day[1999]],
            "l_returnflag": [int(np.searchsorted(li_t.dictionaries["l_returnflag"], "N"))],
            "l_linestatus": [int(np.searchsorted(li_t.dictionaries["l_linestatus"], "O"))]})
        p99 = sess.execute(f"select table_name, table_rows from information_schema.partitions "
                           f"where table_schema = '{PDB}' and partition_name = 'p1999' "
                           "order by table_name").rows
        assert p99 == [("lineitem", 1), ("orders", 1)], p99
        (o99,) = [b for b in cat.table(PDB, "orders").blocks() if b.part_id == 7]
        assert o99.nrows == 1 and int(o99.columns["o_orderdate"].data[0]) == day[1999]
        lists["p1999"] = _explain_lists(
            sess, f"select count(*) from {PDB}.orders where o_orderdate >= '1999-01-01'")
        assert lists["p1999"] == ["[p1999]"], lists
        try:
            sess.execute(f"insert into {PDB}.orders (o_orderkey, o_custkey, o_orderstatus, "
                         f"o_totalprice, o_orderdate) values ({okey + 1}, 1, 'O', 1.00, "
                         "'2001-06-01')")
            raise AssertionError("a 2001 row was not refused")
        except ValueError as e:
            assert str(e) == f"Table has no partition for value {day[2001]}", str(e)
        # TRUNCATE lineitem's p1992, DROP orders' p1992; a stale reader
        # pinned just before the DROP keeps the old rows and defs
        t0 = time.perf_counter()
        sess.execute(f"alter table {PDB}.lineitem truncate partition p1992")
        truncate_s = time.perf_counter() - t0
        remove("lineitem", in_year("lineitem", 1992, first=True))
        before_drop = time.time()
        time.sleep(0.01)
        t0 = time.perf_counter()
        sess.execute(f"alter table {PDB}.orders drop partition p1992")
        drop_s = time.perf_counter() - t0
        old1992 = remove("orders", in_year("orders", 1992, first=True))[0]
        years = {"lineitem": all_years, "orders": all_years[1:]}
        counts_now(years)
        q1_q6(lists, "after_drop")
        stale = Session(cat, db=PDB)
        stale.execute(f"set tidb_snapshot = '{before_drop}'")
        q_old = "select count(*) from orders where o_orderdate < '1993-01-01'"
        stale_list = _explain_lists(stale, q_old)
        (n_old,) = stale.execute(q_old).rows[0]
        assert stale_list == ["[p1992]"] and n_old == old1992, (stale_list, n_old, old1992)
        stale.execute("set tidb_snapshot = ''")
        assert stale.execute(q_old).rows == [(0,)]
        lists["stale_1992"] = stale_list
        stale.close()
        # EXCHANGE lineitem's p1998 out to an empty archive, then back
        src = cat.table(PDB, "lineitem")
        cat.create_table(PDB, "lineitem_1998", TableSchema(list(src.schema.columns)))
        t0 = time.perf_counter()
        sess.execute(f"alter table {PDB}.lineitem exchange partition p1998 "
                     f"with table {PDB}.lineitem_1998")
        out_s = time.perf_counter() - t0
        n98, kept = remove("lineitem", in_year("lineitem", 1998))
        (got98,) = sess.execute(f"select count(*) from {PDB}.lineitem_1998").rows[0]
        assert got98 == n98, (got98, n98)
        counts_now(years)
        q1_q6(lists, "after_exchange_out")
        t0 = time.perf_counter()
        sess.execute(f"alter table {PDB}.lineitem exchange partition p1998 with table "
                     f"{PDB}.lineitem_1998 with validation")
        back_s = time.perf_counter() - t0
        add("lineitem", kept)
        assert sess.execute(f"select count(*) from {PDB}.lineitem_1998").rows == [(0,)]
        counts_now(years)
        q1_q6(lists, "after_exchange_back")
        scan.release(cat.table(PDB, "lineitem_1998"))
        sess.execute(f"drop table {PDB}.lineitem_1998")
        return {"partitions": lists, "add_s": add_s, "truncate_s": truncate_s,
                "drop_s": drop_s, "exchange_out_s": out_s, "exchange_back_s": back_s,
                "rows_1998": n98, "stale_rows_1992": n_old}

    step("p4_partition_ddl", p4)

    # --- P5: a sequence, a temporary table, a lock, a killed SLEEP ---
    def p5():
        sess.execute(f"create sequence {PDB}.s_ids")
        sess.execute(f"create table {PDB}.seq_rows (id bigint, v bigint)")
        t0 = time.perf_counter()
        res = sess.execute(f"insert into {PDB}.seq_rows values "
                           + ", ".join(f"(nextval({PDB}.s_ids), {i})" for i in range(1000)))
        seq_s = time.perf_counter() - t0
        assert res.affected == 1000
        assert sess.execute(f"select min(id), max(id), count(distinct id), sum(v) from "
                            f"{PDB}.seq_rows").rows == [(1, 1000, 1000, 499500)]
        assert sess.execute(f"select lastval({PDB}.s_ids)").rows == [(1000,)]
        q18 = O.TPCH_QUERIES["q18"]
        params = O.spec_params("q18", sf)
        t0 = time.perf_counter()
        res = sess.execute("create temporary table big as select l_orderkey, sum(l_quantity) "
                           "as qty from lineitem group by l_orderkey "
                           f"having sum(l_quantity) > {params['quantity']}")
        ctas_s = time.perf_counter() - t0
        inner = (f"select l_orderkey from lineitem group by l_orderkey having sum(l_quantity) > "
                 f"{params['quantity']}")
        sql = q18.sql.format(**params).replace(inner, "select l_orderkey from big")
        assert sql != q18.sql.format(**params)
        lists = {"q18_over_temp": _explain_lists(sess, sql)}
        assert lists["q18_over_temp"] == [], lists  # tpch and the temporary table
        t0 = time.perf_counter()
        got = sess.execute(sql)
        q18_s = time.perf_counter() - t0
        q18_cols = {"lineitem": ["l_orderkey", "l_quantity"],
                    "orders": ["o_orderkey", "o_custkey", "o_orderdate", "o_totalprice"],
                    "customer": ["c_custkey"]}
        ocat18 = oracle_catalog(cat, capture_arrays(cat, q18_cols))
        O.check_rows(got.rows, q18.oracle(ocat18, **params), q18.order, q18.limit)
        other = Session(cat, db="tpch")
        try:
            other.execute("select count(*) from big")
            raise AssertionError("a second session saw the temporary table")
        except ValueError as e:
            assert "unknown table" in str(e), str(e)
        assert "big" not in [r[0] for r in sess.execute("show tables").rows]
        assert sess.execute("select get_lock('p5_lock', 10)").rows == [(1,)]
        assert other.execute("select get_lock('p5_lock', 0)").rows == [(0,)]
        assert other.execute("select is_used_lock('p5_lock')").rows == [(sess.conn_id,)]
        assert sess.execute("select release_lock('p5_lock')").rows == [(1,)]
        # SLEEP(5) on the second session, KILLed from the first
        done = {}

        def sleeper():
            t2 = time.perf_counter()
            try:
                other.execute("select sleep(5)")
                done["error"] = None
            except Exception as e:  # the KILL's interruption
                done["error"] = f"{type(e).__name__}: {e}"
            done["t"] = time.perf_counter()
            done["slept_s"] = done["t"] - t2

        th = threading.Thread(target=sleeper)
        th.start()
        time.sleep(0.5)
        t_kill = time.perf_counter()
        sess.execute(f"kill query {other.conn_id}")
        th.join(timeout=10)
        assert not th.is_alive() and done["error"] is not None, done
        stop_s = done["t"] - t_kill
        assert stop_s <= 0.5, stop_s
        other.close()
        sess.execute("drop temporary table big")
        return {"partitions": lists, "sequence_insert_s": seq_s, "ctas_s": ctas_s, "ctas_rows": res.affected,
                "q18_over_temp_s": q18_s, "kill_to_stop_s": stop_s,
                "sleep_error": done["error"]}

    step("p5_session_objects", p5)

    for n in TABLES:
        scan.release(cat.table(PDB, n))
    sess.execute(f"drop database {PDB}")
    launches = dict(K.LAUNCHES)
    out["seconds"] = time.perf_counter() - t_phase
    out["launches"] = launches
    log(f"partitions: phase {out['seconds']:.1f}s of {PARTITION_LIMIT_S:g}, launches {launches}")
    return launches


def _check_q6_value(res, want: int) -> None:
    assert len(res.rows) == 1 and res.rows[0][0] == np.int64(want) / 10**4, res.rows


def _assert_rows(got, want) -> None:
    assert [tuple(r) for r in got] == [tuple(w) for w in want], (got, want)


def partitions_only(report) -> dict:
    """The SF10 tables, ANALYZEd, and the partition phase alone: the
    short loop for partition work. Returns the phase's launches."""
    from tidb_tpu_torch.bench import load_tpch
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage import Catalog

    t0 = time.perf_counter()
    cat = Catalog()
    load_tpch(cat, sf=SF, seed=1, tables=TABLES)
    sess = Session(cat, db="tpch")
    for t in TABLES:
        sess.execute(f"analyze table {t}")
    log(f"datagen and analyze: SF{SF:g} in {time.perf_counter() - t0:.1f}s")
    launches = partition_phase(cat, sess, report)
    for k, n in launches.items():
        assert n > 0, f"kernel {k} was not launched in the partition phase"
    return launches


# ---------------------------------------------------------------------------
# the load phase: bulk loads, their checks and expiry through Session
# ---------------------------------------------------------------------------

#: the load phase's time limit (seconds), oracles included
LOAD_LIMIT_S = 60.0
#: the database the load phase declares its tables in
LDB = "tpch_l"
#: orders_ttl's TTL: o_orderdate + INTERVAL 60 MONTH (a month is 30 days)
TTL_MONTHS = 60
#: the TTL sweep's "now": 1998-08-03 00:00 UTC, the day after TPC-H's
#: last order date
TTL_NOW_UNIX = float((np.datetime64("1998-08-03") - np.datetime64("1970-01-01")).astype(int)
                     * 86400)
#: threads of the phase's oracles and file writing, started with it
LOAD_ORACLE_THREADS = 4
#: lineitem columns the phase's Q1 and Q6 oracles read
Q1_Q6_COLUMNS = ["l_shipdate", "l_returnflag", "l_linestatus", "l_quantity",
                 "l_extendedprice", "l_discount", "l_tax"]
#: the segment report over the imported customers (25 nations x 5 segments)
SEGMENT_SQL = (f"select c_nationkey, c_mktsegment, count(*), sum(c_acctbal) from {LDB}.customer "
               "group by c_nationkey, c_mktsegment")
#: the kept orders' report after the TTL sweep (5 priorities)
PRIORITY_SQL = (f"select o_orderpriority, count(*), sum(o_totalprice) from {LDB}.orders_ttl "
                "group by o_orderpriority")


def load_ddl(cat) -> list:
    """tpch_l's DDL: customer (HASH-partitioned into 16, as P1 declares
    it) empty for IMPORT INTO; orders and lineitem with TPC-H's keys
    (lineitem's is (l_orderkey, l_linenumber), numbered as the
    specification numbers it: ``spec_linenumber``), FOREIGN KEYs and CHECKs;
    orders_ttl, orders' columns with a TTL."""
    def cols(name):
        return [f"{c} {_sql_type(ty)}" for c, ty in cat.table("tpch", name).schema.columns]

    fks = {"orders": [("o_custkey", f"{LDB}.customer", "c_custkey")],
           "lineitem": [("l_orderkey", f"{LDB}.orders", "o_orderkey"),
                        ("l_partkey", "tpch.part", "p_partkey"),
                        ("l_suppkey", "tpch.supplier", "s_suppkey")]}
    keys = {"customer": ["c_custkey"], "orders": ["o_orderkey"],
            "lineitem": ["l_orderkey", "l_linenumber"]}
    out = [f"create database {LDB}"]
    for name in ("customer", "orders", "lineitem"):
        parts = cols(name) + ["primary key (" + ", ".join(keys[name]) + ")"]
        parts += [f"constraint {c}_fk foreign key ({c}) references {ref} ({rc})"
                  for c, ref, rc in fks.get(name, ())]
        parts += [f"constraint {n} check ({e})" for n, e in TPCH_CHECKS.get(name, ())]
        clause = (f" partition by hash (c_custkey) partitions {CUSTOMER_BUCKETS}"
                  if name == "customer" else "")
        out.append(f"create table {LDB}.{name} (" + ", ".join(parts) + ")" + clause)
    out.append(f"create table {LDB}.orders_ttl (" + ", ".join(cols("orders"))
               + ", primary key (o_orderkey)) ttl = o_orderdate + interval "
               f"{TTL_MONTHS} month")
    return out


def write_tbl(path, schema_cols, cols, dicts=None) -> int:
    """Rows as dbgen writes a .tbl file: each field by its kind (a
    DECIMAL's scaled integer with its point, a DATE as yyyy-mm-dd, a
    string's value), each line ending in '|'; a column missing from
    `cols` is an empty field (NULL). Strings are str objects, or codes
    into `dicts[column]`. Returns the bytes written."""
    from tidb_tpu_torch.dtypes import Kind

    n = len(next(iter(cols.values())))
    fields = []
    for c, typ in schema_cols:
        v = cols.get(c)
        if v is None:
            fields.append([""] * n)
        elif typ.kind == Kind.STRING:
            d = (dicts or {}).get(c)
            vals = np.asarray(d, dtype=object)[v] if d is not None else np.asarray(v, dtype=object)
            fields.append(list(map(str, vals.tolist())))
        elif typ.kind == Kind.DECIMAL:
            s = 10 ** typ.scale
            a = np.abs(v.astype(np.int64))
            frac = np.array([f"{i:0{typ.scale}d}" for i in range(s)])[a % s]
            fields.append(np.char.add(np.char.add(np.char.add(
                np.where(v < 0, "-", ""), (a // s).astype(str)), "."), frac).tolist())
        elif typ.kind == Kind.DATE:
            fields.append(np.datetime_as_string(v.astype("datetime64[D]")).tolist())
        else:
            fields.append(list(map(str, v.tolist())))
    text = "|\n".join(map("|".join, zip(*fields))) + "|\n"
    assert text.count("|") == n * len(schema_cols), "a field holds the separator"
    with open(path, "w", encoding="utf-8") as f:
        f.write(text)
    return len(text.encode())


def spec_linenumber(orderkey, device):
    """l_linenumber by TPC-H clause 4.2.3: 1, 2, ... within each order, in
    row order, so that (l_orderkey, l_linenumber) is a key (bench/tpch.py
    draws the two independently). One stable sort on `device`."""
    import torch

    k = torch.from_numpy(orderkey).to(device)
    perm = torch.sort(k, stable=True).indices
    sk = k[perm]
    idx = torch.arange(len(sk), device=device)
    start = torch.ones(len(sk), dtype=torch.bool, device=device)
    start[1:] = sk[1:] != sk[:-1]
    first = torch.cummax(torch.where(start, idx, torch.zeros_like(idx)), 0).values
    num = torch.empty_like(idx)
    num[perm] = idx - first + 1
    return num.cpu().numpy()


def load_phase(cat, sess, report) -> dict:
    """The load phase over the SF10 tables, in database tpch_l. L1
    declares customer (empty, HASH-partitioned), orders and lineitem with
    TPC-H's keys, FOREIGN KEYs and CHECKs over the tpch tables' blocks,
    and orders_ttl with a TTL; L2 writes customer.tbl as dbgen does and
    runs IMPORT INTO (the DXF, four executors), Lightning's ADMIN CHECKSUM
    against tpch.customer, ADMIN CHECK and a segment report; L3 LOADs
    RF1's orders and line items from .tbl files through the constrained
    path, then Q1 and Q6, and has a CHECK violation and a short line
    refused; L4 runs ADMIN CHECK TABLE over orders and lineitem, ADMIN
    CHECK INDEX, CHECK TABLE and ADMIN SHOW DDL JOBS; L5 sweeps orders_ttl
    with the TTL worker; L6 ticks the auto-analyze worker and starts and
    stops a server with both workers. Every result is checked against
    numpy; each step prints its seconds, its statements' seconds,
    host->device bytes and kernel launches. The files go under
    tempfile.gettempdir(); the database is dropped at the end. Returns
    the phase's launches."""
    import shutil
    import tempfile

    import torch

    from tidb_tpu_torch.bench import oracles as O
    from tidb_tpu_torch.chunk import TRANSFERS, HostBlock, HostColumn
    from tidb_tpu_torch.executor import kernels as K
    from tidb_tpu_torch.server import Server
    from tidb_tpu_torch.stats.handle import StatsHandle, needs_analyze
    from tidb_tpu_torch.storage import scan
    from tidb_tpu_torch.utils.ttl import TTLWorker

    out = report["loads"] = {}
    t_phase = time.perf_counter()
    log(f"loads: card {card_line()}")
    K.reset_launches()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_load_", dir=tempfile.gettempdir())

    def step(name, fn):
        """Run fn, recording under `name` its seconds, its statements'
        seconds alone (``stmt_s``), host->device bytes, launches and what
        fn returns."""
        stmt = {"s": 0.0, "depth": 0}

        def timed(f):
            def run(*a, **kw):
                stmt["depth"] += 1
                t2 = time.perf_counter()
                try:
                    return f(*a, **kw)
                finally:
                    torch.cuda.synchronize()
                    stmt["depth"] -= 1
                    if not stmt["depth"]:
                        stmt["s"] += time.perf_counter() - t2
            return run

        torch.cuda.synchronize()
        h0, t1, l0 = TRANSFERS["h2d_bytes"], time.perf_counter(), dict(K.LAUNCHES)
        sess.execute = timed(sess.execute)
        try:
            extra = fn() or {}
        finally:
            del sess.execute
        torch.cuda.synchronize()
        out[name] = {"s": time.perf_counter() - t1, "stmt_s": stmt["s"],
                     "h2d_bytes": TRANSFERS["h2d_bytes"] - h0,
                     "launches": {k: K.LAUNCHES[k] - l0[k] for k in K.LAUNCHES}, **extra}
        log(f"loads {name}: " + json.dumps(out[name]))

    def refused(sql, want):
        try:
            sess.execute(sql)
        except ValueError as e:
            assert str(e) == want, (sql[:80], str(e), want)
            return
        raise AssertionError(f"not refused: {sql[:80]}")

    def one(sql):
        (row,) = sess.execute(sql).rows
        return row

    # the rows the phase starts from, its oracles and its files: on
    # threads from the start, beside L1
    arr = capture_arrays(cat, {
        "lineitem": Q1_Q6_COLUMNS,
        "orders": ["o_orderdate", "o_orderpriority", "o_totalprice"],
        "customer": ["c_nationkey", "c_mktsegment", "c_acctbal"]})
    cust_t = cat.table("tpch", "customer")
    cust_cols = {c: np.concatenate([b.columns[c].data for b in cust_t.blocks()])
                 for c in cust_t.schema.names}
    paths = {n: os.path.join(tmp, f"{n}.tbl") for n in ("customer", "orders", "lineitem")}
    rf1 = rf1_data(cat, np.random.default_rng(29), SF, RF_ORDERS, 0)
    rf1["lineitem"]["l_receiptdate"] = spec_receiptdate(rf1["lineitem"]["l_shipdate"],
                                                        rf1["lineitem"]["l_receiptdate"])
    pool = ThreadPoolExecutor(LOAD_ORACLE_THREADS)
    fut = {
        "q1": pool.submit(O.numpy_q1, arr["lineitem"]),
        "q6": pool.submit(O.numpy_q6, arr["lineitem"]),
        "customer.tbl": pool.submit(write_tbl, paths["customer"], cust_t.schema.columns,
                                    cust_cols, cust_t.dictionaries),
        "rf1.tbl": pool.submit(lambda: {n: write_tbl(paths[n], cat.table("tpch", n).schema.columns,
                                                     rf1[n]) for n in ("orders", "lineitem")}),
    }

    # --- L1: declare ---
    def l1():
        for sql in load_ddl(cat):
            sess.execute(sql)
        src_li = cat.table("tpch", "lineitem").blocks()
        linenumber = spec_linenumber(np.concatenate(
            [b.columns["l_orderkey"].data for b in src_li]), sess.device)
        for name, dst in (("orders", "orders"), ("lineitem", "lineitem"),
                          ("orders", "orders_ttl")):
            src, t = cat.table("tpch", name), cat.table(LDB, dst)
            blocks, off = [], 0
            for b in src.blocks():
                cols = dict(b.columns)  # a block of its own over the same arrays
                if name == "lineitem":
                    c = cols["l_receiptdate"]
                    cols["l_receiptdate"] = HostColumn(c.type, spec_receiptdate(
                        cols["l_shipdate"].data, c.data), c.valid, c.dictionary)
                    c = cols["l_linenumber"]
                    cols["l_linenumber"] = HostColumn(
                        c.type, linenumber[off: off + b.nrows].astype(c.data.dtype), c.valid)
                    off += b.nrows
                blocks.append(HostBlock(cols, b.nrows))
            t.dictionaries.update(src.dictionaries)
            t.replace_blocks(blocks)
        rows = {n: cat.table(LDB, n).nrows for n in ("customer", "orders", "lineitem", "orders_ttl")}
        assert rows["customer"] == 0 and rows["orders"] == rows["orders_ttl"] == len(
            arr["orders"]["o_orderdate"]) and rows["lineitem"] == len(arr["lineitem"]["l_tax"]), rows
        return {"rows": rows}

    step("l1_declare", l1)

    # --- L2: IMPORT INTO customer, and Lightning's checks after it ---
    def l2():
        nbytes = fut["customer.tbl"].result()
        t0 = time.perf_counter()
        res = sess.execute(f"import into {LDB}.customer from '{paths['customer']}' "
                           "fields terminated by '|'")
        import_s = time.perf_counter() - t0
        n = len(cust_cols["c_custkey"])
        assert res.affected == n, (res.affected, n)
        t0 = time.perf_counter()
        sums = sess.execute(f"admin checksum table tpch.customer, {LDB}.customer").rows
        checksum_s = time.perf_counter() - t0
        assert sums[0][2:4] == sums[1][2:4] and sums[0][3] == n, sums
        t0 = time.perf_counter()
        assert sess.execute(f"admin check table {LDB}.customer").rows == []
        check_s = time.perf_counter() - t0
        t = cat.table(LDB, "customer")
        parts = sorted({b.part_id for b in t.blocks()})
        assert parts == list(range(CUSTOMER_BUCKETS)), parts
        # the segment report over the import, against numpy over tpch's rows
        c, d = arr["customer"], cat.table("tpch", "customer").dictionaries["c_mktsegment"]
        g = c["c_nationkey"].astype(np.int64) * len(d) + c["c_mktsegment"]
        cnt = np.bincount(g, minlength=25 * len(d))
        tot = np.zeros(len(cnt), dtype=np.int64)
        np.add.at(tot, g, c["c_acctbal"].astype(np.int64))
        want = {(int(k) // len(d), str(d[int(k) % len(d)])): (int(cnt[k]), int(tot[k]))
                for k in np.flatnonzero(cnt)}
        rows = sess.execute(SEGMENT_SQL).rows
        got = {(int(r[0]), r[1]): (int(r[2]), round(float(r[3]) * 100)) for r in rows}
        assert len(rows) == len(want) == 125 and got == want, (len(rows), len(want))
        return {"file_bytes": nbytes, "rows": n, "import_s": import_s,
                "rows_per_s": n / import_s, "checksum_s": checksum_s,
                "checksum": sums[0][2], "check_s": check_s, "blocks": len(t.blocks()),
                "groups": len(rows)}

    step("l2_import", l2)

    # --- L3: LOAD DATA of RF1's orders and line items ---
    def l3():
        files = fut["rf1.tbl"].result()
        o_t, l_t = cat.table(LDB, "orders"), cat.table(LDB, "lineitem")
        n0 = {"orders": o_t.nrows, "lineitem": l_t.nrows}
        secs = {}
        for name in ("orders", "lineitem"):
            t0 = time.perf_counter()
            res = sess.execute(f"load data infile '{paths[name]}' into table {LDB}.{name} "
                               "fields terminated by '|'")
            secs[name] = time.perf_counter() - t0
            want = len(rf1[name]["o_orderkey" if name == "orders" else "l_orderkey"])
            assert res.affected == want and cat.table(LDB, name).nrows == n0[name] + want, (
                name, res.affected, want)
        # Q1 and Q6 over tpch_l against the oracles plus the loaded rows
        new = {c: rf1["lineitem"][c] for c in Q1_Q6_COLUMNS}
        for c in ("l_returnflag", "l_linestatus"):
            new[c] = np.searchsorted(l_t.dictionaries[c], new[c])
        d1, q1 = O.numpy_q1(new), dict(fut["q1"].result())
        for k in ("sum_qty", "sum_base", "sum_disc", "sum_charge", "sum_disc_rate", "cnt"):
            q1[k] = q1[k] + d1[k]
        den = np.maximum(q1["cnt"], 1)
        q1.update(avg_qty=q1["sum_qty"] / den, avg_base=q1["sum_base"] / den,
                  avg_disc=q1["sum_disc_rate"] / den)
        sess.execute(f"use {LDB}")
        try:
            t0 = time.perf_counter()
            check_q1(sess.execute(O.Q1_SQL), q1, l_t)
            _check_q6_value(sess.execute(O.Q6_SQL), fut["q6"].result() + O.numpy_q6(new))
            q_s = time.perf_counter() - t0
        finally:
            sess.execute("use tpch")
        # a CHECK violation and a short line: refused with the JAX texts,
        # the counts unchanged
        key = int(rf1["lineitem"]["l_orderkey"][0])
        bad = os.path.join(tmp, "bad_check.tbl")
        write_tbl(bad, l_t.schema.columns, {
            "l_orderkey": np.array([key]), "l_partkey": rf1["lineitem"]["l_partkey"][:1],
            "l_suppkey": rf1["lineitem"]["l_suppkey"][:1], "l_linenumber": np.array([8]),
            "l_quantity": np.array([-100]), "l_extendedprice": np.array([100]),
            "l_discount": np.array([0]), "l_tax": np.array([0]),
            "l_shipdate": np.array([9000]), "l_commitdate": np.array([9000]),
            "l_receiptdate": np.array([9001])})
        short = os.path.join(tmp, "short.tbl")
        with open(short, "w") as f:
            f.write("|".join(["1"] * (len(l_t.schema.columns) - 1)) + "\n")
        before = l_t.nrows
        t0 = time.perf_counter()
        refused(f"load data infile '{bad}' into table {LDB}.lineitem fields terminated by '|'",
                "CHECK constraint 'l_qty_nonneg' violated")
        refused(f"load data infile '{short}' into table {LDB}.lineitem fields terminated by '|'",
                f"row has {len(l_t.schema.columns) - 1} fields, table lineitem has "
                f"{len(l_t.schema.columns)}")
        refuse_s = time.perf_counter() - t0
        assert one(f"select count(*) from {LDB}.lineitem") == (before,)
        return {"file_bytes": files, "load_s": secs, "q1_q6_s": q_s, "refusals_s": refuse_s,
                "rows": {"orders": o_t.nrows, "lineitem": l_t.nrows}}

    step("l3_load_data", l3)

    # --- L4: ADMIN CHECK at SF10 ---
    def l4():
        secs = {}
        for what, sql, want in (
                ("check_table", f"admin check table {LDB}.orders, {LDB}.lineitem", []),
                ("check_index", f"admin check index {LDB}.lineitem primary", []),
                ("check_table_status", f"check table {LDB}.lineitem",
                 [(f"{LDB}.lineitem", "check", "status", "OK")]),
                ("show_ddl", "admin show ddl jobs", None)):
            t0 = time.perf_counter()
            rows = sess.execute(sql).rows
            torch.cuda.synchronize()
            secs[what] = time.perf_counter() - t0
            if want is not None:
                assert rows == want, (sql, rows)
            else:
                assert len(rows) == 1 and rows[0][1] == "", rows
        return {"s_each": secs}

    step("l4_admin_check", l4)

    # --- L5: TTL ---
    def l5():
        t = cat.table(LDB, "orders_ttl")
        cutoff = int((TTL_NOW_UNIX - TTL_MONTHS * 30 * 86400) // 86400)
        o = arr["orders"]
        expired = o["o_orderdate"] < cutoff
        t0 = time.perf_counter()
        removed = TTLWorker(cat).tick(now_unix=TTL_NOW_UNIX)
        sweep_s = time.perf_counter() - t0
        assert removed == int(expired.sum()) and t.nrows == int((~expired).sum()), (
            removed, int(expired.sum()))
        assert TTLWorker(cat).tick(now_unix=TTL_NOW_UNIX) == 0
        d = cat.table("tpch", "orders").dictionaries["o_orderpriority"]
        keep = ~expired
        cnt = np.bincount(o["o_orderpriority"][keep], minlength=len(d))
        tot = np.zeros(len(d), dtype=np.int64)
        np.add.at(tot, o["o_orderpriority"][keep], o["o_totalprice"][keep].astype(np.int64))
        want = {str(d[k]): (int(cnt[k]), int(tot[k])) for k in np.flatnonzero(cnt)}
        rows = sess.execute(PRIORITY_SQL).rows
        got = {r[0]: (int(r[1]), round(float(r[2]) * 100)) for r in rows}
        assert len(rows) == 5 and got == want, (got, want)
        ddl = one(f"show create table {LDB}.orders_ttl")[1]
        assert ddl.endswith(f") ttl = o_orderdate + interval {TTL_MONTHS} month"), ddl
        return {"removed": removed, "kept": int(keep.sum()), "sweep_s": sweep_s,
                "cutoff": present_date(cutoff)}

    step("l5_ttl", l5)

    # --- L6: the background workers ---
    def l6():
        g = cat.global_sysvars
        ratio = float(g.get("tidb_auto_analyze_ratio") or 0.5)
        pending = [(db, name) for db in cat.databases()
                   if not db.startswith("_") and db != "information_schema"
                   for name in cat.tables(db) if needs_analyze(cat.table(db, name), ratio)]
        assert {(LDB, "customer"), (LDB, "orders_ttl")} <= set(pending), pending
        t0 = time.perf_counter()
        n = StatsHandle(cat).tick()
        tick_s = time.perf_counter() - t0
        assert n == len(pending), (n, pending)
        t0 = time.perf_counter()
        for db, name in pending:
            t = cat.table(db, name)
            assert t.analyzed_modify == t.modify_count, (db, name)
            got = dict(t.stats)
            sess.execute(f"analyze table {db}.{name}")
            for c, st in t.stats.items():
                a = got[c]
                assert (a.row_count, a.null_count, a.ndv, a.topn, a.min_val, a.max_val) == (
                    st.row_count, st.null_count, st.ndv, st.topn, st.min_val, st.max_val), (
                    db, name, c)
                assert np.array_equal(a.bounds, st.bounds), (db, name, c)
        analyze_s = time.perf_counter() - t0
        srv = Server(cat, port=0)
        th = srv.start_background()
        try:
            for _ in range(500):
                if srv.stats_handle._thread is not None and srv.ttl_worker._thread is not None:
                    break
                time.sleep(0.01)
            workers = [srv.stats_handle._thread, srv.ttl_worker._thread]
            assert all(w is not None and w.is_alive() for w in workers), workers
        finally:
            srv.shutdown()
            th.join(timeout=10)
        assert not th.is_alive() and not any(w.is_alive() for w in workers)
        return {"analyzed": [f"{db}.{name}" for db, name in pending], "tick_s": tick_s,
                "explicit_analyze_s": analyze_s}

    step("l6_workers", l6)

    pool.shutdown()
    for name in cat.tables(LDB):
        scan.release(cat.table(LDB, name))
    sess.execute(f"drop database {LDB}")
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    out["phase_s"] = time.perf_counter() - t_phase
    out["launches"] = dict(K.LAUNCHES)
    log(f"loads: phase {out['phase_s']:.1f}s of {LOAD_LIMIT_S:.0f}s, launches "
        + json.dumps(out["launches"]))
    return dict(K.LAUNCHES)


def loads_only(report) -> dict:
    """The SF10 tables, ANALYZEd, and the load phase alone: the short loop
    for load work. Returns the phase's launches."""
    from tidb_tpu_torch.bench import load_tpch
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage import Catalog

    t0 = time.perf_counter()
    cat = Catalog()
    load_tpch(cat, sf=SF, seed=1, tables=TABLES)
    sess = Session(cat, db="tpch")
    for t in TABLES:
        sess.execute(f"analyze table {t}")
    log(f"datagen and analyze: SF{SF:g} in {time.perf_counter() - t0:.1f}s")
    launches = load_phase(cat, sess, report)
    for k, n in launches.items():
        assert n > 0, f"kernel {k} was not launched in the load phase"
    return launches


#: the durability phase's time limit (seconds)
DURABILITY_LIMIT_S = 60.0
#: the database the durability phase declares its tables in
DDB = "tpch_d"
#: the SF10 tables it backs up, parents before children. A cut of scale:
#: BACKUP deflates on the host (np.savez_compressed, the JAX package's
#: format), ~12 s for customer's 1.5M rows, and the whole SF10 database
#: (86.6M rows) would take minutes
DURABILITY_TABLES = ["region", "nation", "supplier", "customer"]
#: rows of the TTL table ev, every ts after the run's clock
EV_ROWS = 100_000
#: D3's writes over the wire: new customers, balances raised by 1.00,
#: the nation whose suppliers leave supplier_p
D3_NEW_CUSTOMERS = 1000
D3_UPDATED = 1000
D3_DELETED_NATION = 3
#: supplier_p's RANGE bounds over s_nationkey (five partitions, the last
#: MAXVALUE)
SUPPLIER_P_BOUNDS = [5, 10, 15, 20]
#: the read whose EXPLAIN shows supplier_p's pruning
SUPPLIER_P_PRUNED_SQL = f"select count(*), sum(s_acctbal) from {DDB}.supplier_p where s_nationkey < 5"
#: D3's segment report (5 groups) and D4's report (25 nations x 5 segments)
DURABILITY_SEGMENT_SQL = (f"select c_mktsegment, count(*), sum(c_acctbal) from {DDB}.customer "
                          "group by c_mktsegment")
DURABILITY_REPORT_SQL = (f"select c_nationkey, c_mktsegment, count(*), sum(c_acctbal) "
                         f"from {DDB}.customer group by c_nationkey, c_mktsegment")
#: the SLEEP the watchdog ends in D5 (seconds)
D5_SLEEP_S = 30

#: D3's MySQL client in a process of its own, started beside the binary:
#: argv a file the server's port will be written to, then a JSON list of
#: [kind, key, sql] ("query" or "write"); it imports while the binary
#: boots, waits for the port, runs the list and prints the results and
#: its seconds from the port's arrival as JSON
DURABILITY_CLIENT = """
import json, os, sys, time
sys.path.insert(0, {root!r})
import chip_smoke
from tidb_tpu_torch.server import protocol  # noqa: F401 (MysqlWire's import, before the wait)
deadline = time.monotonic() + 600
while not os.path.exists(sys.argv[1]):
    if time.monotonic() > deadline:
        sys.exit("no port")
    time.sleep(0.05)
t0 = time.perf_counter()
with open(sys.argv[1]) as f:
    port = int(f.read())
c = chip_smoke.MysqlWire(port, db={db!r})
out = {{}}
for kind, key, sql in json.loads(sys.argv[2]):
    if kind == "query":
        _cols, rows, secs = c.query(sql)
        out[key] = {{"rows": rows, "s": secs}}
    else:
        affected, _last, secs = c.write(sql)
        out[key] = {{"affected": affected, "s": secs}}
c.close()
out["client_s"] = time.perf_counter() - t0
print(json.dumps(out))
"""


def durability_ddl(cat) -> list:
    """tpch_d's DDL: region, nation, supplier and customer with TPC-H's
    primary keys and their FOREIGN KEYs (each *_nationkey to nation,
    n_regionkey to region), a CHECK on s_acctbal; supplier_p, supplier's
    columns RANGE-partitioned by s_nationkey into five; ev with a TTL; a
    view over customer; a sequence; and the user br_reader, who may read
    tpch_d."""
    out = [f"create database {DDB}"]
    for name in DURABILITY_TABLES:
        t = cat.table("tpch", name)
        parts = [f"{c} {_sql_type(ty)}" for c, ty in t.schema.columns]
        parts.append("primary key (" + ", ".join(t.schema.primary_key) + ")")
        parts += [f"constraint {col}_fk foreign key ({col}) references {parent} ({pcol})"
                  for tbl, col, parent, pcol, _act in TPCH_FKS
                  if tbl == name and parent in DURABILITY_TABLES]
        if name == "supplier":
            parts.append("constraint s_acctbal_floor check (s_acctbal >= -999.99)")
        out.append(f"create table {DDB}.{name} (" + ", ".join(parts) + ")")
    cols = ", ".join(f"{c} {_sql_type(ty)}" for c, ty in cat.table("tpch", "supplier").schema.columns)
    parts = [f"partition p{i} values less than ({b})" for i, b in enumerate(SUPPLIER_P_BOUNDS)]
    parts.append(f"partition p{len(SUPPLIER_P_BOUNDS)} values less than maxvalue")
    out.append(f"create table {DDB}.supplier_p ({cols}) partition by range (s_nationkey) ("
               + ", ".join(parts) + ")")
    out.append(f"create table {DDB}.ev (id bigint primary key, ts datetime) "
               "ttl = ts + interval 90 day")
    out.append(f"create view {DDB}.rich as select c_custkey, c_nationkey, c_acctbal "
               f"from {DDB}.customer where c_acctbal > 9000")
    out.append(f"create sequence {DDB}.seq")
    out.append("create user br_reader")
    out.append(f"grant select on {DDB}.* to br_reader")
    return out


def new_customers_sql(cat, n: int, first_key: int) -> tuple:
    """INSERT of `n` customers with keys from `first_key`, and their
    (c_custkey, c_nationkey, c_mktsegment code, c_acctbal in cents)."""
    from tidb_tpu_torch.dtypes import Kind

    t = cat.table("tpch", "customer")
    segments = list(t.dictionaries["c_mktsegment"])
    i = np.arange(n, dtype=np.int64)
    key, nation, seg, cents = first_key + i, i % 25, i % len(segments), (i * 7919) % 1_000_000
    rows = []
    for j in range(n):
        vals = []
        for c, ty in t.schema.columns:
            if c == "c_custkey":
                vals.append(str(int(key[j])))
            elif c == "c_nationkey":
                vals.append(str(int(nation[j])))
            elif c == "c_acctbal":
                vals.append(f"{int(cents[j]) // 100}.{int(cents[j]) % 100:02d}")
            elif c == "c_mktsegment":
                vals.append(f"'{segments[seg[j]]}'")
            elif ty.kind == Kind.STRING:
                vals.append(f"'d3 {c} {j}'")
            else:
                vals.append(str(j))
        rows.append("(" + ", ".join(vals) + ")")
    sql = "insert into customer values " + ", ".join(rows)
    return sql, {"c_custkey": key, "c_nationkey": nation, "c_mktsegment": seg, "c_acctbal": cents}


def meminfo_total() -> int:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                return int(line.split()[1]) * 1024
    return 0


def durability_phase(cat, sess, report) -> dict:
    """The durability phase over the SF10 tables, in database tpch_d. D1
    declares region, nation, supplier and customer with TPC-H's keys and
    FOREIGN KEYs over the tpch tables' blocks, a CHECK, supplier_p (RANGE
    by s_nationkey into five), ev (100,000 rows from the seed, every ts
    after the run's clock, TTL 90 days), a view, a sequence and a user,
    then BACKs the database UP; D2 backs it up into a second directory
    with persist/backup-table armed to fail at its second table (the
    statement fails, checkpoint.json stays), then again (only the tables
    not checkpointed are written); D3 boots the server binary over D1's
    directory (--path, --config, --status-port, TIDB_TPU_RACECHECK=1),
    reads the status API, has a client in another process run the segment
    report, an INSERT of 1,000 customers, an UPDATE of 1,000 balances, a
    DELETE from supplier_p and two NEXTVALs, and SIGTERMs it: the binary
    snapshots and exits 0. D2 runs on a thread of its own beside D3 (the
    binary is another process). D4 RESTOREs D1's directory, which now
    holds D3's writes, over the live tpch_d, and checks it against numpy
    and the state D1 declared; D5 has the instance watchdog end a
    SLEEP(30) at a server memory limit below the process's RSS. Every
    result is checked; each step prints its seconds, its statements'
    seconds, the bytes written or read, host->device bytes and kernel
    launches. The directories go under tempfile.gettempdir() and are
    removed; the database is dropped at the end. Returns the phase's
    launches."""
    import shutil
    import tempfile
    import urllib.error
    import urllib.request

    import torch

    from tidb_tpu_torch.chunk import TRANSFERS, HostBlock, HostColumn
    from tidb_tpu_torch.executor import kernels as K
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage import scan
    from tidb_tpu_torch.utils import failpoint
    from tidb_tpu_torch.utils.sqlkiller import QueryKilled
    from tidb_tpu_torch.utils.watchdog import host_memory as wd_host_memory

    out = report["durability"] = {}
    t_phase = time.perf_counter()
    mem_total = meminfo_total()
    log(f"durability: card {card_line()}, host MemTotal {mem_total} B")
    K.reset_launches()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_br_", dir=tempfile.gettempdir())
    bk, bk2 = os.path.join(tmp, "backup"), os.path.join(tmp, "backup2")

    def dir_bytes(path):
        return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))

    def step(name, fn):
        """Run fn, recording under `name` its seconds, its statements'
        seconds alone (``stmt_s``), host->device bytes, launches and what
        fn returns."""
        stmt = {"s": 0.0, "depth": 0}

        def timed(f):
            def run(*a, **kw):
                stmt["depth"] += 1
                t2 = time.perf_counter()
                try:
                    return f(*a, **kw)
                finally:
                    torch.cuda.synchronize()
                    stmt["depth"] -= 1
                    if not stmt["depth"]:
                        stmt["s"] += time.perf_counter() - t2
            return run

        torch.cuda.synchronize()
        h0, t1, l0 = TRANSFERS["h2d_bytes"], time.perf_counter(), dict(K.LAUNCHES)
        sess.execute = timed(sess.execute)
        try:
            extra = fn() or {}
        finally:
            del sess.execute
        torch.cuda.synchronize()
        out[name] = {"s": time.perf_counter() - t1, "stmt_s": stmt["s"],
                     "h2d_bytes": TRANSFERS["h2d_bytes"] - h0,
                     "launches": {k: K.LAUNCHES[k] - l0[k] for k in K.LAUNCHES}, **extra}
        log(f"durability {name}: " + json.dumps(out[name]))

    def one(sql):
        (row,) = sess.execute(sql).rows
        return row

    arr = capture_arrays(cat, {"customer": ["c_custkey", "c_nationkey", "c_mktsegment",
                                            "c_acctbal"],
                               "supplier": ["s_nationkey"]})
    seg_dict = cat.table("tpch", "customer").dictionaries["c_mktsegment"]

    def report_want(c, by_nation: bool):
        g = c["c_mktsegment"].astype(np.int64)
        if by_nation:
            g = c["c_nationkey"].astype(np.int64) * len(seg_dict) + g
        size = (25 if by_nation else 1) * len(seg_dict)
        cnt = np.bincount(g, minlength=size)
        tot = np.zeros(size, dtype=np.int64)
        np.add.at(tot, g, c["c_acctbal"].astype(np.int64))
        key = ((lambda k: (k // len(seg_dict), str(seg_dict[k % len(seg_dict)]))) if by_nation
               else (lambda k: str(seg_dict[k])))
        return {key(k): (int(cnt[k]), int(tot[k])) for k in np.flatnonzero(cnt)}

    def report_got(rows, by_nation: bool):
        return {((int(r[0]), r[1]) if by_nation else r[0]):
                (int(r[-2]), round(float(r[-1]) * 100)) for r in rows}

    now_us = int(time.time() * 1e6)

    # --- D1: declare and BACKUP ---
    def d1():
        for sql in durability_ddl(cat):
            sess.execute(sql)
        for name in DURABILITY_TABLES:
            src, dst = cat.table("tpch", name), cat.table(DDB, name)
            dst.dictionaries.update(src.dictionaries)
            # blocks of their own over the same arrays
            dst.replace_blocks([HostBlock(dict(b.columns), b.nrows, part_id=b.part_id)
                                for b in src.blocks()])
        n_sp = sess.execute(f"insert into {DDB}.supplier_p select * from {DDB}.supplier").affected
        assert n_sp == len(arr["supplier"]["s_nationkey"]), n_sp
        rng = np.random.default_rng(18)
        ev = cat.table(DDB, "ev")
        ts = now_us + 86_400_000_000 + rng.integers(0, 365 * 86_400_000_000, EV_ROWS)
        ones = np.ones(EV_ROWS, dtype=bool)
        ev.append_block(HostBlock.from_columns({
            "id": HostColumn(ev.schema.types["id"], np.arange(1, EV_ROWS + 1, dtype=np.int64), ones),
            "ts": HostColumn(ev.schema.types["ts"], ts.astype(np.int64), ones)}))
        assert one(f"select nextval({DDB}.seq)") == (1,)
        pruned = _explain_lists(sess, SUPPLIER_P_PRUNED_SQL)
        assert pruned == ["[p0]"], pruned
        got = report_got(sess.execute(DURABILITY_SEGMENT_SQL).rows, False)
        assert got == report_want(arr["customer"], False), got
        t0 = time.perf_counter()
        sess.execute(f"backup database {DDB} to '{bk}'")
        backup_s = time.perf_counter() - t0
        nbytes = dir_bytes(bk)
        files = sorted(os.listdir(bk))
        assert files == sorted([f"{DDB}.{n}.npz" for n in cat.tables(DDB)] + ["manifest.json"]), files
        rows = {n: cat.table(DDB, n).nrows for n in cat.tables(DDB)}
        return {"rows": rows, "backup_s": backup_s, "bytes_written": nbytes,
                "mb_per_s": nbytes / backup_s / 1e6, "pruned": pruned}

    step("d1_declare_backup", d1)

    # --- D2 (on a thread, beside D3): an interrupted BACKUP resumes ---
    d2_out = {}

    def d2():
        s2 = Session(cat, db=DDB)
        t0 = time.perf_counter()
        failpoint.enable("persist/backup-table",
                         failpoint.after_n(2, failpoint.FailpointError))
        try:
            try:
                s2.execute(f"backup database {DDB} to '{bk2}'")
                raise AssertionError("the armed BACKUP did not fail")
            except failpoint.FailpointError as e:
                d2_out["error"] = str(e)
        finally:
            failpoint.disable("persist/backup-table")
        failed_s = time.perf_counter() - t0
        assert os.path.exists(os.path.join(bk2, "checkpoint.json"))
        before = {f: os.stat(os.path.join(bk2, f)).st_mtime_ns
                  for f in os.listdir(bk2) if f.endswith(".npz")}
        t0 = time.perf_counter()
        s2.execute(f"backup database {DDB} to '{bk2}'")
        resume_s = time.perf_counter() - t0
        after = {f: os.stat(os.path.join(bk2, f)).st_mtime_ns
                 for f in os.listdir(bk2) if f.endswith(".npz")}
        rewritten = sorted(f for f in after if before.get(f) != after[f])
        assert not os.path.exists(os.path.join(bk2, "checkpoint.json"))
        assert sorted(before) == [f"{DDB}.customer.npz"], before
        assert rewritten == sorted(set(after) - set(before)) and len(after) == len(
            cat.tables(DDB)), (rewritten, after)
        d2_out.update({"failed_s": failed_s, "checkpointed": sorted(before),
                       "resume_s": resume_s, "rewritten": rewritten,
                       "bytes_written": dir_bytes(bk2)})

    d2_err = []

    def d2_thread():
        t0 = time.perf_counter()
        try:
            d2()
        except BaseException as e:  # re-raised on the phase's thread
            d2_err.append(e)
        d2_out["s"] = time.perf_counter() - t0

    # --- D3: the server binary, durable across a restart ---
    new_sql, new = new_customers_sql(cat, D3_NEW_CUSTOMERS,
                                     int(arr["customer"]["c_custkey"].max()) + 1)
    n_deleted = int((arr["supplier"]["s_nationkey"] == D3_DELETED_NATION).sum())

    def d3():
        gc.collect()
        freed = scan.release()
        torch.cuda.empty_cache()
        th2 = d2_holder[0] = threading.Thread(target=d2_thread, name="chip-smoke-d2")
        th2.start()
        toml = os.path.join(tmp, "server.toml")
        with open(toml, "w") as f:
            f.write("auto_analyze_interval_s = 5.0\n[variables]\ntidb_slow_log_threshold = 450\n")
        env = dict(os.environ, TIDB_TPU_RACECHECK="1")
        port_file = os.path.join(tmp, "port")
        script = [["query", "segment", DURABILITY_SEGMENT_SQL.replace(f"{DDB}.", "")],
                  ["write", "insert", new_sql],
                  ["write", "update", "update customer set c_acctbal = c_acctbal + 1 "
                                      f"where c_custkey <= {D3_UPDATED}"],
                  ["write", "delete", "delete from supplier_p where s_nationkey = "
                                      f"{D3_DELETED_NATION}"],
                  ["query", "nextval1", "select nextval(seq)"],
                  ["query", "nextval2", "select nextval(seq)"]]
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "tidb_tpu_torch.tidb_server", "--path", bk, "--config", toml,
             "--status-port", "0", "-P", "0"],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        child = subprocess.Popen(
            [sys.executable, "-c", DURABILITY_CLIENT.format(root=ROOT, db=DDB), port_file,
             json.dumps(script)], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        lines, port, status_port, load_s = [], None, None, None
        try:
            while port is None:
                line = proc.stdout.readline()
                if not line:
                    proc.wait(timeout=60)
                    raise RuntimeError(f"tidb_server exited {proc.returncode}: "
                                       f"{''.join(lines)[-3000:]}")
                lines.append(line)
                if line.startswith("loaded catalog"):
                    load_s = float(line.rsplit(" in ", 1)[1].rstrip("s\n"))
                elif line.startswith("status on "):
                    status_port = int(line.rsplit(":", 1)[1])
                elif "listening on" in line:
                    port = int(line.rsplit(":", 1)[1])
            boot_s = time.perf_counter() - t0

            def get(path):
                try:
                    with urllib.request.urlopen(f"http://127.0.0.1:{status_port}{path}",
                                                timeout=60) as r:
                        body = r.read()
                        if r.headers.get_content_type() == "text/plain":
                            return r.status, body.decode()
                        return r.status, json.loads(body)
                except urllib.error.HTTPError as e:
                    return e.code, json.loads(e.read())

            c = MysqlWire(port, db=DDB)
            code, st = get("/status")
            assert code == 200 and st["connections"] == 1, st
            code, sch = get(f"/schema/{DDB}/customer")
            assert code == 200 and sch["rows"] == len(arr["customer"]["c_custkey"]), sch
            code, settings = get("/settings")
            assert settings.get("tidb_slow_log_threshold") == "450", settings.get(
                "tidb_slow_log_threshold")
            code, text = get("/metrics")
            assert code == 200 and "# TYPE tidbtpu_flight_queries_total counter" in text, text[:500]
            with open(port_file + ".tmp", "w") as f:
                f.write(str(port))
            os.replace(port_file + ".tmp", port_file)
            child_out, child_err = child.communicate(timeout=300)
            assert child.returncode == 0, child_err[-3000:]
            res = json.loads(child_out.strip().splitlines()[-1])
            client_s = res.pop("client_s")
            got = report_got(res["segment"]["rows"], False)
            assert got == report_want(arr["customer"], False), got
            assert res["insert"]["affected"] == D3_NEW_CUSTOMERS, res["insert"]
            assert res["update"]["affected"] == D3_UPDATED, res["update"]
            assert res["delete"]["affected"] == n_deleted, res["delete"]
            seq = [int(res[k]["rows"][0][0]) for k in ("nextval1", "nextval2")]
            assert seq == [2, 3], res
            # the manifest's users came back with --path: br_reader reads
            # and is refused a write
            r = MysqlWire(port, db=DDB, user="br_reader")
            _cols, rows, _s = r.query("select count(*) from nation")
            assert [int(x) for x in rows[0]] == [25], rows
            try:
                r.write("insert into nation select * from nation limit 0")
                raise AssertionError("br_reader wrote over the wire")
            except WireError as e:
                assert e.message.startswith("INSERT command denied to user 'br_reader'"), e
                refused = e.message
            r.close()
            c.close()
            t1 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            rest, _ = proc.communicate(timeout=300)
            stop_s = time.perf_counter() - t1
            lines.append(rest)
        finally:
            for p in (child, proc):
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=60)
        text = "".join(lines)
        assert proc.returncode == 0, text[-3000:]
        assert "LockOrderError" not in text and "Traceback" not in text, text[-3000:]
        snap = [ln for ln in text.splitlines() if ln.startswith("snapshot of ")]
        assert snap, text[-3000:]
        snapshot_s = float(snap[-1].rsplit(" in ", 1)[1].rstrip("s"))
        nbytes = dir_bytes(bk)
        return {"released_device_bytes": freed, "boot_s": boot_s, "load_s": load_s,
                "client_s": client_s, "stmt_wire_s": {k: v["s"] for k, v in res.items()},
                "br_reader_refused": refused,
                "stop_s": stop_s, "snapshot_s": snapshot_s, "snapshot": snap[-1],
                "bytes_written": nbytes, "snapshot_mb_per_s": nbytes / snapshot_s / 1e6,
                "exit_code": proc.returncode}

    d2_holder = [None]
    step("d3_binary", d3)
    th2 = d2_holder[0]
    th2.join(timeout=600)
    assert not th2.is_alive(), "D2's thread did not end"
    if d2_err:
        raise d2_err[0]
    out["d2_resume"] = dict(d2_out)
    log("durability d2_resume (beside D3): " + json.dumps(out["d2_resume"]))

    # --- D4: RESTORE in this process ---
    def d4():
        nbytes = dir_bytes(bk)
        t0 = time.perf_counter()
        sess.execute(f"restore database {DDB} from '{bk}'")
        restore_s = time.perf_counter() - t0
        c = dict(arr["customer"])
        upd = c["c_custkey"] <= D3_UPDATED
        c["c_acctbal"] = c["c_acctbal"].astype(np.int64) + np.where(upd, 100, 0)
        for k in c:
            c[k] = np.concatenate([c[k].astype(np.int64), new[k].astype(np.int64)])
        rows = {n: one(f"select count(*) from {DDB}.{n}")[0]
                for n in DURABILITY_TABLES + ["supplier_p", "ev"]}
        want_rows = {"region": 5, "nation": 25, "supplier": len(arr["supplier"]["s_nationkey"]),
                     "customer": len(c["c_custkey"]),
                     "supplier_p": len(arr["supplier"]["s_nationkey"]) - n_deleted, "ev": EV_ROWS}
        assert rows == want_rows, (rows, want_rows)
        got = report_got(sess.execute(DURABILITY_REPORT_SQL).rows, True)
        assert len(got) == 125 and got == report_want(c, True), len(got)
        seg = report_got(sess.execute(DURABILITY_SEGMENT_SQL).rows, False)
        assert seg == report_want(c, False), seg
        assert one(f"select nextval({DDB}.seq)") == (4,)
        ddl_ev = one(f"show create table {DDB}.ev")[1]
        assert ddl_ev.endswith(") ttl = ts + interval 90 day"), ddl_ev
        ddl_sp = one(f"show create table {DDB}.supplier_p")[1]
        assert "partition by range (s_nationkey)" in ddl_sp.lower() and "p4" in ddl_sp, ddl_sp
        pruned = _explain_lists(sess, SUPPLIER_P_PRUNED_SQL)
        assert pruned == out["d1_declare_backup"]["pruned"], pruned
        # the live catalog's user: RESTORE DATABASE restores no users
        # (D3 read the manifest's over the wire)
        reader = Session(cat, db=DDB, user="br_reader")
        assert reader.execute(f"select count(*) from {DDB}.nation").rows == [(25,)]
        try:
            reader.execute(f"insert into {DDB}.nation select * from {DDB}.nation limit 0")
            raise AssertionError("br_reader wrote")
        except PermissionError as e:
            refused = str(e)
        t0 = time.perf_counter()
        assert sess.execute(f"admin check table {DDB}.customer, {DDB}.supplier_p").rows == []
        check_s = time.perf_counter() - t0
        sums = sess.execute(f"admin checksum table tpch.nation, {DDB}.nation, "
                            f"tpch.region, {DDB}.region").rows
        assert sums[0][2:4] == sums[1][2:4] and sums[2][2:4] == sums[3][2:4], sums
        return {"restore_s": restore_s, "bytes_read": nbytes,
                "mb_per_s": nbytes / restore_s / 1e6, "rows": rows, "check_s": check_s,
                "reader_refused": refused}

    step("d4_restore", d4)

    # --- D5: the watchdog ends a statement past the server memory limit ---
    def d5():
        sleeper = Session(cat, db=DDB)
        errors = []

        def run():
            try:
                sleeper.execute(f"select sleep({D5_SLEEP_S})")
            except QueryKilled as e:
                errors.append(str(e))

        th = threading.Thread(target=run, name="chip-smoke-sleeper")
        th.start()
        time.sleep(0.2)
        rss, total = wd_host_memory()
        t0 = time.perf_counter()
        sess.execute(f"set global tidb_server_memory_limit = {rss // 2}")
        wd = cat._watchdog
        th.join(timeout=D5_SLEEP_S + 10)
        ended_s = time.perf_counter() - t0
        assert not th.is_alive() and errors == ["query interrupted (killed)"], errors
        assert ended_s <= 2 * wd.interval + 0.5, (ended_s, wd.interval)
        sess.execute("set global tidb_server_memory_limit = '0'")
        ops = sess.execute("select op, conn_id, memory_limit from "
                           "information_schema.memory_usage_ops_history").rows
        assert ("kill", sleeper.conn_id, rss // 2) in ops, ops
        mu = one("select memory_total, memory_limit, memory_current, watchdog_samples "
                 "from information_schema.memory_usage")
        assert mu[0] == mem_total and mu[1] == 0, (mu, mem_total)
        wd.stop(timeout=10)
        assert not wd.is_alive()
        return {"rss_bytes": rss, "limit_bytes": rss // 2, "ended_s": ended_s,
                "interval_s": wd.interval, "kills": len(wd.kill_records),
                "memory_total": mu[0], "samples": mu[3]}

    step("d5_watchdog", d5)

    for name in cat.tables(DDB):
        scan.release(cat.table(DDB, name))
    sess.execute(f"drop database {DDB}")
    sess.execute("drop user br_reader")
    shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    out["phase_s"] = time.perf_counter() - t_phase
    out["launches"] = dict(K.LAUNCHES)
    log(f"durability: phase {out['phase_s']:.1f}s of {DURABILITY_LIMIT_S:.0f}s, MemTotal "
        f"{mem_total} B, launches " + json.dumps(out["launches"]))
    return dict(K.LAUNCHES)


def durability_only(report) -> dict:
    """The SF10 tables, ANALYZEd, and the durability phase alone: the
    short loop for durability work. Returns the phase's launches."""
    from tidb_tpu_torch.bench import load_tpch
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage import Catalog

    t0 = time.perf_counter()
    cat = Catalog()
    load_tpch(cat, sf=SF, seed=1, tables=TABLES)
    sess = Session(cat, db="tpch")
    for t in TABLES:
        sess.execute(f"analyze table {t}")
    log(f"datagen and analyze: SF{SF:g} in {time.perf_counter() - t0:.1f}s")
    launches = durability_phase(cat, sess, report)
    for k, n in launches.items():
        assert n > 0, f"kernel {k} was not launched in the durability phase"
    return launches


#: the observability phase's time limit (seconds), its oracles included
OBSERVABILITY_LIMIT_S = 40.0
#: M1's slow-log threshold (ms): Q18's warm runs (~275 ms) pass it, Q6's
#: (~14 ms) do not
OBS_SLOW_MS = 100
#: M1's queries, each run this many times in a fresh session
OBS_RUNS = 3
#: Q6 by EXECUTE and as text, runs each (ROADMAP queue 1 item 4)
OBS_Q6_RUNS = 20
#: M4's group: its fill rate (RU/s), the seconds its Q6 loop runs, and
#: the window its rate is read over (after the first second's burst)
OBS_RU_PER_SEC = 200
OBS_RU_LOOP_S = 4.0
OBS_RU_SKIP_S = 1.0
#: the columns the phase's oracles read (Q1, Q5, Q6, Q18)
OBS_COLUMNS = {
    "lineitem": ["l_orderkey", "l_suppkey", "l_quantity", "l_extendedprice", "l_discount",
                 "l_tax", "l_returnflag", "l_linestatus", "l_shipdate"],
    "orders": ["o_orderkey", "o_custkey", "o_orderdate", "o_totalprice"],
    "customer": ["c_custkey", "c_nationkey"],
    "supplier": ["s_suppkey", "s_nationkey"],
    "nation": ["n_nationkey", "n_name", "n_regionkey"],
    "region": ["r_regionkey", "r_name"],
}
#: Q6 with its parameters as '?', for PREPARE ... FROM
OBS_Q6_PREPARE = ("prepare obs_q6 from 'select sum(l_extendedprice * l_discount) as revenue "
                  "from lineitem where l_shipdate >= ? and l_shipdate < ? "
                  "and l_discount between ? and ? and l_quantity < ?'")
OBS_Q6_VARS = ("set @obs_d0 = '1994-01-01'", "set @obs_d1 = '1995-01-01'",
               "set @obs_lo = 0.05", "set @obs_hi = 0.07", "set @obs_q = 24")
OBS_Q6_EXECUTE = "execute obs_q6 using @obs_d0, @obs_d1, @obs_lo, @obs_hi, @obs_q"

#: the recorder's seconds per statement over the whole script (filled by
#: ``watch_recorder``): its entry points, the flight and engine-watch
#: open and the close (summary, slow log, counters, bill), timed from
#: outside the package
RECORDER_S: list = []


def watch_recorder() -> None:
    """Time the recorder's two entry points on every statement from here
    on, from the script: ``Session._open_records`` and ``_close_records``
    (the summary, slow log and counters) on the statement's thread."""
    from tidb_tpu_torch.session.session import Session

    open_fn, close_fn = Session._open_records, Session._close_records
    opened = threading.local()

    def timed_open(self, *a, **kw):
        t0 = time.perf_counter()
        try:
            return open_fn(self, *a, **kw)
        finally:
            opened.s = time.perf_counter() - t0

    def timed_close(self, *a, **kw):
        t0 = time.perf_counter()
        try:
            return close_fn(self, *a, **kw)
        finally:
            RECORDER_S.append(time.perf_counter() - t0 + getattr(opened, "s", 0.0))
            opened.s = 0.0

    Session._open_records, Session._close_records = timed_open, timed_close


def recorder_summary() -> dict:
    """The recorder's microseconds a statement so far: median, max."""
    us = np.asarray(RECORDER_S) * 1e6
    return {"statements": int(len(us)), "median_us": float(np.median(us)) if len(us) else 0.0,
            "max_us": float(us.max()) if len(us) else 0.0}


def observability_phase(cat, sess, report) -> dict:
    """The observability phase over the SF10 tables: what one statement
    leaves behind. It resets the statement summary, its history, the
    slow log, the flight ring and the engine watch first. M1: Q1, Q5, Q6
    and Q18 three times each in a fresh session at tidb_slow_log_threshold
    = 100, every run's rows against numpy: one summary row a digest with
    exec_count 3, p50 <= p95 <= p99 <= max, sum_latency against the
    host-timed runs, the mean phases within the mean latency, rows sent,
    plan-cache hits 2 and misses 1; slow_query holding Q18's runs with
    their phases and plan and no warm Q6; then Q6 by EXECUTE and as text,
    20 runs each, their mean parse, plan, compile and execute printed. M2:
    TRACE of Q5 (span names as the CPU test's, their durations within the
    statement's wall). M3: a cold Q6 after lineitem's cached columns are
    released, then a warm one: tpu_engine's h2d and d2h bytes against
    chunk.TRANSFERS, device_mem_peak_bytes beside max_memory_allocated's
    rise. M4: a resource group of 200 RU/s runs Q6 for ~4 s (its
    steady-state RU/s within 25% of 200, resource_groups' consumed_ru
    agreeing), and a BURSTABLE one the same number of runs without a
    wait. M5: /metrics from the port's status server in this process:
    the text parses, tidbtpu_session_statements_total moved by the
    phase's statements, histogram buckets cumulative, and
    information_schema.metrics agrees. M6: PLAN REPLAYER DUMP of Q5 (the
    stats JSON's row counts equal the tables'), the recorder's
    microseconds a statement so far and the digest milliseconds of a
    1,000-row INSERT. Returns the phase's launches."""
    import re
    import shutil
    import tempfile
    import urllib.request
    import zipfile

    import torch

    from tidb_tpu_torch.bench import oracles as O
    from tidb_tpu_torch.chunk import TRANSFERS
    from tidb_tpu_torch.executor import kernels as K
    from tidb_tpu_torch.obs.engine_watch import ENGINE_WATCH
    from tidb_tpu_torch.obs.flight import FLIGHT
    from tidb_tpu_torch.parser import parse_tokens
    from tidb_tpu_torch.server.http_status import StatusServer
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage import scan
    from tidb_tpu_torch.utils import metrics as M

    out = report["observability"] = {}
    t_phase = time.perf_counter()
    log(f"observability: card {card_line()}")
    K.reset_launches()
    for store in (M.STMT_SUMMARY, M.STMT_HISTORY, M.SLOW_LOG, FLIGHT, ENGINE_WATCH):
        store.reset()
    # every statement the phase runs, counted from the script (M5)
    ran = [0]
    execute = Session.execute

    def counting(self, sql):
        ran[0] += 1
        return execute(self, sql)

    Session.execute = counting
    status = StatusServer(cat, port=0)
    status_th = status.start_background()

    def scrape():
        with urllib.request.urlopen(f"http://127.0.0.1:{status.port}/metrics", timeout=30) as r:
            return r.read().decode()

    def sample(text, name):
        m = re.search(rf"^{name} (\S+)$", text, re.M)
        assert m, name
        return float(m.group(1))

    stmts0 = sample(scrape(), "tidbtpu_session_statements_total")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_obs_", dir=tempfile.gettempdir())
    try:
        # the oracles of now (earlier phases wrote to lineitem and orders),
        # each computed once, side by side, before the timed runs
        t0 = time.perf_counter()
        ora = capture_arrays(cat, OBS_COLUMNS)
        ocat = oracle_catalog(cat, ora)
        q18 = O.TPCH_QUERIES["q18"]
        q18_params = O.spec_params("q18", SF)
        with ThreadPoolExecutor(4) as pool:
            futs = {"q1": pool.submit(O.numpy_q1, ora["lineitem"]),
                    "q6": pool.submit(O.numpy_q6, ora["lineitem"]),
                    "q5": pool.submit(O.numpy_q5, ocat),
                    "q18": pool.submit(q18.oracle, ocat, **q18_params)}
            want = {k: f.result() for k, f in futs.items()}
        li_t = cat.table("tpch", "lineitem")
        checks = {"q1": lambda r: check_q1(r, want["q1"], li_t),
                  "q5": lambda r: check_q5(r, ocat, want["q5"]),
                  "q6": lambda r: _check_q6_value(r, want["q6"]),
                  "q18": lambda r: O.check_rows(r.rows, want["q18"], q18.order, q18.limit)}
        sqls = {"q1": O.Q1_SQL, "q5": O.Q5_SQL, "q6": O.Q6_SQL,
                "q18": q18.sql.format(**q18_params)}
        out["oracles_s"] = time.perf_counter() - t0
        log(f"observability: oracles in {out['oracles_s']:.1f}s on 4 threads")

        # --- M1: the summary and the slow log ---
        t0 = time.perf_counter()
        s1 = Session(cat, db="tpch")
        s1.execute(f"set tidb_slow_log_threshold = {OBS_SLOW_MS}")
        host = {k: [] for k in sqls}
        nrows = {}
        for name, sql in sqls.items():
            for _ in range(OBS_RUNS):
                t1 = time.perf_counter()
                res = s1.execute(sql)
                host[name].append(time.perf_counter() - t1)
                checks[name](res)
                nrows[name] = len(res.rows)
        rows = {e["digest_text"]: e for e in M.STMT_SUMMARY.rows_full()}
        m1 = {}
        for name, sql in sqls.items():
            e = rows[M.sql_digest(sql)]
            lat = (e["p50_latency"], e["p95_latency"], e["p99_latency"], e["max_latency"])
            mean_ph = {p: v[0] / e["exec_count"] for p, v in e["phases"].items()}
            hs = sum(host[name])
            assert e["exec_count"] == OBS_RUNS, (name, e["exec_count"])
            assert list(lat) == sorted(lat), (name, lat)
            assert abs(e["sum_latency"] - hs) <= max(0.1 * hs, 0.002), (name, e["sum_latency"], hs)
            assert sum(mean_ph.values()) <= e["sum_latency"] / OBS_RUNS, (name, mean_ph)
            assert e["plan_cache_hits"] == OBS_RUNS - 1 and e["plan_cache_misses"] == 1, (name, e)
            assert e["rows_sent"] == OBS_RUNS * nrows[name], (name, e["rows_sent"], nrows[name])
            m1[name] = {"exec_count": e["exec_count"], "sum_latency_s": e["sum_latency"],
                        "host_s": hs, "p50_s": lat[0], "p99_s": lat[2], "max_s": lat[3],
                        "rows_sent": e["rows_sent"], "mean_phases_ms": {
                            p: v * 1e3 for p, v in mean_ph.items()},
                        "h2d_bytes": e["h2d_bytes"], "d2h_bytes": e["d2h_bytes"],
                        "builds": e["jit_compilations"], "retraces": e["retraces"]}
        slow = s1.execute("select query, query_time, phases, plan from information_schema.slow_query"
                          ).rows
        by = {name: [r for r in slow if r[0] == sql] for name, sql in sqls.items()}
        assert len(by["q18"]) == OBS_RUNS, [r[1] for r in by["q18"]]
        for _q, _t, phases, plan in by["q18"]:
            assert "parse=" in phases and "plan=" in phases and "execute=" in phases, phases
            assert "table=tpch.lineitem" in plan and "Aggregate" in plan, plan
        warm_q6 = [t for t in host["q6"][1:]]
        assert max(warm_q6) < OBS_SLOW_MS / 1e3 * 0.9, warm_q6
        assert len(by["q6"]) == sum(t >= OBS_SLOW_MS / 1e3 for t in host["q6"]), (by["q6"], host)
        # Q6 by EXECUTE and as text: the phases of each (ROADMAP item 4)
        s1.execute(OBS_Q6_PREPARE)
        for q in OBS_Q6_VARS:
            s1.execute(q)
        for sql in (OBS_Q6_EXECUTE, O.Q6_SQL):
            for _ in range(OBS_Q6_RUNS):
                checks["q6"](s1.execute(sql))
        rows = {e["digest_text"]: e for e in M.STMT_SUMMARY.rows_full()}
        q6_forms = {}
        for form, sql, n in (("execute", OBS_Q6_EXECUTE, OBS_Q6_RUNS),
                             ("text", O.Q6_SQL, OBS_Q6_RUNS + OBS_RUNS)):
            e = rows[M.sql_digest(sql)]
            assert e["exec_count"] == n, (form, e["exec_count"])
            q6_forms[form] = {"runs": n, "mean_ms": e["sum_latency"] / n * 1e3, **{
                f"{p}_ms": e["phases"].get(p, (0.0,))[0] / n * 1e3
                for p in ("parse", "plan", "compile", "execute", "final-merge")}}
        out["m1"] = {"s": time.perf_counter() - t0, "queries": m1,
                     "slow_query": {k: len(v) for k, v in by.items()}, "q6_forms": q6_forms}
        log("observability M1: " + json.dumps(out["m1"]))

        # --- M2: TRACE of Q5 ---
        t0 = time.perf_counter()
        tr = s1.execute("trace " + O.Q5_SQL)
        wall = time.perf_counter() - t0
        names = [r[0] for r in tr.rows]
        assert names == ["execute", "  session.plan", "  executor.run", "  session.materialize"], \
            names
        ms = [float(r[2][:-2]) / 1e3 for r in tr.rows]
        assert sum(ms[1:]) <= ms[0] <= wall, (ms, wall)
        out["m2"] = {"wall_s": wall,
                     "spans_ms": {n.strip(): v * 1e3 for n, v in zip(names, ms)}}
        log("observability M2: " + json.dumps(out["m2"]))

        # --- M3: tpu_engine over a cold and a warm Q6 ---
        t0 = time.perf_counter()
        m3 = {}
        for run in ("cold", "warm"):
            if run == "cold":
                m3["released_bytes"] = scan.release(li_t)
            torch.cuda.synchronize()
            a0 = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            h0, d0, f0 = TRANSFERS["h2d_bytes"], TRANSFERS["d2h_bytes"], TRANSFERS["d2h_fetches"]
            res = s1.execute(O.Q6_SQL)
            torch.cuda.synchronize()
            dh, dd = TRANSFERS["h2d_bytes"] - h0, TRANSFERS["d2h_bytes"] - d0
            fetches, rise = TRANSFERS["d2h_fetches"] - f0, torch.cuda.max_memory_allocated() - a0
            checks["q6"](res)
            # the read's own record comes after it: the newest is Q6's
            rec = s1.execute("select query, h2d_bytes, d2h_bytes, device_mem_peak_bytes, "
                             "jit_compilations, retraces, duration from "
                             "information_schema.tpu_engine order by qid desc limit 1").rows[0]
            assert rec[0] == O.Q6_SQL and rec[1] == dh and rec[2] == dd, (run, rec, dh, dd)
            m3[run] = {"h2d_bytes": rec[1], "d2h_bytes": rec[2], "fetches": fetches,
                       "device_mem_peak_bytes": rec[3], "max_allocated_rise": rise,
                       "builds": rec[4], "retraces": rec[5], "s": rec[6]}
        assert m3["cold"]["h2d_bytes"] > 0 and m3["warm"]["h2d_bytes"] == 0, m3
        m3["s"] = time.perf_counter() - t0
        out["m3"] = m3
        log("observability M3: " + json.dumps(m3))

        # --- M4: resource groups ---
        t0 = time.perf_counter()
        rg = cat.resource_groups
        acquire = rg.acquire
        waits = []

        def recording(*a, **kw):
            w = acquire(*a, **kw)
            waits.append(w)
            return w

        rg.acquire = recording
        try:
            s4 = Session(cat, db="tpch")
            s4.execute(f"create resource group obs_rg ru_per_sec = {OBS_RU_PER_SEC}")
            s4.execute(f"create resource group obs_burst ru_per_sec = {OBS_RU_PER_SEC} burstable")
            s4.execute("set resource group obs_rg")
            g = rg.get("obs_rg")
            waits.clear()
            trail = []  # (seconds into the loop, the group's consumed RU)
            ru0, billed, t_loop = g.consumed_ru, 0.0, time.perf_counter()
            while time.perf_counter() - t_loop < OBS_RU_LOOP_S:
                t1 = time.perf_counter()
                res = s4.execute(O.Q6_SQL)
                billed += (time.perf_counter() - t1 - waits[-1]) * 1e3
                trail.append((time.perf_counter() - t_loop, g.consumed_ru))
                checks["q6"](res)
            throttled = len(trail)
            waited_runs = sum(w > 0.001 for w in waits)
            steady = [(t, c) for t, c in trail if t >= OBS_RU_SKIP_S]
            rate = (steady[-1][1] - steady[0][1]) / (steady[-1][0] - steady[0][0])
            consumed = s4.execute("select consumed_ru, queries from information_schema."
                                  "resource_groups where name = 'obs_rg'").rows[0]
            assert abs(rate - OBS_RU_PER_SEC) <= 0.25 * OBS_RU_PER_SEC, (rate, trail[-5:])
            assert abs(consumed[0] - round(trail[-1][1], 3)) <= 0.001, (consumed, trail[-1])
            # each statement billed its own milliseconds, never its wait
            assert abs(trail[-1][1] - ru0 - billed) <= 0.1 * billed + 2, (trail[-1][1] - ru0, billed)
            assert waited_runs > 0, waits
            s4.execute("set resource group obs_burst")
            waits.clear()
            t1 = time.perf_counter()
            for _ in range(throttled):
                checks["q6"](s4.execute(O.Q6_SQL))
            burst_s = time.perf_counter() - t1
            assert len(waits) == throttled and max(waits) < 0.001, (len(waits), max(waits))
            burst_ru = rg.get("obs_burst").consumed_ru
            s4.execute("set resource group default")
            s4.execute("drop resource group obs_rg")
            s4.execute("drop resource group obs_burst")
        finally:
            del rg.acquire
        out["m4"] = {"s": time.perf_counter() - t0, "throttled_runs": throttled,
                     "runs_that_waited": waited_runs, "ru_per_s": rate,
                     "consumed_ru": consumed[0], "queries": consumed[1],
                     "burstable_runs_s": burst_s, "burstable_ru": burst_ru,
                     "burstable_max_wait_s": max(waits)}
        log("observability M4: " + json.dumps(out["m4"]))

        # --- M5: /metrics ---
        t0 = time.perf_counter()
        text = scrape()
        sample_re = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s(-?[0-9.e+-]+|NaN)$")
        lines = [ln for ln in text.splitlines() if ln and not ln.startswith("#")]
        bad = [ln for ln in lines if not sample_re.match(ln)]
        assert not bad, bad[:5]
        moved = sample(text, "tidbtpu_session_statements_total") - stmts0
        assert moved == ran[0], (moved, ran[0])
        for fam in ("tidbtpu_session_query_duration_seconds", "tidbtpu_flight_query_seconds"):
            counts = [float(v) for v in re.findall(rf"^{fam}_bucket\{{le=\"[^\"]+\"\}} (\S+)$",
                                                   text, re.M)]
            assert counts == sorted(counts) and counts[-1] == sample(text, f"{fam}_count"), fam
        table = dict(s1.execute("select name, value from information_schema.metrics").rows)
        for name in ("tidbtpu_session_statements_total", "tidbtpu_engine_h2d_bytes",
                     "tidbtpu_executor_plan_cache_hits_total"):
            assert table[name] == sample(text, name), (name, table[name])
        out["m5"] = {"s": time.perf_counter() - t0, "samples": len(lines),
                     "families": text.count("# TYPE "), "statements": int(moved)}
        log("observability M5: " + json.dumps(out["m5"]))

        # --- M6: PLAN REPLAYER, the recorder's cost ---
        t0 = time.perf_counter()
        q5_tables = ["customer", "orders", "lineitem", "supplier", "nation", "region"]
        stale = [t for t in q5_tables if not cat.table("tpch", t).stats
                 or next(iter(cat.table("tpch", t).stats.values())).row_count
                 != cat.table("tpch", t).nrows]
        t1 = time.perf_counter()
        for t in stale:
            s1.execute(f"analyze table {t}")
        analyze_s = time.perf_counter() - t1
        os.environ["TIDB_TPU_PLAN_REPLAYER_DIR"] = tmp
        try:
            (fn,), = s1.execute("plan replayer dump explain " + O.Q5_SQL).rows
        finally:
            del os.environ["TIDB_TPU_PLAN_REPLAYER_DIR"]
        with zipfile.ZipFile(fn) as z:
            members = sorted(z.namelist())
            for t in q5_tables:
                st = json.loads(z.read(f"stats/tpch.{t}.json"))
                n = cat.table("tpch", t).nrows
                assert st and all(c["row_count"] == n for c in st.values()), (t, n)
        b = li_t.blocks()[0]
        cols = {c: (np.asarray(li_t.dictionaries[c], dtype=object)[b.columns[c].data[:1000]]
                    if k == "str" else b.columns[c].data[:1000]) for c, k in LINEITEM_KINDS}
        text = insert_sql("lineitem", LINEITEM_KINDS, cols, 0, 1000)
        _stmts, toks = parse_tokens(text)
        digest_ms = []
        for _ in range(5):
            t1 = time.perf_counter()
            M.digest_tokens(toks)
            digest_ms.append((time.perf_counter() - t1) * 1e3)
        t1 = time.perf_counter()
        M.sql_digest(text)
        retokenized_ms = (time.perf_counter() - t1) * 1e3
        out["m6"] = {"s": time.perf_counter() - t0, "stale_analyzed": stale,
                     "analyze_s": analyze_s, "zip_members": len(members),
                     "insert_chars": len(text), "digest_ms": float(np.median(digest_ms)),
                     "sql_digest_ms": retokenized_ms, "recorder": recorder_summary()}
        log("observability M6: " + json.dumps(out["m6"]))
    finally:
        Session.execute = execute
        status.shutdown()
        status_th.join(timeout=10)
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.synchronize()
    out["phase_s"] = time.perf_counter() - t_phase
    out["launches"] = dict(K.LAUNCHES)
    log(f"observability: phase {out['phase_s']:.1f}s of {OBSERVABILITY_LIMIT_S:.0f}s, launches "
        + json.dumps(out["launches"]))
    return dict(K.LAUNCHES)


def observability_only(report) -> dict:
    """The SF10 tables, ANALYZEd, and the observability phase alone: the
    short loop for observability work. Returns the phase's launches."""
    from tidb_tpu_torch.bench import load_tpch
    from tidb_tpu_torch.session import Session
    from tidb_tpu_torch.storage import Catalog

    t0 = time.perf_counter()
    cat = Catalog()
    load_tpch(cat, sf=SF, seed=1, tables=TABLES)
    sess = Session(cat, db="tpch")
    for t in TABLES:
        sess.execute(f"analyze table {t}")
    log(f"datagen and analyze: SF{SF:g} in {time.perf_counter() - t0:.1f}s")
    launches = observability_phase(cat, sess, report)
    for k, n in launches.items():
        assert n > 0, f"kernel {k} was not launched in the observability phase"
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
    ap.add_argument("--refresh-only", action="store_true",
                    help="build and check the kernels, generate and ANALYZE the SF10 tables "
                         "and run the refresh phase only: no last line")
    ap.add_argument("--builtins-only", action="store_true",
                    help="build and check the kernels, generate and ANALYZE the SF10 tables "
                         "and run the builtins phase only: no last line")
    ap.add_argument("--statements-only", action="store_true",
                    help="build and check the kernels, generate and ANALYZE the SF10 tables "
                         "and run the statements phase only: no last line")
    ap.add_argument("--operator-only", action="store_true",
                    help="build and check the kernels, generate and ANALYZE the SF10 tables "
                         "and run the operator phase only: no last line")
    ap.add_argument("--indexes-only", action="store_true",
                    help="build and check the kernels, generate and ANALYZE the SF10 tables "
                         "and run the index phase only: no last line")
    ap.add_argument("--constraints-only", action="store_true",
                    help="build and check the kernels, generate and ANALYZE the SF10 tables "
                         "and run the constraint phase only: no last line")
    ap.add_argument("--partitions-only", action="store_true",
                    help="build and check the kernels, generate and ANALYZE the SF10 tables "
                         "and run the partition phase only: no last line")
    ap.add_argument("--loads-only", action="store_true",
                    help="build and check the kernels, generate and ANALYZE the SF10 tables "
                         "and run the load phase only: no last line")
    ap.add_argument("--durability-only", action="store_true",
                    help="build and check the kernels, generate and ANALYZE the SF10 tables "
                         "and run the durability phase only: no last line")
    ap.add_argument("--observability-only", action="store_true",
                    help="build and check the kernels, generate and ANALYZE the SF10 tables "
                         "and run the observability phase only: no last line")
    args = ap.parse_args()
    t_script = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    watch_recorder()
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
    report = {"phase_s": {"build_and_edge_checks": time.perf_counter() - t_script}}
    launches = {}
    kernels = None
    if args.refresh_only:
        log(json.dumps({"refresh": refresh_only(report)}))
        log(card)
        return 0
    if args.builtins_only:
        log(json.dumps({"builtins": builtins_only(report)}))
        log(card)
        return 0
    if args.statements_only:
        log(json.dumps({"statements": statements_only(report)}))
        log(card)
        return 0
    if args.operator_only:
        log(json.dumps({"operator": operator_only(report)}))
        log(card)
        return 0
    if args.indexes_only:
        log(json.dumps({"indexes": indexes_only(report)}))
        log(card)
        return 0
    if args.constraints_only:
        log(json.dumps({"constraints": constraints_only(report)}))
        log(card)
        return 0
    if args.partitions_only:
        log(json.dumps({"partitions": partitions_only(report)}))
        log(card)
        return 0
    if args.loads_only:
        log(json.dumps({"loads": loads_only(report)}))
        log(card)
        return 0
    if args.durability_only:
        log(json.dumps({"durability": durability_only(report)}))
        log(card)
        return 0
    if args.observability_only:
        log(json.dumps({"observability": observability_only(report)}))
        log("recorder: " + json.dumps(recorder_summary()))
        log(card)
        return 0
    if not args.spill_only:
        seen = {}
        launches.update(sf10_phases(args, seen, report))
        # --- 7. kernels on the main path's inputs: check and time ---
        t0 = time.perf_counter()
        kernels = kernel_rows(seen, None)
        report["phase_s"]["kernel_times"] = time.perf_counter() - t0
        seen.clear()

    # --- 8. spill: TPC-H SF100 ---
    # the SF10 sessions' compiled plans and their executors refer to each
    # other: collect them now, with the tables they hold
    gc.collect()
    freed = scan.release()
    torch.cuda.empty_cache()
    log(f"spill: released {freed} B of cached device columns, device allocated "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    t0 = time.perf_counter()
    launches["spill_sf100"] = spill_phase(args, report)
    report.setdefault("phase_s", {})["spill_sf100"] = time.perf_counter() - t0
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
    phase_s = report["phase_s"]
    log("recorder: " + json.dumps(recorder_summary()))
    log("phases: " + json.dumps({
        "seconds": phase_s, "total_s": time.perf_counter() - t_script,
        "partitions_within_limit": phase_s["partitions"] <= PARTITION_LIMIT_S,
        "loads": phase_s["loads"], "loads_within_limit": phase_s["loads"] <= LOAD_LIMIT_S,
        "durability": phase_s["durability"],
        "durability_within_limit": phase_s["durability"] <= DURABILITY_LIMIT_S,
        "observability": phase_s["observability"],
        "observability_within_limit": phase_s["observability"] <= OBSERVABILITY_LIMIT_S}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
