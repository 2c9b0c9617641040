"""PLAN REPLAYER DUMP: everything needed to reproduce a plan, in a zip.

Counterpart of tidb_tpu/utils/planreplayer.py (reference:
pkg/server/handler/optimizor/plan_replayer.go): the schema DDL of the
statement's tables, their statistics as JSON, the bindings, the session
variables, the SQL and its EXPLAIN, from the live catalog.

Output directory: $TIDB_TPU_PLAN_REPLAYER_DIR, else
<tempdir>/tidb_tpu_plan_replayer.
"""

from __future__ import annotations

import io
import json
import os
import tempfile
import time
import zipfile
from typing import List, Tuple

from tidb_tpu_torch.tools.dump import create_table_sql


def _stats_json(t) -> str:
    out = {}
    for col, cs in (getattr(t, "stats", None) or {}).items():
        out[col] = {
            "row_count": int(cs.row_count),
            "null_count": int(cs.null_count),
            "ndv": int(cs.ndv),
            "min": cs.min_val,
            "max": cs.max_val,
            "topn": [[v, int(c)] for v, c in cs.topn],
            "bucket_counts": [int(x) for x in cs.bucket_counts],
        }
    return json.dumps(out, indent=1, default=str)


def dump_plan_replayer(session, sql_text: str, tables: List[Tuple[str, str]],
                       explain_rows: List[tuple]) -> str:
    """Write the replayer zip; returns its path (the statement's
    result, as the reference returns its file's name)."""
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("meta.txt", f"tidb_tpu plan replayer\nts: {time.time():.3f}\n"
                               f"db: {session.db}\n")
        z.writestr("sql/sql0.sql", sql_text)
        z.writestr("explain.txt", "\n".join(str(r[0]) for r in explain_rows))
        for db, name in tables:
            t = session.catalog.table(db, name)
            z.writestr(f"schema/{db}.{name}.schema.txt", create_table_sql(t))
            z.writestr(f"stats/{db}.{name}.json", _stats_json(t))
        z.writestr("variables.toml", "\n".join(
            f"{k} = {v!r}" for k, v in sorted(session.vars.all().items())))
        bindings = session.catalog.bindings
        if bindings:
            z.writestr("bindings.sql", "\n".join(str(b) for b in bindings))
    outdir = os.environ.get("TIDB_TPU_PLAN_REPLAYER_DIR") or os.path.join(
        tempfile.gettempdir(), "tidb_tpu_plan_replayer")
    os.makedirs(outdir, exist_ok=True)
    fn = os.path.join(outdir, f"replayer_{int(time.time() * 1000)}.zip")
    with open(fn, "wb") as f:
        f.write(buf.getvalue())
    return fn
