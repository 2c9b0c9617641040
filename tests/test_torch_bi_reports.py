"""The builtins phase's reports B1-B9 (``oracles.BUILTIN_REPORTS``: one
everyday BI report per family of builtins) through the JAX package's
Session and the port's over the same TPC-H tables at sf 0.002, and
against their numpy oracles; and chip_smoke.py's builtins phase driven on
the CPU with the same checks. Rows compare as ``check_rows`` compares
them: ORDER BY order exactly, floats within 1e-12 relative, a DOUBLE sum's
ROUND at a half cent either way (``oracles.Tie``)."""

import os
import sys

import pytest

import tidb_tpu  # noqa: F401
from tidb_tpu.bench import load_tpch as jax_load_tpch
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage import Catalog as JaxCatalog
from tidb_tpu_torch.bench.oracles import BUILTIN_REPORTS, check_rows
from tidb_tpu_torch.session import Session

from _torch_parity import port_catalog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TABLES = ["lineitem", "orders", "customer", "part", "supplier", "partsupp", "nation", "region"]


@pytest.fixture(scope="module")
def tpch():
    jcat = JaxCatalog()
    jax_load_tpch(jcat, sf=0.002, seed=1)
    tcat = port_catalog(jcat, "tpch", TABLES)
    return JaxSession(jcat, db="tpch"), Session(tcat, db="tpch", device="cpu"), tcat


@pytest.mark.parametrize("name", list(BUILTIN_REPORTS))
def test_report_matches_jax_session_and_oracle(tpch, name):
    jsess, tsess, tcat = tpch
    q = BUILTIN_REPORTS[name]
    want = q.oracle(tcat)
    got, ref = tsess.execute(q.sql), jsess.execute(q.sql)
    assert got.columns == ref.columns
    assert got.rows, name
    check_rows(got.rows, want, q.order)
    check_rows(ref.rows, want, q.order)


def test_builtins_phase_checks_on_the_cpu(tpch, monkeypatch):
    """chip_smoke.builtins_phase over the port's Session on the CPU: every
    report's cold and warm runs pass its oracle check, and the dense
    GROUP BYs reach both kernels' wrappers (their plain versions here)."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke

    import torch

    from tidb_tpu_torch.executor import aggregate as A

    _j, tsess, tcat = tpch
    for fn in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: None)
    for fn in ("memory_allocated", "max_memory_allocated"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a: 0)
    calls = {"slot_sums": 0, "prefix_sum": 0}

    def counting(name):
        fn = getattr(A, name)

        def wrapped(*a):
            calls[name] += 1
            return fn(*a)

        return wrapped

    for name in calls:
        monkeypatch.setattr(A, name, counting(name))
    report = {}
    chip_smoke.builtins_phase(tcat, tsess, report)
    assert set(report) == {f"builtins_{n}" for n in BUILTIN_REPORTS}
    assert all(len(r["warm_s"]) == 3 and r["rows"] for r in report.values())
    # on the CPU the wrappers run the plain versions and count no launch
    assert calls["slot_sums"] > 0 and calls["prefix_sum"] > 0, calls
