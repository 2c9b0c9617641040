"""The port stands alone: no module of tidb_tpu_torch/ and not
chip_smoke.py imports jax, jaxlib or the JAX package tidb_tpu (a GPU host
need not have JAX). Only the tests import both."""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "tidb_tpu")


def _sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, files in os.walk(os.path.join(REPO, "tidb_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in _imported(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_the_walk_sees_the_package():
    rel = {os.path.relpath(p, REPO) for p in _sources()}
    assert "tidb_tpu_torch/session/session.py" in rel
    assert "tidb_tpu_torch/executor/kernels.py" in rel
    for m in ("utils/racecheck.py", "utils/failpoint.py", "utils/config.py",
              "utils/watchdog.py", "storage/external.py", "storage/persist.py",
              "server/http_status.py"):
        assert f"tidb_tpu_torch/{m}" in rel, m
    assert len(rel) > 20
