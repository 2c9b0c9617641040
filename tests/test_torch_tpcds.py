"""TPC-DS Q95 (BASELINE config #5) through the port against the JAX
package.

The port's ``load_tpcds`` makes the JAX package's tables, table by table
(two seeds); Q95 runs through the JAX Session and the port's
``Session(device="cpu")`` at sf 0.08 (seed 7: a few orders qualify) and
sf 0.005 (seed 3: none do, so the scalar aggregate's empty-input row);
the port's vectorized ``numpy_q95`` equals the JAX package's row-by-row
oracle on both.

Rows compare with ``same_rows``: floats within 1e-12 relative,
everything else exactly.
"""

import numpy as np
import pytest

from tidb_tpu.bench.tpcds import Q95_SQL as JAX_Q95_SQL
from tidb_tpu.bench.tpcds import load_tpcds as jax_load_tpcds
from tidb_tpu.bench.tpcds import numpy_q95 as jax_numpy_q95
from tidb_tpu.session import Session as JaxSession
from tidb_tpu_torch.bench.oracles import numpy_q95
from tidb_tpu_torch.bench.tpcds import Q95_SQL, load_tpcds
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage import Catalog

from _torch_parity import same_rows

REL = 1e-12
TABLES = ["date_dim", "customer_address", "web_site", "web_sales", "web_returns"]


def _both(sf, seed):
    js = JaxSession()
    jcounts = jax_load_tpcds(js.catalog, sf=sf, seed=seed)
    cat = Catalog()
    counts = load_tpcds(cat, sf=sf, seed=seed)
    assert counts == jcounts
    return js, Session(cat, db="test", device="cpu")


@pytest.mark.parametrize("sf,seed", [(0.03, 7), (0.02, 11)])
def test_generator_matches_jax(sf, seed):
    js, ts = _both(sf, seed)
    for name in TABLES:
        jt, tt = js.catalog.table("test", name), ts.catalog.table("test", name)
        assert [(n, t.kind.value, t.scale) for n, t in jt.schema.columns] == [
            (n, t.kind.value, t.scale) for n, t in tt.schema.columns], name
        assert jt.schema.primary_key == tt.schema.primary_key, name
        (jb,), (tb,) = jt.blocks(), tt.blocks()
        assert jb.nrows == tb.nrows, name
        for col, jc in jb.columns.items():
            tc = tb.columns[col]
            assert np.array_equal(jc.data, tc.data), (name, col)
            assert np.array_equal(jc.valid, tc.valid), (name, col)
            if jc.dictionary is None:
                assert tc.dictionary is None, (name, col)
            else:
                assert jc.dictionary.tolist() == tc.dictionary.tolist(), (name, col)


@pytest.mark.parametrize("sf,seed,nonempty", [(0.08, 7, True), (0.005, 3, False)])
def test_q95_matches_jax_and_oracles(sf, seed, nonempty):
    js, ts = _both(sf, seed)
    assert Q95_SQL == JAX_Q95_SQL
    want = js.execute(JAX_Q95_SQL).rows
    got = ts.execute(Q95_SQL).rows
    assert same_rows(got, want, True, REL), (got, want)
    exp = jax_numpy_q95(js.catalog)
    assert numpy_q95(ts.catalog) == exp
    assert (exp[0] > 0) == nonempty
    assert got[0][0] == exp[0]
    if nonempty:
        assert got[0][1:] == exp[1:]
