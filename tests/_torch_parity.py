"""Helpers shared by the tests/test_torch_*.py parity tests: carry the JAX
package's tables across to the port as numpy arrays and compare rows."""

import numpy as np

from tidb_tpu_torch.bench.oracles import same_value
from tidb_tpu_torch.storage import catalog_from_numpy


def export_tables(cat, db, names):
    """The JAX package's tables as the numpy spec catalog_from_numpy takes.
    A table's blocks (one per INSERT) become one: their string codes all
    refer to the table's one dictionary per column."""
    out = {}
    for name in names:
        t = cat.table(db, name)
        blocks = t.blocks()
        data = {}
        for n, typ in t.schema.columns:
            cs = [b.columns[n] for b in blocks]
            data[n] = (
                np.concatenate([c.data for c in cs] or [np.zeros(0, typ.np_dtype)]),
                np.concatenate([c.valid for c in cs] or [np.zeros(0, bool)]),
                t.dictionaries.get(n),
            )
        out[name] = {
            "columns": [
                (n, (typ.kind.value, typ.scale, typ.collation))
                for n, typ in t.schema.columns
            ],
            "primary_key": t.schema.primary_key,
            "data": data,
        }
    return {db: out}


def port_catalog(cat, db, names):
    return catalog_from_numpy(export_tables(cat, db, names))


def same_rows(got, want, ordered, rel=1e-12):
    """Rows equal exactly in order (ORDER BY) or as multisets."""
    if len(got) != len(want):
        return False
    if not ordered:
        key = lambda r: tuple((v is None, str(v)) for v in r)  # noqa: E731
        got, want = sorted(got, key=key), sorted(want, key=key)
    return all(
        len(g) == len(w) and all(same_value(x, y, rel) for x, y in zip(g, w))
        for g, w in zip(got, want)
    )
