"""TPC-H schema + synthetic data generator.

Columns/types follow the TPC-H spec (the reference's benchmark ladder in
BASELINE.json runs Q1/Q6/Q3/Q5/Q18 against the same schema). Data is
synthetic-but-faithful: matching key cardinalities and value ranges so
query selectivities are realistic; correctness is checked against a numpy
reference computation over the *same* generated data, so exact dbgen
content is not required.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from tidb_tpu_torch.chunk import HostBlock, HostColumn
from tidb_tpu_torch.dtypes import DATE, DECIMAL, INT64, STRING, date_to_days
from tidb_tpu_torch.storage import Catalog, Table, TableSchema

_SEGMENTS = ["AUTOMOBILE", "BUILDING", "FURNITURE", "HOUSEHOLD", "MACHINERY"]
_PRIORITIES = ["1-URGENT", "2-HIGH", "3-MEDIUM", "4-NOT SPECIFIED", "5-LOW"]
_SHIPMODES = ["AIR", "FOB", "MAIL", "RAIL", "REG AIR", "SHIP", "TRUCK"]
_NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
_REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
_SHIPINSTRUCT = ["COLLECT COD", "DELIVER IN PERSON", "NONE", "TAKE BACK RETURN"]
_P_COLORS = [
    "almond", "antique", "aquamarine", "azure", "beige", "bisque", "black",
    "blanched", "blue", "blush", "brown", "burlywood", "burnished", "chartreuse",
    "chiffon", "chocolate", "coral", "cornflower", "cream", "cyan", "dark",
    "forest", "frosted", "green", "grey", "honeydew", "hot", "indian", "ivory",
    "khaki", "lace", "lavender", "lawn", "lemon", "light", "lime", "linen",
]
_P_TYPE1 = ["STANDARD", "SMALL", "MEDIUM", "LARGE", "ECONOMY", "PROMO"]
_P_TYPE2 = ["ANODIZED", "BURNISHED", "PLATED", "POLISHED", "BRUSHED"]
_P_TYPE3 = ["TIN", "NICKEL", "BRASS", "STEEL", "COPPER"]
_P_TYPES = [f"{a} {b} {c}" for a in _P_TYPE1 for b in _P_TYPE2 for c in _P_TYPE3]
# Comment universes: small fixed vocabularies so dictionaries stay compact;
# a handful of entries match the LIKE patterns the queries probe for
# (Q13 '%special%requests%', Q16 '%Customer%Complaints%').
_O_COMMENTS = [
    "carefully ironic deposits wake furiously",
    "quickly bold accounts nag blithely",
    "special packages among the requests detect slyly",
    "express special pending requests are final deposits",
    "silent foxes boost across the ironic accounts",
    "pending theodolites haggle quickly",
    "special deposits cajole; even requests sleep",
    "regular ideas use slyly after the furious dependencies",
    "ironic pinto beans integrate carefully",
    "asymptotes above the slow requests sleep finally",
]
_S_COMMENTS = [
    "blithely regular packages nag slyly",
    "Customer accounts sleep; Complaints about furious deposits",
    "carefully even asymptotes are about the requests",
    "Customer deposits wake Complaints among ironic foxes",
    "quickly final theodolites detect against the ideas",
    "furiously pending accounts use among the excuses",
]

_D_LO = int(date_to_days("1992-01-01"))
_D_HI = int(date_to_days("1998-08-02"))


def _dict_col(values: np.ndarray, universe) -> HostColumn:
    """Build a STRING column from integer codes into a fixed universe."""
    uni = np.array(sorted(universe), dtype=object)
    order = np.argsort(np.array(list(universe), dtype=object), kind="stable")
    # map original universe index -> sorted code
    remap = np.empty(len(universe), dtype=np.int32)
    remap[order] = np.arange(len(universe), dtype=np.int32)
    codes = remap[values]
    return HostColumn(STRING, codes.astype(np.int32), np.ones(len(values), bool), uni)


def _num(data, typ) -> HostColumn:
    return HostColumn(typ, data, np.ones(len(data), bool))


def _dec(value_cents: np.ndarray, scale=2) -> HostColumn:
    return HostColumn(DECIMAL(scale), value_cents.astype(np.int64), np.ones(len(value_cents), bool))


def _unique_str_col(strings) -> HostColumn:
    """STRING column from per-row strings (dictionary = sorted uniques)."""
    arr = np.array(strings, dtype=object)
    uni, codes = np.unique(arr, return_inverse=True)
    return HostColumn(STRING, codes.astype(np.int32), np.ones(len(arr), bool), uni)


def _supp_for_part(partkey: np.ndarray, j: np.ndarray, n_supps: int) -> np.ndarray:
    """The TPC-H partsupp relationship: part pk is supplied by exactly the
    4 suppliers at offsets j=0..3 of this formula, so lineitem's
    (l_partkey, l_suppkey) pairs always hit partsupp."""
    return (partkey + j * (n_supps // 4 + 1)) % n_supps + 1


def _build_cols(draws, keep) -> HostBlock:
    """Columns from (name, draw, build) in order: every draw runs, so the
    generator's stream is the same whatever `keep` holds, and only the
    kept columns (all when None) are built."""
    cols = {}
    for name, draw, build in draws:
        raw = draw()
        if keep is None or name in keep:
            cols[name] = build(raw)
        del raw
    return HostBlock.from_columns(cols)


def _i64(raw) -> HostColumn:
    return _num(raw.astype(np.int64, copy=False), INT64)


def _date(raw) -> HostColumn:
    return _num(raw.astype(np.int32), DATE)


def gen_lineitem(sf: float, rng: np.random.Generator, n_orders: int, keep=None) -> HostBlock:
    n = int(6_000_000 * sf)
    n_parts = max(int(200_000 * sf), 1000)
    n_supps = max(int(10_000 * sf), 100)
    # drawn first, in this order; each is dropped once its columns are
    # built
    pre = {"orderkey": rng.integers(1, n_orders + 1, n)}
    pre["partkey"] = rng.integers(1, n_parts + 1, n)
    pre["j"] = rng.integers(0, 4, n)
    draws = [
        ("l_orderkey", lambda: pre.pop("orderkey"), _i64),
        ("l_partkey", lambda: pre["partkey"], _i64),
        ("l_suppkey", lambda: (pre.pop("partkey"), pre.pop("j")),
         lambda r: _i64(_supp_for_part(r[0], r[1], n_supps))),
        ("l_linenumber", lambda: rng.integers(1, 8, n), _i64),
        ("l_quantity", lambda: rng.integers(1, 51, n), lambda r: _dec(r * 100)),
        ("l_extendedprice", lambda: rng.integers(90_000, 10_500_000, n), _dec),
        ("l_discount", lambda: rng.integers(0, 11, n), _dec),
        ("l_tax", lambda: rng.integers(0, 9, n), _dec),
        ("l_returnflag", lambda: rng.integers(0, 3, n), lambda r: _dict_col(r, ["A", "N", "R"])),
        ("l_linestatus", lambda: rng.integers(0, 2, n), lambda r: _dict_col(r, ["F", "O"])),
        ("l_shipdate", lambda: rng.integers(_D_LO, _D_HI, n), _date),
        ("l_commitdate", lambda: rng.integers(_D_LO, _D_HI, n), _date),
        ("l_receiptdate", lambda: rng.integers(_D_LO, _D_HI, n), _date),
        ("l_shipmode", lambda: rng.integers(0, len(_SHIPMODES), n),
         lambda r: _dict_col(r, _SHIPMODES)),
        ("l_shipinstruct", lambda: rng.integers(0, len(_SHIPINSTRUCT), n),
         lambda r: _dict_col(r, _SHIPINSTRUCT)),
    ]
    return _build_cols(draws, keep)


def gen_orders(sf: float, rng: np.random.Generator, keep=None) -> HostBlock:
    n = int(1_500_000 * sf)
    n_cust = max(int(150_000 * sf), 100)
    draws = [
        ("o_orderkey", lambda: None, lambda _r: _num(np.arange(1, n + 1, dtype=np.int64), INT64)),
        ("o_custkey", lambda: rng.integers(1, n_cust + 1, n), _i64),
        ("o_orderstatus", lambda: rng.integers(0, 3, n), lambda r: _dict_col(r, ["F", "O", "P"])),
        ("o_totalprice", lambda: rng.integers(90_000, 50_000_000, n), _dec),
        ("o_orderdate", lambda: rng.integers(_D_LO, _D_HI - 151, n), _date),
        ("o_orderpriority", lambda: rng.integers(0, len(_PRIORITIES), n),
         lambda r: _dict_col(r, _PRIORITIES)),
        ("o_shippriority", lambda: None, lambda _r: _num(np.zeros(n, dtype=np.int64), INT64)),
        ("o_comment", lambda: rng.integers(0, len(_O_COMMENTS), n),
         lambda r: _dict_col(r, _O_COMMENTS)),
    ]
    return _build_cols(draws, keep)


def gen_customer(sf: float, rng: np.random.Generator, keep=None) -> HostBlock:
    n = max(int(150_000 * sf), 100)
    nationkey = rng.integers(0, 25, n).astype(np.int64)
    # phone country code = nationkey + 10 (TPC-H spec clause 4.2.2.9)
    p1 = rng.integers(100, 1000, n)
    p2 = rng.integers(100, 1000, n)
    p3 = rng.integers(1000, 10000, n)

    def phones(_r):
        return _unique_str_col(
            [f"{nationkey[i] + 10}-{p1[i]}-{p2[i]}-{p3[i]}" for i in range(n)]
        )

    draws = [
        ("c_custkey", lambda: None, lambda _r: _num(np.arange(1, n + 1, dtype=np.int64), INT64)),
        ("c_name", lambda: None,
         lambda _r: _unique_str_col([f"Customer#{i:09d}" for i in range(1, n + 1)])),
        ("c_address", lambda: None,
         lambda _r: _unique_str_col([f"Addr {i:07d}" for i in range(1, n + 1)])),
        ("c_nationkey", lambda: nationkey, lambda r: _num(r, INT64)),
        ("c_phone", lambda: None, phones),
        ("c_mktsegment", lambda: rng.integers(0, len(_SEGMENTS), n),
         lambda r: _dict_col(r, _SEGMENTS)),
        ("c_acctbal", lambda: rng.integers(-99_999, 1_000_000, n), _dec),
        ("c_comment", lambda: rng.integers(0, len(_O_COMMENTS), n),
         lambda r: _dict_col(r, _O_COMMENTS)),
    ]
    return _build_cols(draws, keep)


def gen_supplier(sf: float, rng: np.random.Generator) -> HostBlock:
    n = max(int(10_000 * sf), 100)
    nationkey = rng.integers(0, 25, n).astype(np.int64)
    p1 = rng.integers(100, 1000, n)
    p2 = rng.integers(100, 1000, n)
    p3 = rng.integers(1000, 10000, n)
    cols = {
        "s_suppkey": _num(np.arange(1, n + 1, dtype=np.int64), INT64),
        "s_name": _unique_str_col([f"Supplier#{i:09d}" for i in range(1, n + 1)]),
        "s_address": _unique_str_col([f"SAddr {i:07d}" for i in range(1, n + 1)]),
        "s_nationkey": _num(nationkey, INT64),
        "s_phone": _unique_str_col(
            [f"{nationkey[i] + 10}-{p1[i]}-{p2[i]}-{p3[i]}" for i in range(n)]
        ),
        "s_acctbal": _dec(rng.integers(-99_999, 1_000_000, n)),
        "s_comment": _dict_col(rng.integers(0, len(_S_COMMENTS), n), _S_COMMENTS),
    }
    return HostBlock.from_columns(cols)


def gen_nation() -> HostBlock:
    cols = {
        "n_nationkey": _num(np.arange(25, dtype=np.int64), INT64),
        "n_name": _dict_col(np.arange(25), [n for n, _ in _NATIONS]),
        "n_regionkey": _num(np.array([r for _, r in _NATIONS], dtype=np.int64), INT64),
    }
    return HostBlock.from_columns(cols)


def gen_region() -> HostBlock:
    cols = {
        "r_regionkey": _num(np.arange(5, dtype=np.int64), INT64),
        "r_name": _dict_col(np.arange(5), _REGIONS),
    }
    return HostBlock.from_columns(cols)


def gen_part(sf: float, rng: np.random.Generator) -> HostBlock:
    n = max(int(200_000 * sf), 1000)
    brands = [f"Brand#{i}{j}" for i in range(1, 6) for j in range(1, 6)]
    containers = ["SM CASE", "SM BOX", "SM PACK", "LG CASE", "LG BOX", "MED BAG", "JUMBO PKG"]
    c1 = rng.integers(0, len(_P_COLORS), n)
    c2 = rng.integers(0, len(_P_COLORS), n)
    names = [f"{_P_COLORS[c1[i]]} {_P_COLORS[c2[i]]}" for i in range(n)]
    cols = {
        "p_partkey": _num(np.arange(1, n + 1, dtype=np.int64), INT64),
        "p_name": _unique_str_col(names),
        "p_mfgr": _dict_col(rng.integers(0, 5, n), [f"Manufacturer#{i}" for i in range(1, 6)]),
        "p_brand": _dict_col(rng.integers(0, len(brands), n), brands),
        "p_type": _dict_col(rng.integers(0, len(_P_TYPES), n), _P_TYPES),
        "p_size": _num(rng.integers(1, 51, n).astype(np.int64), INT64),
        "p_container": _dict_col(rng.integers(0, len(containers), n), containers),
        "p_retailprice": _dec(rng.integers(90_000, 200_000, n)),
    }
    return HostBlock.from_columns(cols)


def gen_partsupp(sf: float, rng: np.random.Generator) -> HostBlock:
    n_parts = max(int(200_000 * sf), 1000)
    n_supps = max(int(10_000 * sf), 100)
    pk = np.repeat(np.arange(1, n_parts + 1, dtype=np.int64), 4)
    j = np.tile(np.arange(4, dtype=np.int64), n_parts)
    sk = _supp_for_part(pk, j, n_supps)
    n = len(pk)
    cols = {
        "ps_partkey": _num(pk, INT64),
        "ps_suppkey": _num(sk.astype(np.int64), INT64),
        "ps_availqty": _num(rng.integers(1, 10_000, n).astype(np.int64), INT64),
        "ps_supplycost": _dec(rng.integers(100, 100_100, n)),
        "ps_comment": _dict_col(rng.integers(0, len(_O_COMMENTS), n), _O_COMMENTS),
    }
    return HostBlock.from_columns(cols)


_SCHEMAS: Dict[str, TableSchema] = {}


# standard TPC-H single-column primary keys (lineitem/partsupp have
# composite PKs the generator does not guarantee; they stay undeclared)
_PKS = {
    "region": ["r_regionkey"],
    "nation": ["n_nationkey"],
    "part": ["p_partkey"],
    "supplier": ["s_suppkey"],
    "customer": ["c_custkey"],
    "orders": ["o_orderkey"],
}


def _schema_of(block: HostBlock, name: str = "") -> TableSchema:
    return TableSchema(
        [(n, c.type) for n, c in block.columns.items()],
        primary_key=_PKS.get(name),
    )


def load_tpch(
    catalog: Catalog,
    sf: float = 0.01,
    db: str = "tpch",
    seed: int = 0,
    tables: Optional[list] = None,
    columns: Optional[Dict[str, list]] = None,
) -> None:
    """Generate and load TPC-H tables into the catalog. ``columns`` maps a
    table to the only columns kept of it (the others are drawn and
    dropped, so every kept value equals the full table's): the host RAM
    that TPC-H SF100 needs for the columns a few queries read."""
    rng = np.random.default_rng(seed)
    catalog.create_database(db, if_not_exists=True)
    keep = dict(columns or {})
    orders = gen_orders(sf, rng, keep.get("orders"))
    n_orders = int(1_500_000 * sf)
    gens = {
        "orders": lambda: orders,
        "lineitem": lambda: gen_lineitem(sf, rng, n_orders, keep.get("lineitem")),
        "customer": lambda: gen_customer(sf, rng, keep.get("customer")),
        "supplier": lambda: gen_supplier(sf, rng),
        "nation": gen_nation,
        "region": gen_region,
        "part": lambda: gen_part(sf, rng),
        "partsupp": lambda: gen_partsupp(sf, rng),
    }
    for name, gen in gens.items():
        if tables is not None and name not in tables:
            continue
        block = gen()
        if name in keep:
            block = HostBlock(
                {n: c for n, c in block.columns.items() if n in keep[name]}, block.nrows
            )
        t = catalog.create_table(db, name, _schema_of(block, name), if_not_exists=True)
        if t.nrows == 0:
            # bypass dictionary merge (fresh table, dicts already sorted)
            t.dictionaries.update(
                {n: c.dictionary for n, c in block.columns.items() if c.dictionary is not None}
            )
            t.replace_blocks([block])
