"""ENUM, SET and JSON columns with their write checks, the JSON functions
over them, and COLLATE: every class of tests/test_json_enum.py through the
JAX package's Session and the port's (rows equal; a refused write fails
in both with the same exception class and message, and leaves both
tables' state equal).

Persistence (storage/persist.py) and ALTER TABLE are not ported: the
JAX package's shapes run there, and the port refuses each by name. The
write check runs on every write path the port has: INSERT ... VALUES and
... SELECT, the columnar UPDATE, the rewrite UPDATE and a transaction's
COMMIT."""

import numpy as np
import pytest

import tidb_tpu  # noqa: F401
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage import Catalog as JaxCatalog
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage import Catalog, TableSchema
from tidb_tpu_torch.storage.table import Table
from tidb_tpu_torch.chunk import HostBlock, column_from_values
from tidb_tpu_torch.dtypes import STRING

from _torch_parity import WritePair

FIXTURE = (
    "create table e (st enum('open','closed'), tags set('a','b','c'), doc json)",
    "insert into e values "
    "('open', 'a,c', '{\"k\": [1, 2, {\"x\": \"y\"}], \"n\": null}'),"
    "('closed', '', '[10, 20]'),"
    "('open', 'b', '\"plain\"'),"
    "(null, null, null)",
)


@pytest.fixture()
def pair():
    w = WritePair(JaxSession(JaxCatalog(), db="test"), Session(Catalog(), db="test", device="cpu"))
    w.runs(*FIXTURE)
    return w


# -- TestDomains ---------------------------------------------------------------

DOMAIN_WRITES = [
    # (refused, then accepted)
    ("insert into e values ('bogus', 'a', '{}')", "insert into e values ('closed', 'a', '{}')"),
    ("insert into e values ('open', 'a,z', '{}')", "insert into e values ('open', 'c,b', '{}')"),
    ("insert into e values ('open', 'a,a', '{}')", "insert into e values ('open', 'a', '[1,2]')"),
    ("insert into e values ('open', 'a', 'not json')", "insert into e values (null, null, null)"),
]


@pytest.mark.parametrize("bad,good", DOMAIN_WRITES, ids=["enum", "set", "set-dups", "json"])
def test_domain_write_checks(pair, bad, good):
    err = pair.run(bad)
    assert isinstance(err, ValueError), err
    pair.state("e")
    pair.run(good)
    pair.state("e")


@pytest.mark.parametrize("sql", [
    "update e set st = 'gone' where st = 'open'",
    "update e set tags = 'a,z' where st = 'closed'",
    "update e set doc = concat(doc, '}') where st = 'open'",
    "insert into e select 'half', tags, doc from e where st = 'open'",
])
def test_domain_checks_on_update_and_insert_select(pair, sql):
    err = pair.run(sql)
    assert isinstance(err, ValueError), err
    pair.state("e")


def test_domain_checks_at_commit(pair):
    """A transaction's writes are checked as they land in its shadow,
    and its COMMIT installs only checked values."""
    pair.run("begin")
    assert isinstance(pair.run("insert into e values ('bogus', '', '{}')"), ValueError)
    pair.runs("insert into e values ('closed', 'c', '{\"z\": 1}')", "commit",
              "select st, tags, doc from e")
    pair.state("e")


def test_install_commit_checks_domains():
    """The port's commit install refuses a block that breaks a domain."""
    t = Table("e", TableSchema([("st", STRING)], enums={"st": ("open", "closed")}))
    blk = HostBlock.from_columns({"st": column_from_values(["open", "shut"], STRING)})
    with pytest.raises(ValueError, match="invalid ENUM value 'shut' for column st"):
        t.install_commit([blk], {"st": np.array(["open", "shut"], dtype=object)}, 1, 2)
    assert t.nrows == 0


def test_like_and_ctas_carry_no_domain(pair):
    """The JAX package clones a table through its rendered DDL, which
    holds no ENUM, SET or JSON domain, and CREATE ... AS SELECT types its
    columns from the query: neither copy checks a domain."""
    pair.runs("create table e2 like e", "insert into e2 values ('bogus', 'z', 'not json')",
              "create table e3 as select st, tags, doc from e",
              "insert into e3 values ('bogus', 'z', 'not json')",
              "select st, tags, doc from e2", "select st from e3 order by st")


def test_domains_persist_is_not_ported(tmp_path):
    """test_json_enum.py's persistence case, once refused by the port (the
    name is kept): each package's snapshot keeps the ENUM, SET and JSON
    domains, and each package restores the other's snapshot and refuses a
    value outside the domain with the same error."""
    from tidb_tpu.storage.persist import load_catalog as jax_load, save_catalog as jax_save
    from tidb_tpu_torch.storage.persist import load_catalog, save_catalog

    js, ts = JaxSession(JaxCatalog()), Session(Catalog(), device="cpu")
    for s in (js, ts):
        s.execute(FIXTURE[0])
    jax_save(js.catalog, str(tmp_path / "j"))
    save_catalog(ts.catalog._base, str(tmp_path / "t"))
    p = WritePair(JaxSession(catalog=jax_load(str(tmp_path / "t"))),
                  Session(load_catalog(str(tmp_path / "j")), device="cpu"))
    p.run("insert into e values ('bogus', 'a', '{}')")
    p.run("insert into e values ('x', 'a', '[1]')")
    p.state("e")


def test_domains_survive_alter_is_not_ported():
    """TestReviewRegressions.test_domains_survive_alter: after an ALTER
    TABLE adds a column, both Sessions still refuse an ENUM value outside
    the list, with the same error."""
    pair = WritePair(JaxSession(JaxCatalog()), Session(Catalog(), device="cpu"))
    pair.runs("create table t (st enum('open','closed'))", "alter table t add column x int")
    assert isinstance(pair.run("insert into t values ('bogus', 1)"), ValueError)
    pair.runs("insert into t values ('open', 1)", "select * from t")
    pair.state("t")


# -- TestJsonFunctions, TestCollate, TestReviewRegressions ----------------------

JSON_STATEMENTS = [
    "select json_extract(doc, '$.k[2].x') from e where st = 'open' and tags = 'a,c'",
    "select json_unquote(json_extract(doc, '$.k[2].x')) from e where tags = 'a,c'",
    "select json_extract(doc, '$.nope') from e where tags = 'a,c'",
    "select json_extract(doc, '$[1]') from e where st = 'closed'",
    "select json_type(doc), json_valid(doc), json_length(doc) from e "
    "where doc is not null order by json_type(doc)",
    "select st from e where json_extract(doc, '$.k[0]') = '1'",
    "select json_extract(doc, '$.n') from e where tags = 'a,c'",
    # the domains group, sort and compare as strings, as in the JAX package
    "select st, count(*) from e group by st order by st",
    "select tags, find_in_set('b', tags) from e order by tags",
    "select st from e where st > 'd' order by st",
    "select json_keys(doc), json_depth(doc), json_search(doc, 'one', 'y') from e",
]


@pytest.mark.parametrize("sql", JSON_STATEMENTS)
def test_json_function_matches_jax(pair, sql):
    pair.run(sql)


@pytest.fixture(scope="module")
def collate():
    w = WritePair(JaxSession(JaxCatalog(), db="test"), Session(Catalog(), db="test", device="cpu"))
    w.runs("create table c (v varchar(10))", "insert into c values ('Apple'), ('apple'), ('BANANA')",
           "create table c2 (v varchar(10))", "insert into c2 values ('Alice'), ('bob')",
           "create table j (doc json)", "insert into j values ('{\"a\":1,\"b\":[1,2,3]}')")
    return w


@pytest.mark.parametrize("sql", [
    "select count(*) from c where v collate utf8mb4_general_ci = 'APPLE'",
    "select count(*) from c where v = 'APPLE'",
    "select v from c order by v collate utf8mb4_general_ci, v",
    "select count(*) from c where v collate utf8mb4_bin = 'apple'",
    "select count(*) from c2 where v collate utf8mb4_general_ci like 'ALICE'",
    "select count(*) from c2 where v collate utf8mb4_general_ci in ('ALICE','X')",
    "select count(*) from c2 where v collate utf8mb4_general_ci between 'AL' and 'AM'",
    "select json_extract(doc, '$.a', '$.b') from j",
    "select json_length(doc, '$.b') from j",
])
def test_collate_and_regressions_match_jax(collate, sql):
    collate.run(sql)


def test_unknown_collation_refuses_in_both(collate):
    """Each package's parser raises its own ParseError, alike by name and
    message."""
    errs = []
    for s in (collate.js, collate.ts):
        with pytest.raises(Exception) as info:
            s.execute("select v collate latin1_swedish_xx from c")
        errs.append((type(info.value).__name__, str(info.value)))
    assert errs[0] == errs[1], errs


def test_multipath_extract_refuses_in_both(collate):
    for s in (collate.js, collate.ts):
        with pytest.raises(NotImplementedError, match="json_extract supports exactly one path"):
            s.execute("select json_extract(doc, '$.a', '$.b') from j")
