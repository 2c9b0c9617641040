"""The last builtins through both packages: the regexp family, the JSON
functions, INET/UUID and AES/compress.

Each expression runs through both ``compile_expr``s over one seeded table
whose strings hold JSON documents, IPv4 and IPv6 addresses, UUIDs in
every form IS_UUID weighs, and text for the patterns
(``_torch_exprs.check_expr``: values, or a string result's dictionary and
codes, equal). Then the statements of test_builtins_r3.py (regexp) and
test_builtins_r4.py / test_builtins_r5.py (INET, UUID, JSON, AES,
compress) run through the JAX package's Session and the port's, rows
equal. The JAX package's own refusals (a non-literal pattern, path or
candidate, JSON_EXTRACT with two paths, path wildcards) refuse in both."""

import numpy as np
import pytest

import tidb_tpu  # noqa: F401
from tidb_tpu.session import Session as JaxSession
from tidb_tpu.storage import Catalog as JaxCatalog
from tidb_tpu_torch.session import Session
from tidb_tpu_torch.storage import Catalog

from _torch_exprs import build_engines, check_expr, refused_alike
from _torch_parity import WritePair

STRINGS = np.array(sorted({
    "", " ", "a", "abc", "ABC", "hello world", "a,b,c", "Customer Complaints", "x.y",
    "forest green", "PROMO BRUSHED TIN", "LARGE BRASS", "naïve café", "Straße", "日本語",
    # addresses
    "1.2.3.4", "127.0.0.1", "255.255.255.255", "1.2", "256.1.1.1", "0.0.0.0", "10.0.0.01",
    "::1", "::", "fe80::1", "2001:db8::ff00:42:8329", "::ffff:1.2.3.4", "::1.2.3.4", "1:2:3",
    # UUIDs: dashed, dash-free, braced, upper case, malformed
    "6ccd780c-baba-1026-9564-5b8c656024db", "6ccd780cbaba102695645b8c656024db",
    "{6ccd780c-baba-1026-9564-5b8c656024db}", "6CCD780C-BABA-1026-9564-5B8C656024DB",
    "12345678-123412341234123456789012", "6ccd780c-baba-1026-9564-5b8c656024d",
    # JSON documents
    '{"a": 1, "b": [1, 2, {"c": "hello"}]}', '{"k": {"x": "y"}, "n": null}', "[1, 2, 3]",
    '[10, {"a": 1}]', '"plain"', "null", "true", "3.5", "42", "{}", "[]", "not json",
    '{"a": "x", "b": "xy", "c": ["x", {"d": "x"}]}', '{"q k": 1}',
}), dtype=object)


@pytest.fixture(scope="module")
def engines():
    return build_engines(seed=12, strings=STRINGS)


REGEXP = [
    "s regexp 'a.c'", "s not regexp '^a'", "s rlike 'o$'", "regexp_like(s, '^[A-Z]')",
    "regexp_like(s, null)", "regexp_instr(s, 'b')", "regexp_instr(s, '[0-9]+')",
    "regexp_substr(s, '[0-9]+')", "regexp_substr(s, 'zzz')", "regexp_substr(s, null)",
    "regexp_replace(s, '([a-z])', '$1$1')", "regexp_replace(s, 'o+', 'O')",
    "regexp_replace(s, '^(SM|LARGE) ', '')",
]
INET_UUID = [
    "inet_aton(s)", "inet6_aton(s)", "hex(inet6_aton(s))", "inet6_ntoa(inet6_aton(s))",
    "inet6_ntoa(s)", "is_ipv4(s)", "is_ipv6(s)", "is_ipv4_compat(inet6_aton(s))",
    "is_ipv4_mapped(inet6_aton(s))", "is_uuid(s)", "uuid_to_bin(s)", "hex(uuid_to_bin(s))",
    "bin_to_uuid(uuid_to_bin(s))", "bin_to_uuid(s)",
]
AES_COMPRESS = [
    "aes_encrypt(s, 'k')", "hex(aes_encrypt(s, 'key'))", "aes_decrypt(aes_encrypt(s, 'key'), 'key')",
    "aes_decrypt(aes_encrypt(s, 'key'), 'nope')", "aes_decrypt(s, 'k')",
    "aes_encrypt(s, 'a long key of more than sixteen bytes')",
    "compress(s)", "hex(compress(s))", "uncompress(compress(s))", "uncompress(s)",
    "uncompressed_length(compress(s))", "uncompressed_length(s)",
]
JSON = [
    "json_extract(s, '$.a')", "json_extract(s, '$.b[2].c')", "json_extract(s, '$[1]')",
    "json_extract(s, '$.\"q k\"')", "json_unquote(json_extract(s, '$.k.x'))", "json_unquote(s)",
    "json_type(s)", "json_keys(s)", "json_quote(s)", "json_valid(s)", "json_length(s)",
    "json_length(s, '$.b')", "json_depth(s)", "json_storage_size(s)", "json_pretty(s)",
    "json_set(s, '$.c', 5)", "json_insert(s, '$.a', 99)", "json_replace(s, '$.a', 42)",
    "json_remove(s, '$.b')", "json_remove(s, '$[0]', '$.n')",
    "json_array_append(s, '$.b', 3)", "json_array_append(s, '$', 'z')",
    "json_array_insert(s, '$.b[0]', 0)", "json_merge_patch(s, '{\"a\": null, \"z\": 1}')",
    "json_merge_preserve(s, '{\"a\": 7}')", "json_merge(s, '[9]')",
    "json_search(s, 'one', 'x')", "json_search(s, 'all', 'x%')", "json_contains(s, '1')",
    "json_contains(s, '1', '$.a')", "json_contains_path(s, 'one', '$.a', '$.q')",
    "json_contains_path(s, 'all', '$.a', '$.b')", "json_overlaps(s, '[1, 10]')",
    "json_overlaps(s, '{\"a\": 1}')",
]


@pytest.mark.parametrize("expr", REGEXP + INET_UUID + AES_COMPRESS + JSON)
def test_expression_matches_jax(engines, expr):
    check_expr(engines, expr)


@pytest.mark.parametrize("expr", [
    "s regexp s2", "regexp_instr(s, s2)", "regexp_substr(s, s2)",
    "json_extract(s, '$.a', '$.b')", "json_set(s, '$[*]', 1)", "json_remove(s, '$.*')",
    "json_length(s, s2)", "json_contains(s, s2)", "json_extract(s, s2)",
])
def test_the_jax_packages_refusals_refuse_in_both(engines, expr):
    refused_alike(engines, expr)


@pytest.fixture(scope="module")
def pair():
    js, ts = JaxSession(JaxCatalog(), db="test"), Session(Catalog(), db="test", device="cpu")
    w = WritePair(js, ts)
    w.runs(
        "create table t (a int, s varchar(40), d date, dt datetime, j varchar(200))",
        "insert into t values "
        "(5, 'hello world', date '1995-03-15', '1995-03-15 10:30:45', "
        "'{\"a\": {\"b\": [1, {\"c\": 2}]}}'), "
        "(7, 'a,b,c', date '2000-01-01', '2000-01-01 00:00:00', '{\"a\": 1, \"b\": [1, 2]}'), "
        "(255, '1.2.3.4', date '2000-01-01', '2000-01-01 00:00:00', '[1, 2]'), "
        "(NULL, NULL, NULL, NULL, NULL)",
        "create table js (d varchar(100))",
        "insert into js values ('{\"k\": \"hello\", \"m\": [\"hello\", \"x\"]}')",
    )
    return w


# the statements of test_builtins_r3.py (regexp), test_builtins_r4.py and
# test_builtins_r5.py (INET, UUID, JSON, AES, compress) over this table
STATEMENTS = [
    "select a from t where s regexp 'w.rld' order by a",
    "select a from t where s not rlike 'hello' and s is not null order by a",
    "select regexp_like(s, '^hello') from t", "select regexp_instr(s, 'o') from t",
    "select regexp_substr(s, 'l+o') from t", "select regexp_substr(s, 'zzz') from t",
    "select regexp_replace(s, 'l+', 'L') from t",
    "select inet_aton('1.2.3.4')", "select inet_aton('127.0.0.1')", "select inet_aton('1.2')",
    "select inet_aton(s) from t where a = 255",
    "select is_uuid('6ccd780c-baba-1026-9564-5b8c656024db'), is_uuid('nope')",
    "select is_uuid('6ccd780cbaba102695645b8c656024db'), "
    "is_uuid('12345678-123412341234123456789012')",
    "select json_depth(j) from t", "select json_depth('[1, 2]'), json_depth('3')",
    "select json_quote('a\"b'), json_unquote('\"abc\"')",
    "select json_keys(j) from t", "select json_contains('[1, 2, 3]', '2')",
    "select json_contains(j, '1', '$.a') from t",
    "select json_set(j, '$.c', 5) from t where a = 7",
    "select json_insert(j, '$.a', 99) from t where a = 7",
    "select json_replace(j, '$.a', 42), json_replace(j, '$.c', 1) from t where a = 7",
    "select json_remove(j, '$.b') from t where a = 7",
    "select json_array_append(j, '$.b', 3) from t where a = 7",
    "select json_array_insert(j, '$.b[0]', 0) from t where a = 7",
    "select json_merge_patch(j, '{\"a\": null, \"z\": 1}') from t where a = 7",
    "select json_merge_preserve(j, '{\"a\": 7}') from t where a = 7",
    "select json_contains_path(j, 'one', '$.a') from t where a = 7",
    "select json_contains_path(j, 'all', '$.a', '$.q') from t where a = 7",
    "select json_overlaps(j, '{\"a\": 1}') from t where a = 7",
    "select json_storage_size(j) from t where a = 7",
    "select json_search(d, 'one', 'hello'), json_search(d, 'all', 'hello') from js",
    "select json_pretty(d) from js",
    "select hex(aes_encrypt(s, 'key')) from t",
    "select aes_decrypt(aes_encrypt(s, 'key'), 'key') from t where a = 5",
    "select aes_decrypt(aes_encrypt(s, 'key'), 'nope') from t where a = 5",
    "select uncompress(compress(s)) from t where a = 7",
    "select uncompressed_length(compress(s)) from t where a = 7",
    "select inet6_ntoa(inet6_aton('::1')), inet6_ntoa(inet6_aton('1.2.3.4'))",
    "select is_ipv4('1.2.3.4'), is_ipv4('::1'), is_ipv6('::1'), is_ipv6('1.2.3.4')",
    "select is_ipv4_compat(inet6_aton('::1.2.3.4')), is_ipv4_mapped(inet6_aton('::ffff:1.2.3.4'))",
    "select bin_to_uuid(uuid_to_bin('6ccd780c-baba-1026-9564-5b8c656024db'))",
    "select inet6_ntoa(inet6_aton(s)), is_ipv4(s), hex(inet6_aton(s)) from t",
    "select count(*) from t where json_extract(j, '$.a') = '1'",
    "select regexp_substr(s, '[a-z]+') as w, count(*) from t group by w order by w",
]


@pytest.mark.parametrize("sql", STATEMENTS)
def test_statement_matches_jax(pair, sql):
    pair.run(sql)
