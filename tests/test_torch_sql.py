"""The port's SQL engine (``arkflow_tpu_torch/sql/``) against the JAX
engine (``arkflow_tpu/sql/``) on the same batches.

Every scenario of ``tests/test_sql.py`` runs once through each package:
the same tables, built from the same Python values (numpy-seeded where
random), the same query, and the result's column names, Arrow types
(``type_name`` against ``str(pa.DataType)``), values and row order must be
equal. Floats are compared exactly (both engines run the same IEEE
operations in the same order), except the aggregates marked ``REL``: a
grouped or windowed mean, variance or stddev, held within 1e-12 relative.
A join without ORDER BY has no defined row order in JAX (Acero's), and
neither has a GROUP BY or DISTINCT over many distinct or several keys
(pyarrow's hash table order; for few distinct keys it is the order of
first appearance, which the port always gives), so such results are
compared as sorted multisets (``unordered``). Where the JAX
result repeats a column name, the port writes ``name:1`` (a port batch
holds a name once), as both fallbacks do.

Then the ``pyarrow.compute`` semantics the port copies, each held to JAX's:
integer division, overflow, casts, rounding, Kleene logic, group order and
population statistics; a seeded differential sweep of expressions; the
hypothesis properties of ``tests/test_properties.py``; the remap processor
of ``tests/test_obs_and_misc.py``; and BASELINE config 1
(``generate -> json_to_arrow -> sql -> arrow_to_json``) as a stream.
"""

from __future__ import annotations

import asyncio
import json
import math

import numpy as np
import pyarrow as pa
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import arkflow_tpu.sql.engine as jax_engine
import arkflow_tpu_torch.sql.engine as port_engine
from arkflow_tpu.batch import MessageBatch as JaxBatch
from arkflow_tpu.components import Resource as JaxResource
from arkflow_tpu.components import build_component as jax_build
from arkflow_tpu.components import ensure_plugins_loaded as jax_plugins
from arkflow_tpu.errors import ArkError as JaxArkError
from arkflow_tpu.sql import SessionContext as JaxContext
from arkflow_tpu.sql import evaluate_expression as jax_evaluate
from arkflow_tpu.sql import functions as jax_functions
from arkflow_tpu_torch.batch import MessageBatch, column_to_pylist
from arkflow_tpu_torch.components import Resource, build_component, ensure_plugins_loaded
from arkflow_tpu_torch.errors import ArkError, UnsupportedSql
from arkflow_tpu_torch.sql import ContextPool, SessionContext, evaluate_expression
from arkflow_tpu_torch.sql import functions as port_functions
from arkflow_tpu_torch.sql.arrays import float_to_str
from arkflow_tpu_torch.sql.parser import assert_query_only, parse_select

jax_plugins()
ensure_plugins_loaded()

#: the relative tolerance of aggregates whose float summation order differs
#: between the engines (hash and window means, variances, deviations)
REL = 1e-12


# -- helpers ---------------------------------------------------------------------


def tables_of(tables: dict) -> tuple[JaxContext, SessionContext]:
    """The same tables (name -> pydict, or -> (jax batch, port batch)) in a
    JAX context and a port context."""
    jctx, pctx = JaxContext(), SessionContext()
    for name, data in tables.items():
        if isinstance(data, tuple):
            jb, pb = data
        else:
            jb, pb = JaxBatch.from_pydict(data), MessageBatch.from_pydict(data)
        jctx.register_batch(name, jb)
        pctx.register_batch(name, pb)
    return jctx, pctx


def _renamed(names: list[str]) -> list[str]:
    seen: dict[str, int] = {}
    out = []
    for nm in names:
        if nm in seen:
            seen[nm] += 1
            out.append(f"{nm}:{seen[nm]}")
        else:
            seen[nm] = 0
            out.append(nm)
    return out


def _value_eq(a, b, rel: float) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        if math.isnan(a) or math.isnan(b):
            return math.isnan(a) and math.isnan(b)
        if rel:
            return math.isclose(a, b, rel_tol=rel, abs_tol=0.0)
        return a == b and math.copysign(1, a) == math.copysign(1, b)
    if isinstance(a, list) and isinstance(b, list):
        return len(a) == len(b) and all(_value_eq(x, y, rel) for x, y in zip(a, b))
    return type(a) is type(b) and a == b


def _sort_key(row):
    return tuple((v is None, repr(v)) for v in row)


def assert_same(jout: JaxBatch, pout: MessageBatch, *, unordered: bool = False,
                rel_cols: tuple = ()) -> None:
    """Names, Arrow types and values equal (rows as sets when unordered)."""
    rb = jout.record_batch
    assert pout.column_names == _renamed(rb.schema.names)
    assert list(pout.schema.values()) == [str(f.type) for f in rb.schema]
    jcols = [c.to_pylist() for c in rb.columns]
    pcols = [column_to_pylist(pout.column(n)) for n in pout.column_names]
    assert pout.num_rows == rb.num_rows
    if unordered:
        jrows = sorted(zip(*jcols), key=_sort_key) if jcols else []
        prows = sorted(zip(*pcols), key=_sort_key) if pcols else []
        jcols = [list(c) for c in zip(*jrows)] if jrows else jcols
        pcols = [list(c) for c in zip(*prows)] if prows else pcols
    for name, jc, pc_ in zip(rb.schema.names, jcols, pcols):
        rel = REL if name in rel_cols else 0.0
        assert len(jc) == len(pc_)
        for x, y in zip(jc, pc_):
            assert _value_eq(x, y, rel), (name, jc, pc_)


def both_sql(tables: dict, query: str, **kw) -> tuple[JaxBatch, MessageBatch]:
    jctx, pctx = tables_of(tables)
    jout, pout = jctx.sql(query), pctx.sql(query)
    assert_same(jout, pout, **kw)
    return jout, pout


def no_fallback(monkeypatch) -> None:
    """Fail if a query of either engine routes to the sqlite fallback."""
    def boom(q, t):
        raise AssertionError(f"query fell back to sqlite: {q}")

    monkeypatch.setattr(jax_engine, "execute_fallback", boom)
    monkeypatch.setattr(port_engine, "execute_fallback", boom)


def both_raise(fn_jax, fn_port, jax_exc=Exception, port_exc=Exception):
    with pytest.raises(jax_exc):
        fn_jax()
    with pytest.raises(port_exc):
        fn_port()


def both_eval(data: dict, expr: str) -> tuple[list, list]:
    """``evaluate_expression`` on the same batch; the values and types held equal."""
    jarr = jax_evaluate(JaxBatch.from_pydict(data), expr)
    pcol = evaluate_expression(MessageBatch.from_pydict(data), expr)
    pb = MessageBatch({"x": pcol})
    assert pb.schema["x"] == str(jarr.type), (expr, pb.schema["x"], jarr.type)
    j, p = jarr.to_pylist(), column_to_pylist(pcol)
    assert len(j) == len(p) and all(_value_eq(x, y, 0.0) for x, y in zip(j, p)), (expr, j, p)
    return j, p


# -- the scenarios of tests/test_sql.py ------------------------------------------

FLOW = {"id": [1, 2, 3, 4, 5], "temp": [20.5, 31.0, 18.2, 35.5, 25.0],
        "city": ["sf", "la", "sf", "ny", "la"]}
ORDERS = {"oid": [1, 2, 3, 4, 5], "cust": [10, 20, 10, 30, None],
          "amount": [5.0, 7.5, 2.5, 9.0, 1.0]}
CUSTOMERS = {"cid": [10, 20, 40], "name": ["ada", "bob", "cyd"]}
JOINS = {"orders": ORDERS, "customers": CUSTOMERS}
WIN = {"t": {"g": ["a", "a", "a", "b", "b"], "x": [3, 1, 2, 5, 4],
             "v": [10.0, 20.0, 30.0, 40.0, 50.0]}}
RESID = {"a": {"k": [1, 2, 3], "x": [10, 20, 30]},
         "b": {"k": [1, 1, 2, 4], "y": [5, 15, 100, 7]}}


def _long_partition() -> dict:
    rng = np.random.RandomState(0)
    v = rng.randn(500)
    return {"u": {"x": list(range(500)),
                  "v": [None if i % 7 == 0 else float(v[i]) for i in range(500)]}}


def _meta_tables() -> dict:
    jb = JaxBatch.new_binary([b"a", b"b"]).with_source("kafka:t").with_offset(7)
    pb = MessageBatch.new_binary([b"a", b"b"]).with_source("kafka:t").with_offset(7)
    return {"flow": (jb, pb)}


#: (the tests/test_sql.py test, tables, queries, options); ``native`` runs
#: with the fallback patched to fail in both engines, as ``_no_fallback`` does
QUERY_CASES = [
    ("select_star", {"flow": FLOW}, ["SELECT * FROM flow"], {}),
    ("projection_and_alias", {"flow": FLOW}, ["SELECT id, temp * 2 AS t2 FROM flow LIMIT 2"], {}),
    ("where_filter", {"flow": FLOW}, ["SELECT id FROM flow WHERE temp > 30"], {}),
    ("where_and_or_in_like", {"flow": FLOW}, [
        "SELECT id FROM flow WHERE city IN ('sf', 'ny') AND temp < 21",
        "SELECT id FROM flow WHERE city LIKE 's%' OR temp >= 35",
        "SELECT id FROM flow WHERE city NOT IN ('sf') AND NOT temp > 30"], {}),
    ("between_case_cast", {"flow": FLOW}, [
        "SELECT id, CASE WHEN temp BETWEEN 20 AND 30 THEN 'ok' ELSE 'out' END AS band, "
        "CAST(temp AS int) AS t FROM flow ORDER BY id"], {}),
    ("order_by_desc_limit_offset", {"flow": FLOW},
     ["SELECT id FROM flow ORDER BY temp DESC LIMIT 2 OFFSET 1"], {}),
    ("group_by_aggregates", {"flow": FLOW}, [
        "SELECT city, count(*) AS n, avg(temp) AS avg_t, max(temp) AS mx "
        "FROM flow GROUP BY city ORDER BY city"], {"rel_cols": ("avg_t",)}),
    ("global_aggregate", {"flow": FLOW}, ["SELECT count(*) AS n, sum(temp) AS s FROM flow"], {}),
    ("scalar_over_aggregate", {"flow": FLOW},
     ["SELECT sum(temp) / count(*) AS mean_t FROM flow"], {}),
    ("having", {"flow": FLOW}, [
        "SELECT city, count(*) AS n FROM flow GROUP BY city HAVING count(*) > 1 ORDER BY city"],
     {}),
    ("distinct", {"flow": FLOW}, ["SELECT DISTINCT city FROM flow ORDER BY city"], {}),
    ("string_functions", {"flow": FLOW},
     ["SELECT upper(city) AS u, length(city) AS l FROM flow WHERE id = 1"], {}),
    ("join_routes_to_fallback", {"a": {"k": [1, 2, 3], "x": ["a", "b", "c"]},
                                 "b": {"k": [2, 3, 4], "y": [20, 30, 40]}},
     ["SELECT a.k, a.x, b.y FROM a JOIN b ON a.k = b.k ORDER BY a.k"], {}),
    ("subquery_fallback", {"flow": FLOW},
     ["SELECT id FROM (SELECT id, temp FROM flow WHERE temp > 30) ORDER BY id"], {}),
    ("window_function_fallback", {"flow": FLOW}, [
        "SELECT id, row_number() OVER (PARTITION BY city ORDER BY temp) AS rn "
        "FROM flow ORDER BY id"], {}),
    ("json_get", {"flow": ({}, {})}, [], {}),  # filled below: a binary payload table
    ("select_without_from", {}, ["SELECT 1 + 1 AS a, upper('x') AS b"], {}),
    ("null_semantics", {"flow": {"x": [1, None, 3]}}, [
        "SELECT x FROM flow WHERE x IS NOT NULL", "SELECT coalesce(x, 0) AS x0 FROM flow"], {}),
    ("meta_columns_queryable", None,
     ["SELECT __meta_source, __meta_offset FROM flow WHERE __meta_offset = 7"], {}),
    ("native_inner_join", JOINS, [
        "SELECT o.oid, c.name FROM orders o JOIN customers c ON o.cust = c.cid "
        "ORDER BY o.oid"], {"native": True}),
    ("native_left_right_full_joins", JOINS, [
        "SELECT oid, name FROM orders o LEFT JOIN customers c ON o.cust = c.cid ORDER BY oid",
        "SELECT name, oid FROM orders o RIGHT JOIN customers c ON o.cust = c.cid ORDER BY name",
        ("SELECT oid, name FROM orders o FULL OUTER JOIN customers c ON o.cust = c.cid",
         {"unordered": True})], {"native": True}),
    ("join_null_keys_never_match", {"l": {"k": [1, None]}, "r": {"k2": [1, None], "v": [5, 6]}},
     [("SELECT l.k, r.v FROM l JOIN r ON l.k = r.k2", {"unordered": True})], {"native": True}),
    ("cross_join_and_non_equi", JOINS, [
        "SELECT count(*) AS n FROM orders CROSS JOIN customers",
        "SELECT o.oid, c.cid FROM orders o JOIN customers c "
        "ON o.cust = c.cid AND o.amount > 3 ORDER BY oid"], {"native": True}),
    ("join_with_aggregate_and_expr_keys", JOINS, [
        "SELECT c.name, sum(o.amount) AS total FROM orders o JOIN customers c "
        "ON o.cust = c.cid GROUP BY c.name ORDER BY c.name",
        "SELECT o.oid FROM orders o JOIN customers c ON o.cust + 0 = c.cid ORDER BY oid"],
     {"native": True}),
    ("join_star_and_qualified_star", JOINS, [
        ("SELECT * FROM orders o JOIN customers c ON o.cust = c.cid", {"unordered": True}),
        ("SELECT c.* FROM orders o JOIN customers c ON o.cust = c.cid", {"unordered": True})],
     {"native": True}),
    ("three_way_join", {**JOINS, "regions": {"rcid": [10, 20], "region": ["eu", "us"]}}, [
        "SELECT o.oid, c.name, r.region FROM orders o JOIN customers c ON o.cust = c.cid "
        "JOIN regions r ON c.cid = r.rcid ORDER BY o.oid"], {"native": True}),
    ("outer_join_with_residual_falls_back", JOINS, [
        "SELECT o.oid, c.name FROM orders o LEFT JOIN customers c "
        "ON o.cust = c.cid AND o.amount > 3 ORDER BY o.oid"], {}),
    ("window_row_number_rank_dense_rank", WIN, [
        "SELECT g, x, row_number() OVER (PARTITION BY g ORDER BY x) AS rn FROM t ORDER BY g, x",
        "SELECT x, rank() OVER (ORDER BY g) AS r, dense_rank() OVER (ORDER BY g) AS dr "
        "FROM t ORDER BY x"], {"native": True}),
    ("window_running_and_whole_partition_aggregates", WIN, [
        "SELECT g, x, sum(v) OVER (PARTITION BY g ORDER BY x) AS rs, "
        "sum(v) OVER (PARTITION BY g) AS tot, count(*) OVER () AS n, "
        "avg(v) OVER (PARTITION BY g) AS m FROM t ORDER BY g, x"],
     {"native": True, "rel_cols": ("m",)}),
    ("window_running_sum_ties_share_value", {"t": {"k": [1, 1, 2], "v": [10, 20, 30]}},
     ["SELECT k, sum(v) OVER (ORDER BY k) AS rs FROM t ORDER BY k, v"], {"native": True}),
    ("window_lag_lead_first_last_ntile", WIN, [
        "SELECT g, x, lag(x) OVER (PARTITION BY g ORDER BY x) AS p, "
        "lead(x, 1, -1) OVER (PARTITION BY g ORDER BY x) AS nx, "
        "first_value(v) OVER (PARTITION BY g ORDER BY x) AS fv, "
        "last_value(v) OVER (PARTITION BY g ORDER BY x) AS lv, "
        "ntile(2) OVER (ORDER BY x) AS b FROM t ORDER BY g, x"], {"native": True}),
    ("window_sum_of_ints_stays_integer", {"t": {"v": [1, 2, 3]}},
     ["SELECT sum(v) OVER () AS s FROM t"], {"native": True}),
    ("window_nulls_ignored_in_aggregates", {"t": {"g": ["a", "a", "b"], "v": [1.0, None, None]}},
     ["SELECT g, sum(v) OVER (PARTITION BY g) AS s, count(v) OVER (PARTITION BY g) AS c "
      "FROM t ORDER BY g"], {"native": True}),
    ("window_min_max_whole_partition", WIN, [
        "SELECT g, min(v) OVER (PARTITION BY g) AS lo, max(v) OVER (PARTITION BY g) AS hi "
        "FROM t ORDER BY g, x"], {"native": True}),
    ("window_in_order_by_and_unsupported_falls_back", WIN, [
        "SELECT x FROM t ORDER BY row_number() OVER (ORDER BY x DESC)",
        "SELECT min(v) OVER (ORDER BY x) AS m FROM t ORDER BY x",
        "SELECT x, sum(v) OVER (ORDER BY x ROWS BETWEEN 1 PRECEDING AND CURRENT ROW) AS s "
        "FROM t ORDER BY x"], {}),
    ("window_running_min_max_native", WIN, [
        "SELECT g, x, min(v) OVER (PARTITION BY g ORDER BY x) AS lo, "
        "max(v) OVER (PARTITION BY g ORDER BY x) AS hi FROM t ORDER BY g, x"], {"native": True}),
    ("window_running_min_with_nulls_and_long_partition", _long_partition(),
     ["SELECT min(v) OVER (ORDER BY x) AS m FROM u ORDER BY x"], {"native": True}),
    ("window_aggregates_nan_semantics", {"t": {"x": [1, 2, 3], "v": [5.0, float("nan"), 1.0]}},
     ["SELECT sum(v) OVER (ORDER BY x) AS s, avg(v) OVER (ORDER BY x) AS a, "
      "min(v) OVER (ORDER BY x) AS lo, max(v) OVER (ORDER BY x) AS hi FROM t ORDER BY x"],
     {"native": True}),
    ("outer_joins_with_residual_conditions", RESID, [
        "SELECT a.k, a.x, b.y FROM a LEFT JOIN b ON a.k = b.k AND b.y < a.x ORDER BY a.k, b.y",
        "SELECT b.k, b.y, a.x FROM a RIGHT JOIN b ON a.k = b.k AND b.y < a.x "
        "ORDER BY b.k, b.y",
        "SELECT a.k AS ak, b.k AS bk FROM a FULL JOIN b ON a.k = b.k AND b.y < a.x "
        "ORDER BY a.k, b.y, b.k"], {"native": True}),
    ("window_sum_avg_infinity_semantics", {"t": {
        "g": [1, 2, 2, 2], "x": [1, 1, 2, 3], "v": [float("inf"), 1.0, float("-inf"), 2.0]}}, [
        "SELECT sum(v) OVER (PARTITION BY g ORDER BY x) AS s FROM t ORDER BY g, x",
        "SELECT max(v) OVER (PARTITION BY g) AS m FROM t ORDER BY g, x"], {"native": True}),
    ("join_null_typed_key_falls_back", {"a": {"k": [None, None], "x": [1, 2]},
                                        "b": {"k": [1, 2], "y": [10, 20]}},
     ["SELECT a.x, b.y FROM a LEFT JOIN b ON a.k = b.k AND b.y > a.x ORDER BY a.x"], {}),
]


@pytest.mark.parametrize("name,tables,queries,opts", QUERY_CASES,
                         ids=[c[0] for c in QUERY_CASES])
def test_sql_scenarios_match_jax(name, tables, queries, opts, monkeypatch):
    if name == "json_get":
        payloads = [b'{"a": {"b": 3}}', b'{"a": {"b": 7}}']
        tables = {"flow": (JaxBatch.new_binary(payloads), MessageBatch.new_binary(payloads))}
        queries = ["SELECT json_get_int(__value__, 'a.b') AS v FROM flow"]
    if tables is None:
        tables = _meta_tables()
    opts = dict(opts)
    if opts.pop("native", False):
        no_fallback(monkeypatch)
    for q in queries:
        q, extra = (q, {}) if isinstance(q, str) else q
        both_sql(tables, q, **opts, **extra)


# -- the scenarios that are not one query ------------------------------------------


def _ddl_rejected():
    jctx, pctx = tables_of({"flow": FLOW})
    for q in ["DROP TABLE flow", "INSERT INTO flow VALUES (1)", "create table x (a int)"]:
        both_raise(lambda: jctx.sql(q), lambda: pctx.sql(q), port_exc=UnsupportedSql)


def _unknown_table():
    jctx, pctx = tables_of({"flow": FLOW})
    both_raise(lambda: jctx.sql("SELECT * FROM nonexistent"),
               lambda: pctx.sql("SELECT * FROM nonexistent"), JaxArkError, ArkError)


def _scalar_udf_native_and_fallback():
    fn = lambda x: None if x is None else x * 2  # noqa: E731
    jax_functions.register_scalar_udf("double_it", fn)
    port_functions.register_scalar_udf("double_it", fn)
    both_sql({"flow": FLOW}, "SELECT double_it(id) AS d FROM flow ORDER BY id")
    both_sql({"flow": FLOW}, "SELECT double_it(id) AS d FROM (SELECT id FROM flow) ORDER BY d")


def _aggregate_udf_fallback():
    fn = lambda vals: sorted(vals)[len(vals) // 2] if vals else None  # noqa: E731
    jax_functions.register_aggregate_udf("median_agg", fn)
    port_functions.register_aggregate_udf("median_agg", fn)
    both_sql({"flow": FLOW}, "SELECT median_agg(temp) AS m FROM (SELECT temp FROM flow)")


def _json_get_schema_stable_across_batches():
    q = "SELECT json_get(__value__, 'v') AS v FROM flow"
    for payloads in ([b'{"v": 1}', b'{"v": 2}'], [b'{"v": 1}', b'{"v": "x"}']):
        _, pout = both_sql({"flow": (JaxBatch.new_binary(payloads),
                                     MessageBatch.new_binary(payloads))}, q)
        assert pout.schema["v"] == "string"
    both_sql({"flow": (JaxBatch.new_binary([b'{"v": 1}']),
                       MessageBatch.new_binary([b'{"v": 1}']))},
             "SELECT json_get_dyn(__value__, 'v') AS v FROM flow")


def _evaluate_expression():
    assert both_eval({"x": [1, 2, 3]}, "x * 10 + 1")[1] == [11, 21, 31]
    assert both_eval({"x": [1, 2, 3]}, "'t-' || cast(x as string)")[1] == ["t-1", "t-2", "t-3"]


def _assert_query_only():
    from arkflow_tpu.sql.parser import assert_query_only as jax_aqo

    jax_aqo("SELECT 1")
    assert_query_only("SELECT 1")
    both_raise(lambda: jax_aqo("  DELETE FROM flow"), lambda: assert_query_only("  DELETE FROM flow"),
               port_exc=UnsupportedSql)


def _parse_error_is_unsupported():
    from arkflow_tpu.sql.parser import parse_select as jax_parse

    q = "SELECT a FROM t WHERE a > 1"
    assert repr(parse_select(q)).replace("arkflow_tpu_torch", "arkflow_tpu") == repr(jax_parse(q))
    both_raise(lambda: jax_parse("SELECT FROM WHERE"), lambda: parse_select("SELECT FROM WHERE"),
               port_exc=UnsupportedSql)


def _context_pool():
    from arkflow_tpu.sql import ContextPool as JaxPool

    async def go(pool, batch_cls):
        async def q(i):
            async with pool.acquire() as ctx:
                ctx.register_batch("flow", batch_cls.from_pydict({"x": [i]}))
                out = ctx.sql("SELECT x + 1 AS y FROM flow")
                await asyncio.sleep(0.01)
                return out.to_pydict()["y"][0]

        return await asyncio.gather(*[q(i) for i in range(10)])

    want = asyncio.run(go(JaxPool(2), JaxBatch))
    assert asyncio.run(go(ContextPool(2), MessageBatch)) == want == [i + 1 for i in range(10)]


def _sql_injection_guards():
    import os
    import tempfile

    jctx, pctx = tables_of({"flow": FLOW})
    evil = os.path.join(tempfile.mkdtemp(), "evil_attach.db")
    for q in [f"/**/ATTACH DATABASE '{evil}' AS x", "-- hi\nDELETE FROM flow",
              "WITH t AS (SELECT 1 AS a) DELETE FROM flow"]:
        both_raise(lambda: jctx.sql(q), lambda: pctx.sql(q), JaxArkError, ArkError)
    assert not os.path.exists(evil)
    both_sql({"flow": FLOW},
             "WITH t AS (SELECT id FROM flow WHERE temp > 30) SELECT count(*) AS n FROM t")


VRL_DATA = {
    "s": ["42", "x", None, " 7 "],
    "hexs": ["ff", "zz", "10", None],
    "log": ["level=info msg=ok", "level=error msg=boom", "nope", None],
    "url": ["https://u@api.example:8443/v1/x?q=1", "bad", None, "http://h/p"],
    "ts": ["2026-07-29T10:00:00", "garbage", None, "1999-01-01T00:00:00"],
}


def _vrl_style_parse_functions():
    for expr in ["coalesce(parse_int(s), 0)", "parse_int(hexs, 16)", "parse_float(s)",
                 "parse_key_value(log, 'level')", "parse_url(url, 'host')",
                 "parse_url(url, 'port')", "parse_timestamp(ts, '%Y-%m-%dT%H:%M:%S')",
                 "format_timestamp(parse_timestamp(ts, '%Y-%m-%dT%H:%M:%S'), "
                 "'%Y-%m-%dT%H:%M:%S')", "regex_match(log, 'level=err')",
                 "regex_extract(log, 'msg=(\\w+)')", "length(sha256(s))",
                 "to_string(parse_int(s))", "md5(s)",
                 "parse_syslog('<34>1 2026-01-01T00:00:00Z host app 12 ID47 - hi', 'severity')",
                 "parse_syslog(log, 'message')"]:
        both_eval(VRL_DATA, expr)


def _vrl_style_conditional_in_remap():
    cfg = {"type": "remap", "mappings": {
        "severity": "CASE WHEN parse_key_value(__value___s, 'level') = 'error' "
                    "THEN 2 ELSE 1 END"}}
    data = {"__value___s": ["level=error", "level=info"]}
    jout = asyncio.run(jax_build("processor", cfg, JaxResource()).process(
        JaxBatch.from_pydict(data)))[0]
    pout = asyncio.run(build_component("processor", cfg, Resource()).process(
        MessageBatch.from_pydict(data)))[0]
    assert_same(jout, pout)
    assert pout.to_pydict()["severity"] == [2, 1]


def _fallible_parsers_never_abort_the_batch():
    data = {"f": [float("inf"), 2.0], "big": [1e20, 0.0], "log": ["msg=hi", "msg=yo"]}
    assert both_eval(data, "parse_int(f)")[1] == [None, 2]
    assert both_eval(data, "format_timestamp(big)")[1][0] is None
    assert both_eval(data, "regex_extract(log, 'msg=(\\w+)', 2)")[1] == [None, None]


SPECIAL_CASES = {
    "ddl_rejected": _ddl_rejected,
    "unknown_table": _unknown_table,
    "scalar_udf_native_and_fallback": _scalar_udf_native_and_fallback,
    "aggregate_udf_fallback": _aggregate_udf_fallback,
    "json_get_schema_stable_across_batches": _json_get_schema_stable_across_batches,
    "evaluate_expression": _evaluate_expression,
    "assert_query_only": _assert_query_only,
    "parse_error_is_unsupported": _parse_error_is_unsupported,
    "context_pool": _context_pool,
    "sql_injection_guards": _sql_injection_guards,
    "vrl_style_parse_functions": _vrl_style_parse_functions,
    "vrl_style_conditional_in_remap": _vrl_style_conditional_in_remap,
    "fallible_parsers_never_abort_the_batch": _fallible_parsers_never_abort_the_batch,
}


@pytest.mark.parametrize("name", list(SPECIAL_CASES))
def test_sql_special_scenarios_match_jax(name):
    SPECIAL_CASES[name]()


def test_every_jax_sql_test_has_a_port_case():
    """The two lists above cover ``tests/test_sql.py`` test for test."""
    import re
    from pathlib import Path

    src = (Path(__file__).parent / "test_sql.py").read_text()
    jax_tests = set(re.findall(r"^(?:async )?def test_(\w+)\(", src, re.M))
    port = {c[0] for c in QUERY_CASES} | set(SPECIAL_CASES)
    assert len(jax_tests) == 54 and jax_tests == port


def test_a_vectorized_udf_gets_port_columns_where_jax_passes_arrow_arrays():
    """The known difference outside the numbers: a vectorized UDF receives
    the port's column (numpy for a column without nulls) where JAX passes a
    ``pa.Array``; a UDF written over numpy returns the same rows in both."""
    seen = {}

    def jax_fn(x):
        seen["jax"] = type(x)
        return pa.array(np.asarray(x) * 3)

    def port_fn(x):
        seen["port"] = type(x)
        return x * 3

    jax_functions.register_scalar_udf("triple_vec", jax_fn, vectorized=True)
    port_functions.register_scalar_udf("triple_vec", port_fn, vectorized=True)
    both_sql({"flow": FLOW}, "SELECT triple_vec(id) AS t FROM flow")
    assert issubclass(seen["jax"], pa.Array) and seen["port"] is np.ndarray


# -- the pyarrow.compute semantics the port copies --------------------------------------

SEMANTICS = [
    ("int_division_truncates", {"t": {"a": [-7, 7, 7, -7, 1], "b": [2, -2, 2, -2, 3]}},
     "SELECT a / b AS q FROM t"),
    ("int_min_over_minus_one", {"t": {"a": [-2 ** 63, 5], "b": [-1, -1]}},
     "SELECT a / b AS q FROM t"),
    ("scalar_division_is_python", {}, "SELECT 7 / 2 AS a, 7 / 0 AS b, -7 / 2 AS c"),
    ("float_division_by_zero", {"t": {"a": [1.0, -1.0, 0.0], "b": [0.0, 0.0, 0.0]}},
     "SELECT a / b AS q FROM t"),
    ("int64_add_wraps", {"t": {"a": [2 ** 63 - 1, -2 ** 63]}},
     "SELECT a + 1 AS s, a - 1 AS d, a * 2 AS m, -a AS n FROM t"),
    ("float_to_string", {"t": {"x": [1.0, 1e20, float("nan"), 0.1, 1e-7, 123456789.0, 1e15,
                                     -0.0, float("inf"), 2.5e-5, 1e-6, 9999999999.0, 1e10,
                                     1 / 3, -2.5, 1.2345678901234568e+18]}},
     "SELECT cast(x AS string) AS s FROM t"),
    ("float32_to_string", {"t": {"x": [1.0, 0.1, 123456.789, 1 / 3]}},
     "SELECT cast(cast(x AS real) AS string) AS s FROM t"),
    ("round_half_to_even", {"t": {"x": [0.6125, 2.5, 0.5, 1.5, -2.5, 1.005, 0.0005, 12.345,
                                        float("nan"), 1e300]}},
     "SELECT round(x, 3) AS r3, round(x) AS r0, round(x, -1) AS rm FROM t"),
    ("round_integers", {"t": {"i": [15, 25, -15, -25, 14, 7]}},
     "SELECT round(i, -1) AS r, round(i, 2) AS same FROM t"),
    ("alert_text_of_config_3", {"t": {"score": [0.61249, 0.6125, 0.5, 0.70001, 3.0, 12.9999]}},
     "SELECT 'anomaly: ' || cast(round(score, 3) as string) AS alert FROM t WHERE score > 0.5"),
    ("unsafe_float_to_int_truncates", {"t": {"x": [3.9, -3.9, 0.5, -0.5, 1e10]}},
     "SELECT cast(x AS int) AS i, cast(x AS smallint) AS s FROM t"),
    ("int_narrowing_wraps", {"t": {"i": [300, -1, 70000]}},
     "SELECT cast(i AS tinyint) AS b, cast(i AS smallint) AS s FROM t"),
    ("string_parses", {"t": {"s": ["1", "-2", "+4", "1e3", "inf", "2.5"]}},
     "SELECT cast(s AS double) AS d FROM t"),
    ("bool_text_and_back", {"t": {"b": [True, False, None], "s": ["true", "0", "FALSE"]}},
     "SELECT cast(b AS string) AS t, cast(s AS boolean) AS p FROM t"),
    ("group_order_and_population_stats", {"t": {
        "k": ["b", "a", "b", None, "c", "a", None], "v": [1.0, 2.0, 4.0, 3.0, 5.0, 6.0, 7.0]}},
     "SELECT k, count(*) AS n, stddev(v) AS sd, variance(v) AS var, first_value(v) AS f, "
     "last_value(v) AS l, min(v) AS lo FROM t GROUP BY k"),
    ("stddev_of_1_2_4", {"t": {"v": [1, 2, 4]}},
     "SELECT stddev(v) AS sd, variance(v) AS var, avg(v) AS m FROM t"),
    ("kleene_and_or", {"t": {"a": [True, True, True, False, False, False, None, None, None],
                             "b": [True, False, None, True, False, None, True, False, None]}},
     "SELECT a AND b AS x, a OR b AS y, NOT a AS z FROM t"),
    ("like_and_ilike", {"t": {"s": ["abc", "a_c", "ABC", None, "a%c", "xabc"]}},
     "SELECT s LIKE 'a%' AS l1, s LIKE 'a\\_c' AS l2, s ILIKE 'a%' AS l3, "
     "s LIKE '_b_' AS l4 FROM t"),
    ("in_list_nulls", {"t": {"x": [1, None, 3]}},
     "SELECT x IN (1, 2) AS a, x NOT IN (1) AS b, x IN (1, NULL) AS c FROM t"),
    ("case_null_condition", {"t": {"x": [1, None, 3]}},
     "SELECT CASE WHEN x > 1 THEN 'big' ELSE 'small' END AS c, "
     "CASE x WHEN 1 THEN 10 WHEN 3 THEN 2.5 END AS d FROM t"),
    ("order_nan_and_nulls", {"t": {"x": [2.0, float("nan"), None, 1.0, float("nan")],
                                   "i": [1, 2, 3, 4, 5]}},
     "SELECT i, x FROM t ORDER BY x DESC, i"),
    ("numeric_promotion", {"t": {"a": [1, 2], "f": [0.5, 1.5]}},
     "SELECT a + f AS s, a * 2 AS m, cast(a AS smallint) + cast(a AS tinyint) AS w, "
     "cast(a AS real) + a AS r FROM t"),
    ("math_types", {"t": {"i": [-1, 0, 4], "f": [-1.5, 0.0, 4.0]}},
     "SELECT floor(i) AS a, ceil(f) AS b, sqrt(i) AS c, sign(i) AS d, sign(f) AS e, "
     "abs(i) AS g, ln(i) AS h, power(i, 2) AS k, i % 3 AS m, f % 2 AS n FROM t"),
    ("string_kernels", {"t": {"s": ["Hello", " pad ", "é€x", None, "ab,cd,ef"]}},
     "SELECT length(s) AS l, octet_length(s) AS o, upper(s) AS u, lower(s) AS lo, "
     "trim(s) AS t, reverse(s) AS r, substr(s, 2, 2) AS sb, strpos(s, 'x') AS p, "
     "lpad(s, 7, '*') AS lp, replace(s, 'l', 'L') AS rp, starts_with(s, 'He') AS sw, "
     "concat(s, '-', 1, 2.5, true) AS c FROM t"),
    ("empty_global_aggregate", {"t": {"v": [1.0, 2.0]}},
     "SELECT count(*) AS n, sum(v) AS s, avg(v) AS m, min(v) AS lo, count(v) AS c "
     "FROM t WHERE v > 5"),
    ("grouped_sums_types", {"t": {"k": [1, 1, 2], "i": [1, 2, 3], "b": [True, False, True],
                                  "f": [0.1, 0.2, 0.3]}},
     "SELECT k, sum(i) AS si, sum(b) AS sb, sum(f) AS sf, count(DISTINCT i) AS cd, "
     "min(b) AS mb, max(i) AS mi FROM t GROUP BY k"),
]


@pytest.mark.parametrize("name,tables,query", SEMANTICS, ids=[c[0] for c in SEMANTICS])
def test_pyarrow_semantics_match_jax(name, tables, query):
    both_sql(tables, query)


def test_integer_division_by_zero_raises_in_both():
    jctx, pctx = tables_of({"t": {"a": [1, 2], "b": [1, 0]}})
    both_raise(lambda: jctx.sql("SELECT a / b AS q FROM t"),
               lambda: pctx.sql("SELECT a / b AS q FROM t"), pa.ArrowInvalid, ArkError)
    # a null divisor's row is not divided
    both_sql({"t": {"a": [1, 2], "b": [1, None]}}, "SELECT a / b AS q FROM t")


@pytest.mark.parametrize("tables,query", [
    ({"t": {"i": [2 ** 60, 1], "f": [0.5, 1.5]}}, "SELECT i + f AS s FROM t"),
    ({"t": {"i": [2 ** 60, 1]}}, "SELECT i IN (1, 0.5) AS x FROM t"),
    ({"t": {"f": [float("nan"), 1.5]}}, "SELECT f % 2 AS m FROM t"),
    ({"t": {"f": [1e20, 1.5]}}, "SELECT f % 2 AS m FROM t"),
], ids=["int64_past_2_53_into_double", "is_in_promotes_safely", "mod_of_nan", "mod_past_int64"])
def test_implicit_casts_are_safe_as_in_jax(tables, query):
    """Arrow's implicit casts check what they convert: an int64 past 2^53
    into double, or a NaN or out-of-range float into ``mod``'s int64
    quotient, raises in both engines (a safe cast), where the explicit
    ``CAST`` truncates."""
    jctx, pctx = tables_of(tables)
    both_raise(lambda: jctx.sql(query), lambda: pctx.sql(query), pa.ArrowInvalid, ArkError)
    both_sql({"t": {"i": [2 ** 60, 1], "f": [float("nan"), 1e20]}},
             "SELECT cast(i AS double) AS d, cast(f AS int) AS n FROM t")


@pytest.mark.parametrize("x", [1.0, 1e20, 1e21, 1e-5, 1e-7, 0.612, 3.0e-4, 1e16, 100.0,
                               12345678901234567.0, 0.00001234, 5e-324, 1.7976931348623157e308,
                               -1e-6, 123456.789])
def test_float_text_is_arrows(x):
    want = pa.compute.cast(pa.array([x]), pa.string()).to_pylist()[0]
    assert float_to_str(x) == want
    want32 = pa.compute.cast(pa.array([x], pa.float32()), pa.string()).to_pylist()[0]
    assert float_to_str(float(np.float32(x)), single=True) == want32



def test_the_smokes_alert_text_is_arrows():
    """``chip_smoke.arrow_alert_text``, the card's check of config 3's
    alerts, worked apart from the port's engine, against pyarrow's
    ``cast(round(score, 3) as string)`` on float32 scores (the LSTM's
    reconstruction errors: below 1 and, for the scaled windows, in the
    hundreds): seeded sweeps of [0, 1) and [0, 1000), scores whose scaled
    value is an exact tie, and the ends of its range."""
    import chip_smoke

    ties = np.float32([0.0625, 0.5625, 0.6875, 0.8125, 0.9375, 0.6125, 0.0005, 223.5625,
                       100.0625])
    assert all((t * np.float32(1000)) % 1 == 0.5 for t in ties)
    rng = np.random.default_rng(3)
    scores = np.concatenate([rng.random(4000, dtype=np.float32),
                             rng.random(4000, dtype=np.float32) * np.float32(1000), ties,
                             np.float32([0, 0.5, 1, 0.9995, 0.99949, 1e-7, 999999940])])
    want = pa.compute.cast(pa.compute.round(pa.array(scores, pa.float32()), 3),
                           pa.string()).to_pylist()
    assert [chip_smoke.arrow_alert_text(x) for x in scores] == want
    with pytest.raises(ValueError):
        chip_smoke.arrow_alert_text(np.float32(1e10))


def _random_tables(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    n = 40
    ints = rng.integers(-50, 50, n).tolist()
    floats = np.round(rng.normal(0, 10, n), 3).tolist()
    words = ["alpha", "beta", "Gamma", "delta", "é", "", "a%b"]
    strs = [words[i] for i in rng.integers(0, len(words), n)]
    for i in rng.choice(n, 6, replace=False):
        ints[i] = None
    for i in rng.choice(n, 6, replace=False):
        floats[i] = None
    for i in rng.choice(n, 4, replace=False):
        strs[i] = None
    keys = [["x", "y", "z"][i] for i in rng.integers(0, 3, n)]
    return {"t": {"i": ints, "f": floats, "s": strs, "k": keys, "r": list(range(n))}}


SWEEP = [
    "SELECT i + 3 AS a, i * i AS b, i - f AS c, f / 4 AS d, -i AS e FROM t",
    "SELECT i > 0 AND f < 0 AS a, i IS NULL OR s = 'beta' AS b, NOT (i BETWEEN -5 AND 5) AS c "
    "FROM t",
    "SELECT coalesce(i, -1) AS a, nullif(k, 'x') AS b, greatest(i, f) AS c, least(i, 0) AS d "
    "FROM t",
    "SELECT cast(f AS string) AS a, cast(i AS double) AS b, cast(i AS string) AS c, "
    "cast(f AS int) AS d FROM t",
    "SELECT round(f, 1) AS a, round(f) AS b, floor(f) AS c, ceil(i) AS d, abs(f) AS e FROM t",
    "SELECT upper(s) AS a, length(s) AS b, s || '!' AS c, concat(s, i) AS d, s LIKE '%a%' AS e "
    "FROM t",
    "SELECT CASE WHEN i > 10 THEN 'hi' WHEN i < -10 THEN 'lo' ELSE s END AS a, "
    "CASE k WHEN 'x' THEN 1 ELSE 0 END AS b FROM t",
    "SELECT k, count(*) AS n, count(i) AS ni, sum(i) AS si, min(f) AS mn, max(s) AS ms, "
    "avg(i) AS ai FROM t GROUP BY k",
    "SELECT k, sum(f) AS sf, avg(f) AS af, stddev(f) AS sd FROM t GROUP BY k ORDER BY k",
    "SELECT count(*) AS n, sum(f) AS sf, avg(f) AS af, variance(f) AS v, min(i) AS mi, "
    "max(f) AS mf FROM t",
    "SELECT r, i FROM t WHERE i IN (1, 2, 3, -4) OR f > 5 ORDER BY f DESC, r LIMIT 7 OFFSET 2",
    # two keys: JAX's hash table order, no defined one (held as multisets)
    ("SELECT DISTINCT k, i > 0 AS pos FROM t", {"unordered": True}),
    ("SELECT i, count(*) AS n FROM t GROUP BY i", {"unordered": True}),
    "SELECT r, sum(i) OVER (PARTITION BY k ORDER BY r) AS rs, rank() OVER (ORDER BY i) AS rk, "
    "lag(f, 2) OVER (PARTITION BY k ORDER BY r) AS lg FROM t ORDER BY r",
    "SELECT k, count(*) AS n FROM t GROUP BY k HAVING sum(i) > 0 ORDER BY n DESC, k",
]


@pytest.mark.parametrize("seed", [0, 1])
def test_seeded_expression_sweep_matches_jax(seed):
    """Queries over seeded columns with nulls, NaN-free floats, repeated
    keys and odd strings: every column of each held to JAX's (grouped and
    global float aggregates within ``REL``)."""
    tables = _random_tables(seed)
    for q in SWEEP:
        q, extra = (q, {}) if isinstance(q, str) else q
        both_sql(tables, q, rel_cols=("af", "sd", "v", "ai", "sf"), **extra)


# -- tests/test_properties.py under hypothesis --------------------------------------------


@given(st.lists(st.integers(min_value=-1000, max_value=1000), min_size=1, max_size=40),
       st.integers(min_value=-1000, max_value=1000))
@settings(max_examples=40, deadline=None)
def test_sql_filter_matches_python_and_jax(values, threshold):
    q = f"SELECT v FROM flow WHERE v > {threshold}"
    _, pout = both_sql({"flow": {"v": values}}, q)
    assert pout.to_pydict()["v"] == [v for v in values if v > threshold]


@given(st.lists(st.integers(min_value=0, max_value=5), min_size=1, max_size=40))
@settings(max_examples=40, deadline=None)
def test_sql_group_by_matches_python_and_jax(keys):
    from collections import Counter

    _, pout = both_sql({"flow": {"k": keys}},
                       "SELECT k, count(*) AS n FROM flow GROUP BY k ORDER BY k")
    d = pout.to_pydict()
    assert list(zip(d["k"], d["n"])) == sorted(Counter(keys).items())


# -- remap (tests/test_obs_and_misc.py) -------------------------------------------------


def test_remap_processor_matches_jax():
    cfg = {"type": "remap", "where": "temp IS NOT NULL",
           "mappings": {"fahrenheit": "temp * 1.8 + 32", "dev": "upper(dev)"},
           "drop": ["temp"]}
    data = {"temp": [20.0, None, 35.0], "dev": ["a", "b", "c"]}
    jout = asyncio.run(jax_build("processor", cfg, JaxResource()).process(
        JaxBatch.from_pydict(data)))
    pout = asyncio.run(build_component("processor", cfg, Resource()).process(
        MessageBatch.from_pydict(data)))
    assert len(jout) == len(pout) == 1
    assert_same(jout[0], pout[0])
    assert pout[0].column_names == ["dev", "fahrenheit"]
    assert pout[0].to_pydict() == {"dev": ["A", "C"], "fahrenheit": [68.0, 95.0]}


def test_sql_processor_config_matches_jax():
    """The processor's build errors are JAX's; a binding names an unknown
    temporary (the port declares none yet) with JAX's message."""
    from arkflow_tpu.errors import ConfigError as JaxConfigError
    from arkflow_tpu_torch.errors import ConfigError

    for cfg in ({"type": "sql"},
                {"type": "sql", "query": "SELECT 1", "temporary": [{"name": "devices",
                                                                    "key": "id"}]}):
        with pytest.raises(JaxConfigError) as je:
            jax_build("processor", cfg, JaxResource())
        with pytest.raises(ConfigError) as pe:
            build_component("processor", cfg, Resource())
        assert str(pe.value) == str(je.value)
    both_raise(lambda: jax_build("processor", {"type": "sql", "query": "DROP TABLE flow"},
                                 JaxResource()),
               lambda: build_component("processor", {"type": "sql", "query": "DROP TABLE flow"},
                                       Resource()), port_exc=UnsupportedSql)


def test_sql_processor_runs_the_query_like_jax():
    cfg = {"type": "sql", "query": "SELECT id, temp FROM flow WHERE temp > 100"}
    j = jax_build("processor", cfg, JaxResource())
    p = build_component("processor", cfg, Resource())
    assert asyncio.run(j.process(JaxBatch.from_pydict(FLOW))) == []
    assert asyncio.run(p.process(MessageBatch.from_pydict(FLOW))) == []
    cfg = {"type": "sql", "query": "SELECT city, temp * 2 AS t FROM data ORDER BY t",
           "table_name": "data"}
    jout = asyncio.run(jax_build("processor", cfg, JaxResource()).process(
        JaxBatch.from_pydict(FLOW)))[0]
    pout = asyncio.run(build_component("processor", cfg, Resource()).process(
        MessageBatch.from_pydict(FLOW)))[0]
    assert_same(jout, pout)


# -- BASELINE config 1 as a stream -----------------------------------------------------


def _config1_stream() -> dict:
    """``examples/generate_example.yaml``'s stream: its payload, batch size,
    count, processors and query, with no interval and a collecting output."""
    return {"name": "sensor-filter",
            "input": {"type": "generate",
                      "payload": '{"sensor": "temperature", "value": 42.5, "station": "eu-1"}',
                      "interval": 0, "batch_size": 64, "count": 320},
            "pipeline": {"thread_num": 4, "processors": [
                {"type": "json_to_arrow"},
                {"type": "sql", "query": "SELECT sensor, value * 1.8 + 32 AS fahrenheit, "
                                         "station FROM flow WHERE value > 10"},
                {"type": "arrow_to_json"}]},
            "output": {"type": "drop"}}


def test_config1_stream_rows_equal_the_jax_streams():
    """generate -> json_to_arrow -> sql -> arrow_to_json through each
    package's stream: the same 320 JSON rows."""
    from arkflow_tpu.config import StreamConfig as JaxStreamConfig
    from arkflow_tpu.runtime import build_stream as jax_build_stream
    from arkflow_tpu_torch.config import StreamConfig
    from arkflow_tpu_torch.runtime.stream import build_stream
    from tests.test_runtime import CollectOutput as JaxCollect
    from tests.test_torch_stream import Collect

    raw = _config1_stream()
    jstream = jax_build_stream(JaxStreamConfig.from_mapping(raw))
    jsink = jstream.output = JaxCollect()
    asyncio.run(asyncio.wait_for(jstream.run(asyncio.Event()), 10))
    pstream = build_stream(StreamConfig.from_mapping(raw))
    psink = pstream.output = Collect()
    asyncio.run(asyncio.wait_for(pstream.run(asyncio.Event()), 10))
    want = [json.loads(v) for b in jsink.batches for v in b.column("__value__").to_pylist()]
    got = [json.loads(v) for b in psink.batches for v in b.to_binary()]
    assert len(got) == len(want) == 320
    assert sorted(map(json.dumps, got)) == sorted(map(json.dumps, want))
    assert got[0] == {"sensor": "temperature", "fahrenheit": 42.5 * 1.8 + 32, "station": "eu-1"}


def test_config1_runs_through_the_cli(capsys):
    """``python -m arkflow_tpu_torch --config
    arkflow_tpu_torch/examples/generate_example.json`` (config 1 as the YAML
    writes it, its health server on port 0): every row printed, each the
    JAX stream's row."""
    from arkflow_tpu_torch.runtime import cli

    assert cli.main(["--config", "arkflow_tpu_torch/examples/generate_example.json"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert len(lines) == 320
    assert all(r == {"sensor": "temperature", "fahrenheit": 42.5 * 1.8 + 32, "station": "eu-1"}
               for r in lines)
