"""sqlite3 fallback tier: full-dialect SQL over bridged batches.

Counterpart of ``arkflow_tpu/sql/fallback.py``, on the standard library's
``sqlite3`` as there. Covers what the native planner declines -- subqueries,
CTEs, UNION, explicit window frames -- by materialising registered batches
into an in-memory sqlite database, executing there, and lifting the result
columns back with ``column_from_pylist`` (the port's ``pa.array``
inference). Row-materialising and therefore slow; the native tier owns the
hot path. User UDFs are bridged via ``create_function``, so both tiers see
the same function surface. The connection is read-only once the tables are
loaded, and repeated output names are written ``a``, ``a:1``.
"""

from __future__ import annotations

import sqlite3
from typing import Any, Mapping

from arkflow_tpu_torch.batch import MessageBatch, column_from_pylist, column_to_pylist
from arkflow_tpu_torch.errors import ArkError
from arkflow_tpu_torch.sql import arrays as A
from arkflow_tpu_torch.sql.functions import (_AGGREGATE_UDFS, as_array, get_aggregate_udf,
                                             scalar_udfs, udf_result)
from arkflow_tpu_torch.sql.parser import assert_query_only


def _sqlite_type(t) -> str:
    if A.is_integer(t) or t == "bool":
        return "INTEGER"
    if A.is_floating(t):
        return "REAL"
    if t == "binary":
        return "BLOB"
    return "TEXT"


def _to_cell(v: Any) -> Any:
    if v is None or isinstance(v, (int, float, str, bytes)):
        return v
    if isinstance(v, bool):
        return int(v)
    return str(v)


_READONLY_OPS = {
    sqlite3.SQLITE_SELECT,
    sqlite3.SQLITE_READ,
    sqlite3.SQLITE_FUNCTION,
    sqlite3.SQLITE_RECURSIVE,
}


def _readonly_authorizer(action, *args):
    return sqlite3.SQLITE_OK if action in _READONLY_OPS else sqlite3.SQLITE_DENY


class _AggAdapter:
    """Bridges ``fn(list_of_values) -> scalar`` UDFs onto sqlite's step/finalize."""

    def __init__(self, fn):
        self.fn = fn
        self.values: list[Any] = []

    def step(self, *args):
        self.values.append(args[0] if len(args) == 1 else args)

    def finalize(self):
        return _to_cell(self.fn(self.values))


def execute_fallback(sql: str, tables: Mapping[str, MessageBatch]) -> MessageBatch:
    assert_query_only(sql)
    conn = sqlite3.connect(":memory:")
    try:
        conn.execute("PRAGMA temp_store=MEMORY")
        for name, batch in tables.items():
            _load_table(conn, name, batch)
        for name, (fn, vectorized) in scalar_udfs().items():
            conn.create_function(name, -1, _wrap_udf(fn, vectorized))
        for name in list(_AGGREGATE_UDFS):
            conn.create_aggregate(name, -1, _make_agg_class(get_aggregate_udf(name)))
        # defence in depth: after our own table loads, lock the connection to
        # read-only operations (blocks ATTACH/DDL/DML even if a statement
        # slips past assert_query_only)
        conn.set_authorizer(_readonly_authorizer)
        try:
            cur = conn.execute(sql)
        except sqlite3.Error as e:
            raise ArkError(f"SQL error (fallback engine): {e}") from e
        names = [d[0] for d in cur.description] if cur.description else []
        rows = cur.fetchall()
        cols = list(zip(*rows)) if rows else [[] for _ in names]
        # de-duplicate output names the way DataFusion would (a, a -> a, a:1)
        seen: dict[str, int] = {}
        out = {}
        for i, nm in enumerate(names):
            if nm in seen:
                seen[nm] += 1
                nm = f"{nm}:{seen[nm]}"
            else:
                seen[nm] = 0
            out[nm] = column_from_pylist(list(cols[i]) if rows else [])
        return MessageBatch(out, len(rows))
    finally:
        conn.close()


def _make_agg_class(fn):
    class Agg(_AggAdapter):
        def __init__(self):
            super().__init__(fn)

    return Agg


def _wrap_udf(fn, vectorized: bool):
    if not vectorized:
        return lambda *args: _to_cell(fn(*args))

    def call(*args):
        cols = [as_array(a, 1) for a in args]
        return _to_cell(udf_result(fn(*cols), 1).to_pylist()[0])

    return call


def _load_table(conn: sqlite3.Connection, name: str, batch: MessageBatch) -> None:
    qname = '"' + name.replace('"', '""') + '"'
    schema = [(c, A.from_column(batch.column(c)).type) for c in batch.column_names]
    col_defs = ", ".join(f'"{c}" {_sqlite_type(t)}' for c, t in schema)
    if not col_defs:
        col_defs = '"__empty__" INTEGER'
    conn.execute(f"CREATE TABLE {qname} ({col_defs})")
    if batch.num_rows == 0 or not schema:
        return
    placeholders = ", ".join("?" for _ in schema)
    cols = [column_to_pylist(batch.column(c)) for c, _ in schema]
    rows = [tuple(_to_cell(v) for v in row) for row in zip(*cols)]
    conn.executemany(f"INSERT INTO {qname} VALUES ({placeholders})", rows)
