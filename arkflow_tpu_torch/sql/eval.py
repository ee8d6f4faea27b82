"""Vectorized expression evaluation over the port's batches.

Counterpart of ``arkflow_tpu/sql/eval.py``: the parsed AST runs on the
kernels of ``sql/arrays.py`` (the JAX engine's ``pyarrow.compute``) over
whole columns. This is the engine behind WHERE clauses, projections, remap
mappings and ``{expr: ...}`` config values.

Evaluation returns either an ``Arr`` of the batch's length or a Python
scalar (literals and constant folds). Both tiers keep JAX's split: an
operator over two scalars computes in Python (``7 / 2`` is 3.5 and
``x / 0`` NULL), over a column in the array kernels (integer ``/``
truncates and a zero divisor raises).
"""

from __future__ import annotations

import functools
from typing import Any

from arkflow_tpu_torch.batch import Column, MessageBatch
from arkflow_tpu_torch.errors import UnsupportedSql
from arkflow_tpu_torch.sql import arrays as A
from arkflow_tpu_torch.sql import ast
from arkflow_tpu_torch.sql.arrays import Arr
from arkflow_tpu_torch.sql.functions import as_arr, call_scalar
from arkflow_tpu_torch.sql.parser import parse_expression

_SQL_TYPES: dict[str, Any] = {
    "int": "int64",
    "integer": "int64",
    "bigint": "int64",
    "smallint": "int32",
    "tinyint": "int8",
    "float": "double",
    "double": "double",
    "double precision": "double",
    "real": "float",
    "decimal": "double",
    "numeric": "double",
    "text": "string",
    "varchar": "string",
    "char": "string",
    "string": "string",
    "boolean": "bool",
    "bool": "bool",
    "binary": "binary",
    "blob": "binary",
    "bytea": "binary",
    "timestamp": "timestamp[us]",
    "date": "date32[day]",
}


def sql_type_to_arrow(name: str):
    """The type a SQL type name casts to, spelled as ``batch.py`` spells
    types (timestamp and date have no column kind in the port: a cast to
    them raises ``ComputeError``)."""
    t = _SQL_TYPES.get(name.lower())
    if t is None:
        raise UnsupportedSql(f"unknown SQL type {name!r}")
    return t


_CMP = ("=", "!=", "<", "<=", ">", ">=")
_ARITH = ("+", "-", "*", "/")


def _is_arr(v: Any) -> bool:
    return isinstance(v, Arr)


def _to_bool(v: Any, n: int) -> Arr:
    return A.to_bool(as_arr(v, n))


class Evaluator:
    """Evaluates AST expressions against one batch's columns.

    ``columns`` maps bare and table-qualified names to port columns or
    ``Arr``s, so the same evaluator serves single-table queries and join ON
    conditions. A port column is converted once, when first read."""

    def __init__(self, columns: dict[str, Any], num_rows: int):
        self.columns = columns
        self.n = num_rows
        self._arrs: dict[int, Arr] = {}

    @classmethod
    def for_batch(cls, batch: MessageBatch, table: str | None = None) -> "Evaluator":
        cols: dict[str, Column] = {}
        for name in batch.column_names:
            cols[name] = batch.column(name)
            if table:
                cols[f"{table}.{name}"] = batch.column(name)
        return cls(cols, batch.num_rows)

    def eval(self, e: ast.Expr) -> Any:
        m = getattr(self, f"_eval_{type(e).__name__.lower()}", None)
        if m is None:
            raise UnsupportedSql(f"cannot evaluate {type(e).__name__}")
        return m(e)

    def _arr(self, col: Any) -> Arr:
        if isinstance(col, Arr):
            return col
        got = self._arrs.get(id(col))
        if got is None:
            got = self._arrs[id(col)] = A.from_column(col)
        return got

    # -- node handlers -----------------------------------------------------

    def _eval_literal(self, e: ast.Literal) -> Any:
        return e.value

    def _eval_column(self, e: ast.Column) -> Arr:
        key = f"{e.table}.{e.name}" if e.table else e.name
        col = self.columns.get(key)
        if col is None and e.table is None:
            # case-insensitive fallback
            for k, v in self.columns.items():
                if k.lower() == e.name.lower():
                    return self._arr(v)
        if col is None:
            raise UnsupportedSql(f"no such column {key!r} (have: {sorted(self.columns)})")
        return self._arr(col)

    def _eval_unary(self, e: ast.Unary) -> Any:
        v = self.eval(e.operand)
        if e.op == "not":
            return A.invert(_to_bool(v, self.n))
        if e.op == "-":
            return A.negate(v) if _is_arr(v) else (None if v is None else -v)
        return v

    def _eval_binary(self, e: ast.Binary) -> Any:
        op = e.op
        if op == "and":
            return A.and_kleene(_to_bool(self.eval(e.left), self.n),
                                _to_bool(self.eval(e.right), self.n))
        if op == "or":
            return A.or_kleene(_to_bool(self.eval(e.left), self.n),
                               _to_bool(self.eval(e.right), self.n))
        l, r = self.eval(e.left), self.eval(e.right)
        if op in _CMP:
            if not _is_arr(l) and not _is_arr(r):
                return A.compare(op, A.broadcast(l, 1), A.broadcast(r, 1)).to_pylist()[0]
            return A.compare(op, *self._align(l, r))
        if op in _ARITH:
            if not _is_arr(l) and not _is_arr(r):
                if l is None or r is None:
                    return None
                if op == "+":
                    return l + r
                if op == "-":
                    return l - r
                if op == "*":
                    return l * r
                return None if r == 0 else l / r  # x/0 -> NULL (sqlite semantics)
            return A.arith(op, *self._align(l, r))
        if op == "%":
            return call_scalar("mod", [l, r], self.n)
        if op == "||":
            return call_scalar("concat", [l, r], self.n)
        if op in ("like", "ilike"):
            if _is_arr(r):
                raise UnsupportedSql("LIKE pattern must be a literal")
            return A.match_like(as_arr(l, self.n), str(r), ignore_case=(op == "ilike"))
        raise UnsupportedSql(f"unknown operator {op!r}")

    def _align(self, l: Any, r: Any) -> tuple[Arr, Arr]:
        """Broadcast a scalar against an array (a null scalar takes the
        array's type); numeric promotion is the kernels'."""
        if _is_arr(l) and not _is_arr(r):
            return l, A.broadcast(r, self.n, None if r is not None else l.type)
        if _is_arr(r) and not _is_arr(l):
            return A.broadcast(l, self.n, None if l is not None else r.type), r
        return l, r

    def _eval_isnull(self, e: ast.IsNull) -> Any:
        v = self.eval(e.operand)
        if not _is_arr(v):
            res = v is None
            return (not res) if e.negated else res
        return A.is_valid(v) if e.negated else A.is_null(v)

    def _eval_inlist(self, e: ast.InList) -> Any:
        v = as_arr(self.eval(e.operand), self.n)
        items = [self.eval(i) for i in e.items]
        if any(_is_arr(i) for i in items):
            raise UnsupportedSql("IN list items must be literals")
        res = A.is_in(v, items)
        return A.invert(res) if e.negated else res

    def _eval_between(self, e: ast.Between) -> Any:
        v = self.eval(e.operand)
        low, high = self.eval(e.low), self.eval(e.high)
        if not _is_arr(v) and not _is_arr(low) and not _is_arr(high):
            v, low, high = (A.broadcast(x, 1) for x in (v, low, high))
            res = A.and_kleene(A.compare(">=", v, low), A.compare("<=", v, high))
            res = A.invert(res) if e.negated else res
            return res.to_pylist()[0]
        res = A.and_kleene(A.compare(">=", *self._align(v, low)),
                           A.compare("<=", *self._align(v, high)))
        return A.invert(res) if e.negated else res

    def _eval_func(self, e: ast.Func) -> Any:
        if e.is_star:
            raise UnsupportedSql(f"{e.name}(*) is an aggregate; not valid in scalar context")
        args = [self.eval(a) for a in e.args]
        return call_scalar(e.name, args, self.n)

    def _eval_cast(self, e: ast.Cast) -> Any:
        v = self.eval(e.operand)
        t = sql_type_to_arrow(e.type_name)
        if _is_arr(v):
            return A.cast(v, t)
        if v is None:
            return None
        return A.cast(A.broadcast(v, 1), t).to_pylist()[0]

    def _eval_case(self, e: ast.Case) -> Any:
        # Build from the end: ELSE, then fold WHENs backwards with if_else.
        opv = self.eval(e.operand) if e.operand is not None else None
        result = as_arr(self.eval(e.otherwise), self.n) if e.otherwise is not None else None
        for cond_e, val_e in reversed(e.whens):
            if e.operand is not None:
                cond = A.compare("=", *self._align_any(opv, self.eval(cond_e)))
            else:
                cond = _to_bool(self.eval(cond_e), self.n)
            val = as_arr(self.eval(val_e), self.n)
            if result is None:
                result = A.nulls(self.n, val.type)
            result = A.if_else(cond, val, result)
        return result

    def _align_any(self, l: Any, r: Any) -> tuple[Arr, Arr]:
        if not _is_arr(l) and not _is_arr(r):
            return A.broadcast(l, self.n), A.broadcast(r, self.n)
        return self._align(l, r)

    def _eval_star(self, e: ast.Star) -> Any:
        raise UnsupportedSql("* is only valid as a select item")


@functools.lru_cache(maxsize=1024)
def _parse_cached(expr: str) -> ast.Expr:
    return parse_expression(expr)


def evaluate_expression(batch: MessageBatch, expr: str) -> Column:
    """Evaluate a SQL expression string against a batch, returning a port
    column of the batch's length. Parsed ASTs are cached globally."""
    ev = Evaluator.for_batch(batch)
    return A.to_column(as_arr(ev.eval(_parse_cached(expr)), ev.n))
