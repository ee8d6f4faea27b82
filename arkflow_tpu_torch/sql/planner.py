"""Native SELECT execution on the port's columns.

Counterpart of ``arkflow_tpu/sql/planner.py``: SELECT / WHERE / JOIN /
GROUP BY / HAVING / window functions / ORDER BY / LIMIT / DISTINCT over
whole columns with the kernels of ``sql/arrays.py``. Scalar-over-aggregate
expressions (``sum(x)/count(*)``) substitute computed aggregate columns into
the expression tree and re-evaluate on the aggregated rows, as JAX does.

Where JAX runs pyarrow's hash kernels, this module follows their results:

- GROUP BY and DISTINCT emit groups in the order they first appear, a
  null key forming its own group. JAX's ``group_by(..., use_threads=False)``
  gives that order for few distinct keys; past that, and for several keys,
  its order is its hash table's, which no query can rely on;
- ``count`` counts non-null values, ``sum`` of integers is int64 (of bools
  uint64), of floats double; ``min``/``max`` keep the input type and skip
  NaN; ``mean``, ``stddev`` and ``variance`` are double, the last two
  population statistics (ddof 0); ``first_value``/``last_value`` skip
  nulls; a group with no value gives null (``count`` 0); a global
  aggregate over no rows gives one row; float sums without GROUP BY add in
  Arrow's pairwise blocks of 16, grouped sums row by row;
- ORDER BY is a stable multi-key sort, NaN after every number and nulls
  last in either direction.

The equi-join is a hash join with JAX's residual and outer-residual steps.
Acero gives no output order for a join without ORDER BY; this join emits a
deterministic one (the left rows in order, each with its matches in right
order, then the unmatched right rows), and tests compare such results as
sorted multisets. A column name the output would hold twice (``a.k, b.k``)
is written ``k``, ``k:1``, as the sqlite fallback names them: a port batch
holds each name once, where a pyarrow batch may repeat one.

Queries outside this shape raise ``UnsupportedSql`` and the engine reroutes
them to the sqlite fallback.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np

from arkflow_tpu_torch.batch import Column, MessageBatch
from arkflow_tpu_torch.errors import UnsupportedSql
from arkflow_tpu_torch.sql import arrays as A
from arkflow_tpu_torch.sql import ast
from arkflow_tpu_torch.sql.arrays import Arr, ComputeError
from arkflow_tpu_torch.sql.eval import Evaluator
from arkflow_tpu_torch.sql.functions import NATIVE_AGGREGATES, as_arr, has_function
from arkflow_tpu_torch.sql.winfuncs import compute_window


def render(e: ast.Expr) -> str:
    """Stable display name for an unaliased expression column."""
    if isinstance(e, ast.Column):
        return e.name
    if isinstance(e, ast.Literal):
        return repr(e.value)
    if isinstance(e, ast.Func):
        inner = "*" if e.is_star else ", ".join(render(a) for a in e.args)
        d = "DISTINCT " if e.distinct else ""
        return f"{e.name}({d}{inner})"
    if isinstance(e, ast.WindowFunc):
        return render(e.func) + " over"
    if isinstance(e, ast.Binary):
        return f"{render(e.left)} {e.op} {render(e.right)}"
    if isinstance(e, ast.Unary):
        return f"{e.op} {render(e.operand)}"
    if isinstance(e, ast.Cast):
        return f"cast({render(e.operand)} as {e.type_name})"
    return type(e).__name__.lower()


def _find_aggregates(e: ast.Expr, out: list[ast.Func]) -> None:
    if isinstance(e, ast.WindowFunc):
        return  # its inner func is a window evaluation, not a group aggregate
    if isinstance(e, ast.Func) and (e.name in NATIVE_AGGREGATES or e.is_star and e.name == "count"):
        out.append(e)
        return  # don't descend into aggregate args
    if isinstance(e, ast.Func) and not has_function(e.name) and not e.is_star:
        # unknown function: could be an aggregate UDF -> not natively plannable
        raise UnsupportedSql(f"unknown function {e.name!r} in native planner")
    for child in _children(e):
        _find_aggregates(child, out)


def _find_windows(e: ast.Expr, out: list[ast.WindowFunc]) -> None:
    if isinstance(e, ast.WindowFunc):
        if e not in out:
            out.append(e)
        return
    for child in _children(e):
        _find_windows(child, out)


def _children(e: ast.Expr) -> list[ast.Expr]:
    if isinstance(e, ast.Unary):
        return [e.operand]
    if isinstance(e, ast.Binary):
        return [e.left, e.right]
    if isinstance(e, ast.IsNull):
        return [e.operand]
    if isinstance(e, ast.InList):
        return [e.operand, *e.items]
    if isinstance(e, ast.Between):
        return [e.operand, e.low, e.high]
    if isinstance(e, ast.Func):
        return list(e.args)
    if isinstance(e, ast.Cast):
        return [e.operand]
    if isinstance(e, ast.WindowFunc):
        return [e.func, *e.partition_by, *[o.expr for o in e.order_by]]
    if isinstance(e, ast.Case):
        out = list(e.whens and [x for w in e.whens for x in w] or [])
        if e.operand is not None:
            out.append(e.operand)
        if e.otherwise is not None:
            out.append(e.otherwise)
        return out
    return []


def _substitute(e: ast.Expr, mapping: dict[ast.Expr, ast.Column]) -> ast.Expr:
    """Replace mapped subtrees (group keys / aggregates / windows) with
    column refs."""
    if e in mapping:
        return mapping[e]
    if isinstance(e, ast.Unary):
        return ast.Unary(e.op, _substitute(e.operand, mapping))
    if isinstance(e, ast.Binary):
        return ast.Binary(e.op, _substitute(e.left, mapping), _substitute(e.right, mapping))
    if isinstance(e, ast.IsNull):
        return ast.IsNull(_substitute(e.operand, mapping), e.negated)
    if isinstance(e, ast.InList):
        return ast.InList(_substitute(e.operand, mapping), tuple(_substitute(i, mapping) for i in e.items), e.negated)
    if isinstance(e, ast.Between):
        return ast.Between(_substitute(e.operand, mapping), _substitute(e.low, mapping), _substitute(e.high, mapping), e.negated)
    if isinstance(e, ast.Func):
        return ast.Func(e.name, tuple(_substitute(a, mapping) for a in e.args), e.distinct, e.is_star)
    if isinstance(e, ast.Cast):
        return ast.Cast(_substitute(e.operand, mapping), e.type_name)
    if isinstance(e, ast.Case):
        return ast.Case(
            _substitute(e.operand, mapping) if e.operand is not None else None,
            tuple((_substitute(c, mapping), _substitute(v, mapping)) for c, v in e.whens),
            _substitute(e.otherwise, mapping) if e.otherwise is not None else None,
        )
    return e


# -- a table of named columns ------------------------------------------------


class _Table:
    """Ordered slot -> column (a port column or an ``Arr``) of one length."""

    def __init__(self, cols: dict[str, Any], num_rows: int):
        self.cols = cols
        self.num_rows = num_rows

    @classmethod
    def of_batch(cls, batch: MessageBatch) -> "_Table":
        return cls({n: batch.column(n) for n in batch.column_names}, batch.num_rows)

    def arr(self, slot: str) -> Arr:
        return as_arr(self.cols[slot], self.num_rows)

    def take(self, idx: np.ndarray) -> "_Table":
        return _Table({k: (v.take(idx) if isinstance(v, Arr) else A.take_column(v, idx))
                       for k, v in self.cols.items()}, len(idx))

    def filter(self, mask: Arr) -> "_Table":
        """Rows where ``mask`` is true (null drops the row)."""
        return self.take(np.flatnonzero(mask.data.astype(bool) & mask.mask()))




def _batch(names: list[str], cols: list[Any], n: int) -> MessageBatch:
    """A port batch of these columns; a repeated name becomes ``name:k``."""
    seen: dict[str, int] = {}
    out: dict[str, Column] = {}
    for nm, col in zip(names, cols):
        if nm in seen:
            seen[nm] += 1
            nm = f"{nm}:{seen[nm]}"
        else:
            seen[nm] = 0
        out[nm] = A.to_column(col) if isinstance(col, Arr) else col
    return MessageBatch(out, n)


class _From:
    """Resolved FROM/JOIN clause: one table of internal slot columns plus
    the visible-name -> slot mapping used to build Evaluators."""

    def __init__(self, table: _Table, names: dict[str, str],
                 stars: list[tuple[str, str]],
                 alias_stars: dict[str, list[tuple[str, str]]]):
        self.table = table
        self.names = names            # bare + qualified visible name -> slot
        self.stars = stars            # ordered (display, slot) for bare *
        self.alias_stars = alias_stars  # alias -> [(display, slot)] for a.*

    @property
    def num_rows(self) -> int:
        return self.table.num_rows

    def evaluator(self) -> Evaluator:
        cols = {name: self.table.cols[slot] for name, slot in self.names.items()}
        return Evaluator(cols, self.num_rows)

    def filter(self, mask: Arr) -> None:
        self.table = self.table.filter(mask)

    def add_column(self, slot: str, arr: Arr) -> None:
        self.table.cols[slot] = arr
        self.names[slot] = slot

    def star_columns(self, table: Optional[str]) -> list[tuple[str, Any]]:
        if table is None:
            pairs = self.stars
        else:
            pairs = self.alias_stars.get(table)
            if pairs is None:
                raise UnsupportedSql(f"unknown table alias {table!r} in *")
        return [(display, self.table.cols[slot]) for display, slot in pairs]


def _lookup(tables: dict[str, MessageBatch], tref: ast.TableRef) -> MessageBatch:
    batch = tables.get(tref.name)
    if batch is None:
        raise UnsupportedSql(f"unknown table {tref.name!r} (registered: {sorted(tables)})")
    return batch


def _single_from(tables: dict[str, MessageBatch], tref: ast.TableRef) -> _From:
    batch = _lookup(tables, tref)
    alias = tref.alias or tref.name
    names: dict[str, str] = {}
    stars: list[tuple[str, str]] = []
    for c in batch.column_names:
        names[c] = c
        names[f"{alias}.{c}"] = c
        stars.append((c, c))
    return _From(_Table.of_batch(batch), names, stars, {alias: list(stars)})


# -- join resolution ---------------------------------------------------------


def _conjuncts(e: ast.Expr) -> list[ast.Expr]:
    if isinstance(e, ast.Binary) and e.op == "and":
        return _conjuncts(e.left) + _conjuncts(e.right)
    return [e]


def _columns_of(e: ast.Expr, out: list[ast.Column]) -> None:
    if isinstance(e, ast.Column):
        out.append(e)
    for c in _children(e):
        _columns_of(c, out)


def _side_of(e: ast.Expr, left_names: dict[str, str], right_names: dict[str, str]) -> Optional[str]:
    """'left'/'right' if every column in e resolves to exactly one side."""
    cols: list[ast.Column] = []
    _columns_of(e, cols)
    if not cols:
        return None  # constant: ambiguous, treat as residual
    sides = set()
    for c in cols:
        key = f"{c.table}.{c.name}" if c.table else c.name
        in_l = key in left_names
        in_r = key in right_names
        if in_l and in_r:
            raise UnsupportedSql(f"ambiguous column {key!r} in JOIN condition")
        if in_l:
            sides.add("left")
        elif in_r:
            sides.add("right")
        else:
            raise UnsupportedSql(f"no such column {key!r} in JOIN condition")
    return sides.pop() if len(sides) == 1 else None


def _joined_from(sel: ast.Select, tables: dict[str, MessageBatch]) -> _From:
    """Fold the JOIN chain left-to-right through the hash join."""
    refs = [(sel.table, None, None)] + [(j.table, j.on, j.kind) for j in sel.joins]

    cur: Optional[_Table] = None
    names: dict[str, str] = {}       # visible name -> slot
    bare_owner: dict[str, Optional[str]] = {}  # bare name -> slot | None=ambiguous
    stars: list[tuple[str, str]] = []
    alias_stars: dict[str, list[tuple[str, str]]] = {}

    for ti, (tref, on, kind) in enumerate(refs):
        batch = _lookup(tables, tref)
        alias = tref.alias or tref.name
        if alias in alias_stars:
            raise UnsupportedSql(f"duplicate table alias {alias!r}")
        cnames = batch.column_names
        slots = [f"__t{ti}c{j}" for j in range(len(cnames))]
        right = (_Table({s: batch.column(c) for c, s in zip(cnames, slots)}, batch.num_rows)
                 if cnames else _Table({f"__t{ti}c0": A.nulls(batch.num_rows)}, batch.num_rows))
        right_names: dict[str, str] = {}
        for c, s in zip(cnames, slots):
            right_names[f"{alias}.{c}"] = s
            right_names.setdefault(c, s)
        pairs = list(zip(cnames, slots))
        alias_stars[alias] = pairs

        if cur is None:
            cur = right
        else:
            # ON sees prior tables' qualified names + unambiguous bare names
            left_vis = dict(names)
            for c, s in bare_owner.items():
                if s is not None and c not in left_vis:
                    left_vis[c] = s
            cur = _hash_join(cur, right, on, kind, left_vis, right_names)

        stars.extend(pairs)
        for name, s in right_names.items():
            if "." in name:
                names[name] = s
        for c in cnames:
            if c in bare_owner:
                bare_owner[c] = None  # ambiguous across tables
            else:
                bare_owner[c] = right_names[f"{alias}.{c}"]

    for c, s in bare_owner.items():
        if s is not None and c not in names:
            names[c] = s
    return _From(cur, names, stars, alias_stars)


def _ev(tbl: _Table, nm: dict[str, str]) -> Evaluator:
    return Evaluator({name: tbl.cols[slot] for name, slot in nm.items() if slot in tbl.cols},
                     tbl.num_rows)


def _key_rows(arrs: list[Arr]) -> tuple[np.ndarray, list[tuple]]:
    """Whether every key column is valid in each row, and each row's key
    tuple."""
    ok = np.ones(len(arrs[0]), bool)
    for a in arrs:
        ok &= a.mask()
    return ok, list(zip(*[a.data.tolist() for a in arrs]))


def _match_pairs(lkeys: list[Arr], rkeys: list[Arr]) -> tuple[np.ndarray, np.ndarray]:
    """(left row, right row) of every equi-key match; null keys never
    match. Left rows in order, each with its matches in right order."""
    lok, lrows = _key_rows(lkeys)
    rok, rrows = _key_rows(rkeys)
    index: dict[Any, list[int]] = {}
    for j, (k, ok) in enumerate(zip(rrows, rok)):
        if ok:
            index.setdefault(_norm(k), []).append(j)
    li, ri = [], []
    for i, (k, ok) in enumerate(zip(lrows, lok)):
        if ok:
            for j in index.get(_norm(k), ()):
                li.append(i)
                ri.append(j)
    return np.array(li, np.int64), np.array(ri, np.int64)


def _norm(key: tuple) -> tuple:
    """A key tuple whose NaNs compare equal (as hashing treats them)."""
    return tuple("__nan__" if isinstance(v, float) and math.isnan(v) else v for v in key)


_JOIN_TYPES = {"inner", "left", "right", "full"}


def _hash_join(cur: _Table, right: _Table, on: Optional[ast.Expr], kind: str,
               left_names: dict[str, str], right_names: dict[str, str]) -> _Table:
    """One join step: split ON into equi-keys + residual, join, filter."""
    eqs: list[tuple[ast.Expr, ast.Expr]] = []
    residual: list[ast.Expr] = []
    if on is not None:
        for c in _conjuncts(on):
            if isinstance(c, ast.Binary) and c.op == "=":
                ls = _side_of(c.left, left_names, right_names)
                rs = _side_of(c.right, left_names, right_names)
                if ls == "left" and rs == "right":
                    eqs.append((c.left, c.right))
                    continue
                if ls == "right" and rs == "left":
                    eqs.append((c.right, c.left))
                    continue
            residual.append(c)
    if kind in ("left", "right", "full") and not eqs:
        raise UnsupportedSql(
            f"{kind.upper()} JOIN requires at least one equi-join key natively")
    # outer join with a non-equi residual: the INNER equi-join + residual,
    # then the rows whose matches were all eliminated, null-extended
    outer_residual = kind if (kind in ("left", "right", "full") and residual) else None
    if residual and not eqs and kind != "cross":
        kind = "cross"  # non-equi inner join: cross product + filter

    nl, nr = cur.num_rows, right.num_rows
    if kind == "cross" or not eqs:
        li = np.repeat(np.arange(nl, dtype=np.int64), nr)
        ri = np.tile(np.arange(nr, dtype=np.int64), nl)
        join_type = "inner"
    else:
        lev, rev = _ev(cur, left_names), _ev(right, right_names)
        lkeys, rkeys = [], []
        for le, re_ in eqs:
            lv, rv = as_arr(lev.eval(le), nl), as_arr(rev.eval(re_), nr)
            # null-typed keys (empty/all-None columns) route to the fallback
            if lv.type == "null" or rv.type == "null":
                raise UnsupportedSql("join key column has null type")
            if lv.type != rv.type:
                floating = A.is_floating(lv.type) or A.is_floating(rv.type)
                try:
                    if floating:
                        lv, rv = A.cast(lv, "double"), A.cast(rv, "double")
                    elif A.is_numeric(lv.type) and A.is_numeric(rv.type):
                        rv = A.cast(rv, lv.type)
                    else:
                        rv = A.cast(rv, lv.type)
                except ComputeError as e:
                    raise UnsupportedSql(f"join key types incompatible: {e}")
            lkeys.append(lv)
            rkeys.append(rv)
        li, ri = _match_pairs(lkeys, rkeys)
        join_type = "inner" if outer_residual else kind

    if residual:
        # bare names visible on BOTH sides are ambiguous: drop them so the
        # eval raises UnsupportedSql and the sqlite fallback reports it
        both = dict(left_names)
        for name, slot in right_names.items():
            if "." not in name and name in both and both[name] != slot:
                del both[name]
                continue
            both[name] = slot
        pairs = _pair_table(cur, right, li, ri)
        ev = _ev(pairs, both)
        mask = None
        for c in residual:
            m = A.to_bool(as_arr(ev.eval(c), pairs.num_rows))
            mask = m if mask is None else A.and_kleene(mask, m)
        keep = mask.data.astype(bool) & mask.mask()
        li, ri = li[keep], ri[keep]
    if join_type in ("left", "full"):
        li, ri = _extend(li, ri, nl, left=True)
    if join_type in ("right", "full"):
        li, ri = _extend(li, ri, nr, left=False)
    if outer_residual in ("left", "full"):
        li, ri = _extend(li, ri, nl, left=True)
    if outer_residual in ("right", "full"):
        li, ri = _extend(li, ri, nr, left=False)
    return _pair_table(cur, right, li, ri)


def _extend(li: np.ndarray, ri: np.ndarray, n: int, left: bool):
    """Append the rows of one side that no pair holds, with -1 (null) on
    the other side."""
    side = li if left else ri
    seen = np.zeros(n, bool)
    seen[side[side >= 0]] = True
    miss = np.flatnonzero(~seen).astype(np.int64)
    none = np.full(len(miss), -1, np.int64)
    if left:
        return np.r_[li, miss], np.r_[ri, none]
    return np.r_[li, none], np.r_[ri, miss]


def _gather(col: Any, idx: np.ndarray, n: int) -> Any:
    """Rows ``idx`` of a column, a null row where ``idx`` is -1."""
    if not (idx < 0).any():
        return col.take(idx) if isinstance(col, Arr) else A.take_column(col, idx)
    a = as_arr(col, n)
    out = a.take(np.where(idx < 0, 0, idx)) if len(a) else A.nulls(len(idx), a.type)
    return Arr(out.type, out.data, out.mask() & (idx >= 0))


def _pair_table(cur: _Table, right: _Table, li: np.ndarray, ri: np.ndarray) -> _Table:
    cols = {k: _gather(v, li, cur.num_rows) for k, v in cur.cols.items()}
    cols.update({k: _gather(v, ri, right.num_rows) for k, v in right.cols.items()})
    return _Table(cols, len(li))


# -- select execution --------------------------------------------------------


def execute_select(sel: ast.Select, tables: dict[str, MessageBatch]) -> MessageBatch:
    """Run a parsed SELECT natively; raise UnsupportedSql otherwise."""
    if sel.table is None:
        # SELECT <exprs> without FROM: single-row evaluation
        ev = Evaluator({}, 1)
        cols, names = [], []
        for item in sel.items:
            if isinstance(item.expr, ast.Star):
                raise UnsupportedSql("* without FROM")
            cols.append(as_arr(ev.eval(item.expr), 1))
            names.append(item.alias or render(item.expr))
        return _batch(names, cols, 1)

    src = _joined_from(sel, tables) if sel.joins else _single_from(tables, sel.table)

    # WHERE
    if sel.where is not None:
        wins_in_where: list[ast.WindowFunc] = []
        _find_windows(sel.where, wins_in_where)
        if wins_in_where:
            raise UnsupportedSql("window functions are not allowed in WHERE")
        mask = as_arr(src.evaluator().eval(sel.where), src.num_rows)
        src.filter(A.to_bool(mask))

    # aggregate / window discovery
    aggs: list[ast.Func] = []
    wins: list[ast.WindowFunc] = []
    for item in sel.items:
        if not isinstance(item.expr, ast.Star):
            _find_aggregates(item.expr, aggs)
            _find_windows(item.expr, wins)
    if sel.having is not None:
        _find_aggregates(sel.having, aggs)
    for oi in sel.order_by:
        _find_windows(oi.expr, wins)

    win_mapping: dict[ast.Expr, ast.Column] = {}
    if wins:
        if sel.group_by or aggs:
            raise UnsupportedSql(
                "window functions mixed with GROUP BY/aggregates not supported natively")
        ev = src.evaluator()
        for i, w in enumerate(wins):
            src.add_column(f"__win_{i}", compute_window(w, ev, src.num_rows))
            win_mapping[w] = ast.Column(f"__win_{i}")

    agg_env: Optional[tuple[_Table, dict]] = None
    if sel.group_by or aggs:
        names, out, agg_env = _execute_aggregate(sel, src, aggs)
    else:
        names, out = _execute_projection(sel, src, win_mapping)

    # DISTINCT
    if sel.distinct:
        keys = [out.arr(s) for s in out.cols]
        first = _group_ids(keys, out.num_rows)[1] if out.num_rows else np.zeros(0, np.int64)
        out = out.take(first)

    # ORDER BY
    if sel.order_by:
        out = _order(out, names, sel, src, win_mapping, agg_env)

    # LIMIT/OFFSET
    n = out.num_rows
    lo = min(sel.offset, n) if sel.offset is not None else 0
    hi = n if sel.limit is None else min(n, lo + sel.limit)
    if lo or hi != n:
        out = out.take(np.arange(lo, hi, dtype=np.int64))
    return _batch(names, [out.cols[s] for s in out.cols], out.num_rows)


def _execute_projection(sel: ast.Select, src: _From,
                        win_mapping: dict[ast.Expr, ast.Column]) -> tuple[list[str], _Table]:
    ev = src.evaluator()
    cols: dict[str, Any] = {}
    names: list[str] = []
    for item in sel.items:
        if isinstance(item.expr, ast.Star):
            for display, col in src.star_columns(item.expr.table):
                cols[f"__o{len(names)}"] = col
                names.append(display)
            continue
        e = _substitute(item.expr, win_mapping) if win_mapping else item.expr
        cols[f"__o{len(names)}"] = as_arr(ev.eval(e), src.num_rows)
        names.append(item.alias or render(item.expr))
    return names, _Table(cols, src.num_rows)


_DISTINCT_AGGS = {"count": "count_distinct"}


def _group_ids(keys: list[Arr], n: int) -> tuple[np.ndarray, np.ndarray]:
    """Per row its group (groups numbered in order of first appearance;
    null keys equal each other, NaN keys too) and each group's first row."""
    if not keys:
        return np.zeros(n, np.int64), np.zeros(1 if n else 0, np.int64)
    rows = zip(*[[None if not ok else v for v, ok in zip(k.data.tolist(), k.mask())]
                 for k in keys])
    index: dict[Any, int] = {}
    ids = np.empty(n, np.int64)
    first: list[int] = []
    for i, row in enumerate(rows):
        key = _norm(row)
        g = index.get(key)
        if g is None:
            g = index[key] = len(first)
            first.append(i)
        ids[i] = g
    return ids, np.array(first, np.int64)


def _pairwise_sum(x: np.ndarray) -> float:
    """Arrow's floating ``sum`` (``SumArray``): blocks of 16 summed in
    order, the block sums reduced pairwise up a binary tree."""
    block = 16
    n = len(x)
    if n == 0:
        return 0.0
    levels = max(1, int(n).bit_length()) + 1
    sums = [0.0] * (levels + 1)
    mask = 0
    root = 0
    for start in range(0, n, block):
        b = 0.0
        for v in x[start:start + block].tolist():
            b += v
        level, bit = 0, 1
        sums[0] += b
        mask ^= bit
        while (mask & bit) == 0:
            b = sums[level]
            sums[level] = 0.0
            level += 1
            bit <<= 1
            sums[level] += b
            mask ^= bit
        root = max(root, level)
    for i in range(1, root + 1):
        sums[i] += sums[i - 1]
    return sums[root]


def _agg(kernel: str, a: Optional[Arr], ids: np.ndarray, g: int, keyed: bool) -> Arr:
    """One aggregate per group: pyarrow's ``hash_<kernel>`` (``keyed``) or
    its scalar ``<kernel>`` over the one group of a global aggregate."""
    if kernel == "count_all":
        return Arr("int64", np.bincount(ids, minlength=g).astype(np.int64))
    ok = a.mask()
    if kernel == "count":
        return Arr("int64", np.bincount(ids[ok], minlength=g).astype(np.int64))
    if kernel == "count_distinct":
        seen = [set() for _ in range(g)]
        for gid, v, live in zip(ids.tolist(), a.data.tolist(), ok):
            if live:
                seen[gid].add("__nan__" if isinstance(v, float) and math.isnan(v) else v)
        return Arr("int64", np.array([len(s) for s in seen], np.int64))
    cnt = np.bincount(ids[ok], minlength=g)
    has = cnt > 0
    t = a.type
    if kernel in ("first", "last"):
        pick = np.zeros(g, np.int64)
        rows = np.flatnonzero(ok)
        order = rows if kernel == "first" else rows[::-1]
        done = np.zeros(g, bool)
        for r in order.tolist():
            gid = ids[r]
            if not done[gid]:
                done[gid] = True
                pick[gid] = r
        out = a.take(pick) if len(a) else A.nulls(g, t)
        return Arr(out.type, out.data, has)
    if t == "null":
        res = {"sum": "null", "min": "null", "max": "null"}.get(kernel, "double")
        return A.nulls(g, res)
    if not (A.is_numeric(t) or t == "bool") and kernel not in ("min", "max"):
        raise ComputeError(f"Function 'hash_{kernel}' has no kernel matching input types "
                           f"({A.type_name(t)})")
    if kernel in ("min", "max"):
        return _min_max(kernel, a, ids, g, ok, has)
    floating = A.is_floating(t)
    if kernel == "sum":
        if floating:
            x = np.where(ok, a.data.astype(np.float64), 0.0)
            sums = _group_sums(x, ids, g, keyed, ok)
            return Arr("double", sums, has)
        out_t = "uint64" if t == "bool" or t in A.UINTS else "int64"
        x = np.where(ok, a.data, 0).astype(A.NUMPY_DTYPE[out_t])
        sums = np.zeros(g, A.NUMPY_DTYPE[out_t])
        with np.errstate(all="ignore"):
            np.add.at(sums, ids, x)
        return Arr(out_t, sums, has)
    # mean, variance, stddev in double
    if floating:
        x = np.where(ok, a.data.astype(np.float64), 0.0)
        sums = _group_sums(x, ids, g, keyed, ok)
    else:
        xi = np.where(ok, a.data, 0).astype(np.int64)
        isums = np.zeros(g, np.int64)
        with np.errstate(all="ignore"):
            np.add.at(isums, ids, xi)
        sums = isums.astype(np.float64)
        x = xi.astype(np.float64)
    with np.errstate(all="ignore"):
        mean = sums / np.maximum(cnt, 1)
        if kernel == "mean":
            return Arr("double", mean, has)
        dev = np.where(ok, (x - mean[ids]) ** 2, 0.0)
        m2 = _group_sums(dev, ids, g, keyed, ok)
        var = m2 / np.maximum(cnt, 1)
    return Arr("double", np.sqrt(var) if kernel == "stddev" else var, has)


def _group_sums(x: np.ndarray, ids: np.ndarray, g: int, keyed: bool,
                ok: np.ndarray) -> np.ndarray:
    """Float sums per group: row by row (``hash_sum``), or Arrow's pairwise
    blocks over the valid runs of a global aggregate (``sum``)."""
    if keyed or g != 1:
        sums = np.zeros(g, np.float64)
        np.add.at(sums, ids[ok], x[ok])
        return sums
    return np.array([_pairwise_runs(x, ok)], np.float64)


def _pairwise_runs(x: np.ndarray, ok: np.ndarray) -> float:
    """``SumArray`` visits the valid rows run by run, the blocks of 16
    restarting at each run, over one shared tree."""
    if ok.all():
        return _pairwise_sum(x)
    vals: list[np.ndarray] = []
    edges = np.flatnonzero(np.diff(np.r_[0, ok.astype(np.int8), 0]))
    for s, e in zip(edges[::2], edges[1::2]):
        vals.append(x[s:e])
    block = 16
    blocks = [v[i:i + block] for v in vals for i in range(0, len(v), block)]
    if not blocks:
        return 0.0
    flat = np.concatenate([np.r_[b, np.zeros(block - len(b))] for b in blocks])
    return _pairwise_sum(flat)


def _min_max(kernel: str, a: Arr, ids: np.ndarray, g: int, ok: np.ndarray,
             has: np.ndarray) -> Arr:
    """``min``/``max`` in the input's type; NaN is skipped unless a group
    holds nothing else."""
    t = a.type
    if A.is_numeric(t) or t == "bool":
        x = a.data
        live = ok.copy()
        if A.is_floating(t):
            live &= ~np.isnan(x)
        out = np.zeros(g, x.dtype)
        for gid, v in _extremes(kernel, ids[live], x[live]):
            out[gid] = v
        if A.is_floating(t):
            only_nan = has & (np.bincount(ids[live], minlength=g) == 0)
            out = np.where(only_nan, np.nan, out).astype(x.dtype)
        return Arr(t, out, has)
    vals = [None] * g
    for gid, v, live in zip(ids.tolist(), a.data.tolist(), ok):
        if live and (vals[gid] is None or (v < vals[gid] if kernel == "min" else v > vals[gid])):
            vals[gid] = v
    return A.from_pylist(vals, t)


def _extremes(kernel: str, ids: np.ndarray, x: np.ndarray):
    if not len(ids):
        return []
    order = np.lexsort((x, ids))
    ids_s, x_s = ids[order], x[order]
    bounds = np.flatnonzero(np.r_[True, ids_s[1:] != ids_s[:-1]])
    if kernel == "min":
        return zip(ids_s[bounds].tolist(), x_s[bounds])
    last = np.r_[bounds[1:], len(ids_s)] - 1
    return zip(ids_s[last].tolist(), x_s[last])


def _execute_aggregate(sel: ast.Select, src: _From,
                       aggs: list[ast.Func]) -> tuple[list[str], _Table, tuple]:
    ev = src.evaluator()
    n = src.num_rows

    # Deduplicate aggregates structurally.
    uniq: list[ast.Func] = []
    for a in aggs:
        if a not in uniq:
            uniq.append(a)

    keys: list[Arr] = []
    mapping: dict[ast.Expr, ast.Column] = {}
    for i, gexpr in enumerate(sel.group_by):
        keys.append(as_arr(ev.eval(gexpr), n))
        mapping[gexpr] = ast.Column(f"__key_{i}")
    specs = []
    for i, a in enumerate(uniq):
        if a.is_star:  # count(*)
            specs.append(("count_all", None))
        else:
            if len(a.args) != 1:
                raise UnsupportedSql(f"aggregate {a.name} takes exactly one argument natively")
            kernel = NATIVE_AGGREGATES[a.name]
            if a.distinct:
                kernel = _DISTINCT_AGGS.get(a.name)
                if kernel is None:
                    raise UnsupportedSql(f"DISTINCT {a.name} not supported natively")
            specs.append((kernel, as_arr(ev.eval(a.args[0]), n)))
        mapping[a] = ast.Column(f"__agg_{i}")

    keyed = bool(keys)
    if keyed:
        ids, first = _group_ids(keys, n)
        g = len(first)
    else:  # a global aggregate: one group, over no rows too
        ids, first, g = np.zeros(n, np.int64), None, 1
    cols: dict[str, Any] = {}
    for i, k in enumerate(keys):
        cols[f"__key_{i}"] = k.take(first)
    for i, (kernel, arr) in enumerate(specs):
        cols[f"__agg_{i}"] = _agg(kernel, arr, ids, g, keyed)
    agg = _Table(cols, g)

    # HAVING on the aggregated rows.
    if sel.having is not None:
        hev = Evaluator(dict(agg.cols), agg.num_rows)
        mask = as_arr(hev.eval(_substitute(sel.having, mapping)), agg.num_rows)
        agg = agg.filter(A.to_bool(mask))

    # Final projection over key/agg columns.
    fev = Evaluator(dict(agg.cols), agg.num_rows)
    out: dict[str, Any] = {}
    names: list[str] = []
    for item in sel.items:
        if isinstance(item.expr, ast.Star):
            raise UnsupportedSql("* not valid in aggregate query")
        sub = _substitute(item.expr, mapping)
        _assert_resolved(sub, set(agg.cols))
        out[f"__o{len(names)}"] = as_arr(fev.eval(sub), agg.num_rows)
        names.append(item.alias or render(item.expr))
    return names, _Table(out, agg.num_rows), (agg, mapping)


def _assert_resolved(e: ast.Expr, available: set[str]) -> None:
    """Every column in a post-aggregation expression must be a key or agg slot."""
    if isinstance(e, ast.Column) and e.name not in available:
        raise UnsupportedSql(
            f"column {e.name!r} must appear in GROUP BY or inside an aggregate"
        )
    for c in _children(e):
        _assert_resolved(c, available)


def _order(out: _Table, names: list[str], sel: ast.Select, src: _From,
           win_mapping: dict[ast.Expr, ast.Column],
           agg_env: Optional[tuple] = None) -> _Table:
    slots = list(out.cols)
    visible: dict[str, Any] = {}
    for nm, s in zip(names, slots):
        visible.setdefault(nm, out.cols[s])
    keys: list[tuple[Arr, bool]] = []
    for oi in sel.order_by:
        e = _substitute(oi.expr, win_mapping) if win_mapping else oi.expr
        if isinstance(e, ast.Literal) and isinstance(e.value, int):
            idx = e.value - 1
            if not (0 <= idx < len(slots)):
                raise UnsupportedSql(f"ORDER BY position {e.value} out of range")
            keys.append((out.arr(slots[idx]), oi.asc))
            continue
        if isinstance(e, ast.Column) and e.table is None and e.name in visible:
            keys.append((as_arr(visible[e.name], out.num_rows), oi.asc))
            continue
        # expression over output (aliases); else over the aggregated rows
        # (group keys/aggregates substituted in); else over the source rows
        try:
            v = as_arr(Evaluator(dict(visible), out.num_rows).eval(e), out.num_rows)
        except UnsupportedSql:
            if agg_env is not None:
                agg, amap = agg_env
                if agg.num_rows != out.num_rows:
                    raise UnsupportedSql("ORDER BY expression not resolvable against output")
                sub = _substitute(e, amap)
                _assert_resolved(sub, set(agg.cols))
                v = as_arr(Evaluator(dict(agg.cols), agg.num_rows).eval(sub), out.num_rows)
            else:
                if src.num_rows != out.num_rows:
                    raise UnsupportedSql("ORDER BY expression not resolvable against output")
                v = as_arr(src.evaluator().eval(e), out.num_rows)
        keys.append((v, oi.asc))
    return out.take(A.sort_indices(keys))
