"""Recursive-descent SQL parser.

Counterpart of ``arkflow_tpu/sql/parser.py``, unchanged: pure Python.

Parses the SELECT dialect the engine executes. Anything outside the grammar
raises ``UnsupportedSql`` — the engine then routes the raw query string to the
sqlite fallback (which accepts a much larger dialect). DDL/DML is rejected
outright, mirroring the reference's ``SQLOptions`` guard
(ref: crates/arkflow-plugin/src/processor/sql.rs:192-195).
"""

from __future__ import annotations

from typing import Optional

from arkflow_tpu_torch.errors import UnsupportedSql
from arkflow_tpu_torch.sql import ast
from arkflow_tpu_torch.sql.lexer import Token, tokenize

_FORBIDDEN_HEADS = {
    "insert", "update", "delete", "create", "drop", "alter", "truncate",
    "attach", "pragma", "vacuum", "replace", "grant", "revoke", "copy", "set",
}


def assert_query_only(sql: str) -> None:
    """Reject anything but SELECT / WITH...SELECT, like the reference's SQLOptions.

    Works on the token stream (comments/strings already stripped), so a leading
    ``/**/`` or ``--`` comment cannot smuggle DDL/DML past the guard. The
    sqlite fallback additionally installs a read-only authorizer as defence in
    depth.
    """
    toks = tokenize(sql)
    if not toks or toks[0].kind == "eof":
        raise UnsupportedSql("empty statement")
    head = toks[0]
    head_word = head.value.lower()
    if head.is_kw("select"):
        return
    if head.is_kw("with"):
        # CTE prefix: the statement verb is the first top-level keyword after
        # the WITH list; require it to be SELECT (forbids WITH ... DELETE).
        depth = 0
        for t in toks[1:]:
            if t.kind == "op" and t.value == "(":
                depth += 1
            elif t.kind == "op" and t.value == ")":
                depth -= 1
            elif depth == 0 and (t.kind in ("kw", "ident")) and t.value.lower() in (
                _FORBIDDEN_HEADS | {"select"}
            ):
                if t.value.lower() == "select":
                    return
                raise UnsupportedSql(
                    f"statement type {t.value!r} is not allowed; queries only"
                )
        raise UnsupportedSql("WITH clause without a SELECT body")
    raise UnsupportedSql(f"statement type {head_word!r} is not allowed; queries only")


class Parser:
    def __init__(self, sql: str):
        self.toks = tokenize(sql)
        self.i = 0

    # -- plumbing ----------------------------------------------------------

    def peek(self) -> Token:
        return self.toks[self.i]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept_kw(self, *names: str) -> Optional[Token]:
        if self.peek().is_kw(*names):
            return self.next()
        return None

    def accept_op(self, *ops: str) -> Optional[Token]:
        t = self.peek()
        if t.kind == "op" and t.value in ops:
            return self.next()
        return None

    def expect_kw(self, name: str) -> Token:
        t = self.next()
        if not (t.kind == "kw" and t.value == name):
            raise UnsupportedSql(f"expected {name.upper()} at pos {t.pos}, got {t.value!r}")
        return t

    def expect_op(self, op: str) -> Token:
        t = self.next()
        if not (t.kind == "op" and t.value == op):
            raise UnsupportedSql(f"expected {op!r} at pos {t.pos}, got {t.value!r}")
        return t

    # -- entry points ------------------------------------------------------

    def parse_select(self) -> ast.Select:
        sel = self._select()
        t = self.peek()
        if t.kind == "op" and t.value == ";":
            self.next()
            t = self.peek()
        if t.kind != "eof":
            raise UnsupportedSql(f"trailing tokens at pos {t.pos}: {t.value!r}")
        return sel

    def parse_expression(self) -> ast.Expr:
        e = self._expr()
        t = self.peek()
        if t.kind != "eof":
            raise UnsupportedSql(f"trailing tokens at pos {t.pos}: {t.value!r}")
        return e

    # -- select ------------------------------------------------------------

    def _select(self) -> ast.Select:
        self.expect_kw("select")
        sel = ast.Select()
        if self.accept_kw("distinct"):
            sel.distinct = True
        elif self.accept_kw("all"):
            pass
        sel.items = [self._select_item()]
        while self.accept_op(","):
            sel.items.append(self._select_item())
        if self.accept_kw("from"):
            sel.table = self._table_ref()
            while True:
                join = self._maybe_join()
                if join is None:
                    break
                sel.joins.append(join)
        if self.accept_kw("where"):
            sel.where = self._expr()
        if self.accept_kw("group"):
            self.expect_kw("by")
            sel.group_by = [self._expr()]
            while self.accept_op(","):
                sel.group_by.append(self._expr())
        if self.accept_kw("having"):
            sel.having = self._expr()
        if self.accept_kw("union"):
            raise UnsupportedSql("UNION not supported natively")
        if self.accept_kw("order"):
            self.expect_kw("by")
            sel.order_by = [self._order_item()]
            while self.accept_op(","):
                sel.order_by.append(self._order_item())
        if self.accept_kw("limit"):
            sel.limit = self._int_literal()
        if self.accept_kw("offset"):
            sel.offset = self._int_literal()
        return sel

    def _int_literal(self) -> int:
        t = self.next()
        if t.kind != "number" or not t.value.isdigit():
            raise UnsupportedSql(f"expected integer at pos {t.pos}")
        return int(t.value)

    def _select_item(self) -> ast.SelectItem:
        t = self.peek()
        if t.kind == "op" and t.value == "*":
            self.next()
            return ast.SelectItem(ast.Star())
        e = self._expr()
        alias = None
        if self.accept_kw("as"):
            at = self.next()
            if at.kind not in ("ident", "string"):
                raise UnsupportedSql(f"expected alias at pos {at.pos}")
            alias = at.value
        elif self.peek().kind == "ident":
            alias = self.next().value
        return ast.SelectItem(e, alias)

    def _table_ref(self) -> ast.TableRef:
        t = self.next()
        if t.kind == "op" and t.value == "(":
            raise UnsupportedSql("subquery in FROM not supported natively")
        if t.kind != "ident":
            raise UnsupportedSql(f"expected table name at pos {t.pos}")
        alias = None
        if self.accept_kw("as"):
            alias = self.next().value
        elif self.peek().kind == "ident":
            alias = self.next().value
        return ast.TableRef(t.value, alias)

    def _maybe_join(self) -> Optional[ast.Join]:
        kind = None
        if self.accept_kw("cross"):
            kind = "cross"
        elif self.accept_kw("inner"):
            kind = "inner"
        elif self.accept_kw("left"):
            self.accept_kw("outer")
            kind = "left"
        elif self.accept_kw("right"):
            self.accept_kw("outer")
            kind = "right"
        elif self.accept_kw("full"):
            self.accept_kw("outer")
            kind = "full"
        elif self.peek().is_kw("join"):
            kind = "inner"
        if kind is None:
            return None
        self.expect_kw("join")
        table = self._table_ref()
        on = None
        if kind != "cross":
            self.expect_kw("on")
            on = self._expr()
        return ast.Join(kind, table, on)

    def _window_spec(self, f: ast.Func) -> ast.WindowFunc:
        """OVER (PARTITION BY ... ORDER BY ...) — explicit frames are not
        representable natively and reroute to the fallback engine."""
        self.expect_op("(")
        partition: list[ast.Expr] = []
        if self.accept_kw("partition"):
            self.expect_kw("by")
            partition = [self._expr()]
            while self.accept_op(","):
                partition.append(self._expr())
        order: list[ast.OrderItem] = []
        if self.accept_kw("order"):
            self.expect_kw("by")
            order = [self._order_item()]
            while self.accept_op(","):
                order.append(self._order_item())
        t = self.peek()
        if t.kind == "ident" and t.value.lower() in ("rows", "range", "groups"):
            raise UnsupportedSql("explicit window frames not supported natively")
        self.expect_op(")")
        return ast.WindowFunc(f, tuple(partition), tuple(order))

    def _order_item(self) -> ast.OrderItem:
        e = self._expr()
        asc = True
        if self.accept_kw("asc"):
            asc = True
        elif self.accept_kw("desc"):
            asc = False
        if self.accept_kw("nulls"):
            if not (self.accept_kw("first") or self.accept_kw("last")):
                raise UnsupportedSql("expected FIRST/LAST after NULLS")
        return ast.OrderItem(e, asc)

    # -- expressions (precedence climbing) ---------------------------------

    def _expr(self) -> ast.Expr:
        return self._or()

    def _or(self) -> ast.Expr:
        left = self._and()
        while self.accept_kw("or"):
            left = ast.Binary("or", left, self._and())
        return left

    def _and(self) -> ast.Expr:
        left = self._not()
        while self.accept_kw("and"):
            left = ast.Binary("and", left, self._not())
        return left

    def _not(self) -> ast.Expr:
        if self.accept_kw("not"):
            return ast.Unary("not", self._not())
        return self._comparison()

    def _comparison(self) -> ast.Expr:
        left = self._additive()
        t = self.peek()
        if t.kind == "op" and t.value in ("=", "!=", "<>", "<", "<=", ">", ">="):
            self.next()
            op = "!=" if t.value == "<>" else t.value
            return ast.Binary(op, left, self._additive())
        if t.is_kw("is"):
            self.next()
            negated = bool(self.accept_kw("not"))
            self.expect_kw("null")
            return ast.IsNull(left, negated)
        negated = False
        if t.is_kw("not"):
            # NOT IN / NOT LIKE / NOT BETWEEN
            save = self.i
            self.next()
            if self.peek().is_kw("in", "like", "ilike", "between"):
                negated = True
                t = self.peek()
            else:
                self.i = save
                return left
        if self.peek().is_kw("in"):
            self.next()
            self.expect_op("(")
            if self.peek().is_kw("select"):
                raise UnsupportedSql("IN (subquery) not supported natively")
            items = [self._expr()]
            while self.accept_op(","):
                items.append(self._expr())
            self.expect_op(")")
            return ast.InList(left, tuple(items), negated)
        if self.peek().is_kw("like", "ilike"):
            op = self.next().value
            node = ast.Binary(op, left, self._additive())
            return ast.Unary("not", node) if negated else node
        if self.peek().is_kw("between"):
            self.next()
            low = self._additive()
            self.expect_kw("and")
            high = self._additive()
            return ast.Between(left, low, high, negated)
        return left

    def _additive(self) -> ast.Expr:
        left = self._multiplicative()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-", "||"):
                self.next()
                left = ast.Binary(t.value, left, self._multiplicative())
            else:
                return left

    def _multiplicative(self) -> ast.Expr:
        left = self._unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/", "%"):
                self.next()
                left = ast.Binary(t.value, left, self._unary())
            else:
                return left

    def _unary(self) -> ast.Expr:
        t = self.peek()
        if t.kind == "op" and t.value in ("-", "+"):
            self.next()
            operand = self._unary()
            if t.value == "-" and isinstance(operand, ast.Literal) and isinstance(operand.value, (int, float)):
                return ast.Literal(-operand.value)
            return ast.Unary(t.value, operand)
        return self._primary()

    def _primary(self) -> ast.Expr:
        t = self.next()
        if t.kind == "number":
            v = t.value
            if "." in v or "e" in v.lower():
                return ast.Literal(float(v))
            return ast.Literal(int(v))
        if t.kind == "string":
            return ast.Literal(t.value)
        if t.is_kw("true"):
            return ast.Literal(True)
        if t.is_kw("false"):
            return ast.Literal(False)
        if t.is_kw("null"):
            return ast.Literal(None)
        if t.is_kw("cast"):
            self.expect_op("(")
            e = self._expr()
            self.expect_kw("as")
            ty = self.next()
            if ty.kind not in ("ident", "kw"):
                raise UnsupportedSql(f"expected type name at pos {ty.pos}")
            type_name = ty.value.lower()
            # e.g. DOUBLE PRECISION / VARCHAR(10)
            if self.peek().kind == "ident":
                type_name += " " + self.next().value.lower()
            if self.accept_op("("):
                self._int_literal()
                if self.accept_op(","):
                    self._int_literal()
                self.expect_op(")")
            self.expect_op(")")
            return ast.Cast(e, type_name)
        if t.is_kw("case"):
            operand = None
            if not self.peek().is_kw("when"):
                operand = self._expr()
            whens = []
            while self.accept_kw("when"):
                cond = self._expr()
                self.expect_kw("then")
                whens.append((cond, self._expr()))
            otherwise = None
            if self.accept_kw("else"):
                otherwise = self._expr()
            self.expect_kw("end")
            return ast.Case(operand, tuple(whens), otherwise)
        if t.kind == "op" and t.value == "(":
            if self.peek().is_kw("select"):
                raise UnsupportedSql("scalar subquery not supported natively")
            e = self._expr()
            self.expect_op(")")
            return e
        if t.kind == "ident" or (t.kind == "kw" and t.value in ("left", "right")):
            name = t.value
            # function call?
            if self.peek().kind == "op" and self.peek().value == "(":
                self.next()
                distinct = bool(self.accept_kw("distinct"))
                if self.peek().kind == "op" and self.peek().value == "*":
                    self.next()
                    self.expect_op(")")
                    f = ast.Func(name.lower(), (), distinct, is_star=True)
                elif self.peek().kind == "op" and self.peek().value == ")":
                    self.next()
                    f = ast.Func(name.lower(), (), distinct)
                else:
                    args = [self._expr()]
                    while self.accept_op(","):
                        args.append(self._expr())
                    self.expect_op(")")
                    f = ast.Func(name.lower(), tuple(args), distinct)
                if self.peek().is_kw("over"):
                    self.next()
                    return self._window_spec(f)
                return f
            # qualified column?
            if self.peek().kind == "op" and self.peek().value == ".":
                self.next()
                nxt = self.next()
                if nxt.kind == "op" and nxt.value == "*":
                    return ast.Star(table=name)
                if nxt.kind != "ident":
                    raise UnsupportedSql(f"expected column after '.' at pos {nxt.pos}")
                return ast.Column(nxt.value, table=name)
            return ast.Column(name)
        raise UnsupportedSql(f"unexpected token {t.value!r} at pos {t.pos}")


def parse_select(sql: str) -> ast.Select:
    assert_query_only(sql)
    return Parser(sql).parse_select()


def parse_expression(expr: str) -> ast.Expr:
    return Parser(expr).parse_expression()
