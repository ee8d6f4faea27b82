"""SQL AST nodes.

Counterpart of ``arkflow_tpu/sql/ast.py``, unchanged: pure Python."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional


class Expr:
    __slots__ = ()


@dataclass(frozen=True)
class Literal(Expr):
    value: object  # int | float | str | bool | None


@dataclass(frozen=True)
class Column(Expr):
    name: str
    table: Optional[str] = None


@dataclass(frozen=True)
class Star(Expr):
    table: Optional[str] = None


@dataclass(frozen=True)
class Unary(Expr):
    op: str  # 'not' | '-' | '+'
    operand: Expr


@dataclass(frozen=True)
class Binary(Expr):
    op: str  # and or = != < <= > >= + - * / % || like ilike
    left: Expr
    right: Expr


@dataclass(frozen=True)
class IsNull(Expr):
    operand: Expr
    negated: bool = False


@dataclass(frozen=True)
class InList(Expr):
    operand: Expr
    items: tuple[Expr, ...] = ()
    negated: bool = False


@dataclass(frozen=True)
class Between(Expr):
    operand: Expr
    low: Expr
    high: Expr
    negated: bool = False


@dataclass(frozen=True)
class Func(Expr):
    name: str  # lowercase
    args: tuple[Expr, ...] = ()
    distinct: bool = False
    is_star: bool = False  # count(*)


@dataclass(frozen=True)
class Cast(Expr):
    operand: Expr
    type_name: str  # lowercase sql type


@dataclass(frozen=True)
class WindowFunc(Expr):
    """``func(...) OVER (PARTITION BY ... ORDER BY ...)``.

    Only the default frame is representable (RANGE UNBOUNDED PRECEDING..
    CURRENT ROW when ordered, the whole partition otherwise); explicit
    frames raise UnsupportedSql at parse."""

    func: "Func"
    partition_by: tuple[Expr, ...] = ()
    order_by: tuple["OrderItem", ...] = ()


@dataclass(frozen=True)
class Case(Expr):
    operand: Optional[Expr]  # CASE x WHEN ... vs CASE WHEN ...
    whens: tuple[tuple[Expr, Expr], ...] = ()
    otherwise: Optional[Expr] = None


@dataclass(frozen=True)
class SelectItem:
    expr: Expr
    alias: Optional[str] = None


@dataclass(frozen=True)
class TableRef:
    name: str
    alias: Optional[str] = None


@dataclass(frozen=True)
class Join:
    kind: str  # inner | left | right | full | cross
    table: TableRef
    on: Optional[Expr] = None


@dataclass(frozen=True)
class OrderItem:
    expr: Expr
    asc: bool = True


@dataclass
class Select:
    items: list[SelectItem] = field(default_factory=list)
    table: Optional[TableRef] = None
    joins: list[Join] = field(default_factory=list)
    where: Optional[Expr] = None
    group_by: list[Expr] = field(default_factory=list)
    having: Optional[Expr] = None
    order_by: list[OrderItem] = field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None
    distinct: bool = False
