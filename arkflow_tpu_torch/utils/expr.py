"""Dynamic config values: the ``Expr<T>`` equivalent.

Counterpart of ``arkflow_tpu/utils/expr.py``. A config field such as the
Kafka output's ``topic`` and ``key``, the Redis output's ``target`` or the
NATS output's ``subject`` may be a literal or a SQL expression evaluated
against the in-flight batch (``sql/eval.py``):

    topic: "static-topic"                 # literal
    topic: { expr: "concat('t-', city)" } # evaluated per batch
    topic: { value: "static-topic" }      # explicit literal form

Parsed expressions are cached globally by the evaluator.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

from arkflow_tpu_torch.batch import MessageBatch, column_to_pylist, slice_column
from arkflow_tpu_torch.errors import ConfigError


def check_dyn_value(v: Any, field: str = "value") -> None:
    """Refuse what ``DynValue.from_config`` refuses, without building it."""
    DynValue.from_config(v, field)


class DynValue:
    """A literal or per-batch SQL expression."""

    __slots__ = ("_literal", "_expr")

    def __init__(self, literal: Any = None, expr: Optional[str] = None):
        self._literal = literal
        self._expr = expr

    @classmethod
    def from_config(cls, v: Any, field: str = "value") -> "DynValue":
        if isinstance(v, Mapping):
            if "expr" in v:
                if not isinstance(v["expr"], str):
                    raise ConfigError(f"{field}: 'expr' must be a string")
                return cls(expr=v["expr"])
            if "value" in v:
                return cls(literal=v["value"])
            raise ConfigError(f"{field}: mapping must contain 'expr' or 'value'")
        return cls(literal=v)

    @property
    def is_expr(self) -> bool:
        return self._expr is not None

    def eval_per_row(self, batch: MessageBatch) -> list[Any]:
        """One value per row (dynamic routing keys etc.)."""
        if self._expr is None:
            return [self._literal] * batch.num_rows
        from arkflow_tpu_torch.sql.eval import evaluate_expression

        return column_to_pylist(evaluate_expression(batch, self._expr))

    def eval_scalar(self, batch: Optional[MessageBatch] = None) -> Any:
        """Single value for the batch (first row for expressions)."""
        if self._expr is None:
            return self._literal
        if batch is None or batch.num_rows == 0:
            raise ConfigError(f"expression {self._expr!r} needs a non-empty batch")
        from arkflow_tpu_torch.sql.eval import evaluate_expression

        return column_to_pylist(slice_column(evaluate_expression(batch, self._expr), 0, 1))[0]
