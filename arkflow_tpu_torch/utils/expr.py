"""Dynamic config values: the literal forms of ``Expr<T>``.

Counterpart of ``arkflow_tpu/utils/expr.py``. A config field such as the
Kafka output's ``topic`` and ``key``, the Redis output's ``target`` or the
NATS output's ``subject`` may be

    topic: "static-topic"                 # literal
    topic: { value: "static-topic" }      # explicit literal form
    topic: { expr: "concat('t-', city)" } # a SQL expression per batch

The port has no SQL evaluator yet, so the ``expr`` form raises "not yet
ported" at ``--validate`` and at build (``check_dyn_value``, ``from_config``).
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.errors import ConfigError, not_ported


def check_dyn_value(v: Any, field: str = "value") -> None:
    """Refuse what ``DynValue.from_config`` refuses, without building it."""
    if isinstance(v, Mapping):
        if "expr" in v:
            if not isinstance(v["expr"], str):
                raise ConfigError(f"{field}: 'expr' must be a string")
            raise not_ported(f"{field}: the SQL expression form {{expr: ...}}")
        if "value" not in v:
            raise ConfigError(f"{field}: mapping must contain 'expr' or 'value'")


class DynValue:
    """A literal config value (the port's only form)."""

    __slots__ = ("_literal",)

    def __init__(self, literal: Any = None):
        self._literal = literal

    @classmethod
    def from_config(cls, v: Any, field: str = "value") -> "DynValue":
        check_dyn_value(v, field)
        return cls(literal=v["value"] if isinstance(v, Mapping) else v)

    def eval_scalar(self, batch: Optional[MessageBatch] = None) -> Any:
        """Single value for the batch."""
        return self._literal
