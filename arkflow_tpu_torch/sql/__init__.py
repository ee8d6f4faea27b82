"""The SQL engine of the port, without Arrow.

Counterpart of ``arkflow_tpu/sql/`` (bar ``vrl.py``). The in-flight batch is
registered as table ``flow``; a query runs in two tiers:

- **Native tier** (``planner.py``): SELECT / WHERE / JOIN / GROUP BY /
  window functions / ORDER BY / LIMIT over whole columns, on the kernels of
  ``arrays.py``, which copy the ``pyarrow.compute`` semantics the JAX
  engine runs on (its integer division, overflow, casts, rounding, null and
  NaN rules) over the port's numpy columns (``batch.py``).
- **Fallback tier** (``fallback.py``): anything the native planner declines
  (subqueries, CTEs, explicit window frames) runs in the standard library's
  ``sqlite3`` with batches bridged in as tables.

``SessionContext`` (``engine.py``) is the user-facing object; ``ContextPool``
mirrors the reference's fixed 4-context pool. Scalar/aggregate UDFs
registered via ``functions`` are visible in both tiers.
"""

from arkflow_tpu_torch.sql.engine import ContextPool, SessionContext  # noqa: F401
from arkflow_tpu_torch.sql.eval import evaluate_expression  # noqa: F401
from arkflow_tpu_torch.sql.functions import register_aggregate_udf, register_scalar_udf  # noqa: F401
