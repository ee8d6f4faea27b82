"""SessionContext + ContextPool: the user-facing SQL entry points.

Counterpart of ``arkflow_tpu/sql/engine.py``. ``SessionContext.sql(query)``
keeps DataFusion's batch-table contract: register batches under table
names, run a query, get a batch back. Execution tries the native planner
first and reroutes to the sqlite fallback on ``UnsupportedSql``.

``ContextPool`` is the reference's fixed pool of contexts as an async
context manager over a queue.
"""

from __future__ import annotations

import asyncio
import contextlib

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.errors import UnsupportedSql
from arkflow_tpu_torch.sql.fallback import execute_fallback
from arkflow_tpu_torch.sql.parser import assert_query_only, parse_select
from arkflow_tpu_torch.sql.planner import execute_select


class SessionContext:
    def __init__(self) -> None:
        self._tables: dict[str, MessageBatch] = {}

    def register_batch(self, name: str, batch: MessageBatch) -> None:
        self._tables[name] = batch

    def deregister(self, name: str) -> None:
        self._tables.pop(name, None)

    def deregister_all(self) -> None:
        self._tables.clear()

    def table_names(self) -> list[str]:
        return sorted(self._tables)

    def sql(self, query: str) -> MessageBatch:
        """Execute a read-only query over the registered tables."""
        assert_query_only(query)
        try:
            sel = parse_select(query)
            return execute_select(sel, self._tables)
        except UnsupportedSql:
            return execute_fallback(query, self._tables)


class ContextPool:
    """Fixed pool of SessionContexts (the reference's pool of 4): contexts
    are handed out in turn and wiped (tables deregistered) on release."""

    def __init__(self, size: int = 4):
        if size <= 0:
            raise ValueError("pool size must be positive")
        self._contexts: list[SessionContext] = [SessionContext() for _ in range(size)]
        self._free: asyncio.Queue[SessionContext] = asyncio.Queue()
        for c in self._contexts:
            self._free.put_nowait(c)

    @contextlib.asynccontextmanager
    async def acquire(self):
        ctx = await self._free.get()
        try:
            yield ctx
        finally:
            ctx.deregister_all()
            self._free.put_nowait(ctx)
