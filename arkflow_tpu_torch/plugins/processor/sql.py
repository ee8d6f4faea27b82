"""SQL processor.

Counterpart of ``arkflow_tpu/plugins/processor/sql.py``: the in-flight batch
is registered as table ``flow`` (or ``table_name``), the statement is
pre-parsed at build time, DDL/DML is refused, and contexts come from a
fixed pool of 4. The query runs on an executor thread (the sqlite fallback
blocks); a cancelled ``process`` drains that thread before its pooled
context goes back, as JAX's does.

Config:

    type: sql
    query: "SELECT * FROM flow WHERE temp > 30"
    table_name: flow            # optional override

The ``temporary`` bindings read the stream's temporaries, which the port
does not declare yet (the stream's ``temporary`` key, ROADMAP Queue A
8(b)): a binding names an unknown temporary and raises JAX's message.
"""

from __future__ import annotations

import asyncio

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Processor, Resource, register_processor
from arkflow_tpu_torch.errors import ConfigError, UnsupportedSql
from arkflow_tpu_torch.sql import ContextPool
from arkflow_tpu_torch.sql.parser import assert_query_only, parse_select

DEFAULT_TABLE_NAME = "flow"
POOL_SIZE = 4  # the reference's pool of contexts


class SqlProcessor(Processor):
    def __init__(self, query: str, table_name: str = DEFAULT_TABLE_NAME):
        assert_query_only(query)
        try:
            parse_select(query)  # pre-parse; fallback-dialect queries may still fail here
        except UnsupportedSql:
            pass  # executed by the fallback tier at runtime
        self.query = query
        self.table_name = table_name
        self.pool = ContextPool(POOL_SIZE)

    async def process(self, batch: MessageBatch) -> list[MessageBatch]:
        if batch.num_rows == 0:
            return []
        async with self.pool.acquire() as ctx:
            ctx.register_batch(self.table_name, batch)
            # off the event loop: the sqlite fallback tier blocks
            fut = asyncio.get_running_loop().run_in_executor(None, ctx.sql, self.query)
            try:
                result = await asyncio.shield(fut)
            except asyncio.CancelledError:
                # the pooled context must not be reclaimed while the worker
                # thread still queries it: drain the future before releasing
                await asyncio.wait([fut])
                raise
        return [result] if result.num_rows > 0 else []


def _check(config: dict) -> None:
    if not config.get("query"):
        raise ConfigError("sql processor requires 'query'")


@register_processor("sql", keys=("query", "table_name", "temporary"), check=_check)
def _build(config: dict, resource: Resource) -> SqlProcessor:
    declared = getattr(resource, "temporaries", None) or {}
    for t in config.get("temporary", []) or []:
        name = t.get("name")
        if name not in declared:
            raise ConfigError(
                f"sql processor references unknown temporary {name!r} "
                f"(declared: {sorted(declared)})"
            )
    return SqlProcessor(query=config["query"],
                        table_name=config.get("table_name", DEFAULT_TABLE_NAME))
