"""SQL processor.

Counterpart of ``arkflow_tpu/plugins/processor/sql.py``: the in-flight batch
is registered as table ``flow`` (or ``table_name``), the statement is
pre-parsed at build time, DDL/DML is refused, and contexts come from a
fixed pool of 4. The query runs on an executor thread (the sqlite fallback
blocks); a cancelled ``process`` drains that thread before its pooled
context goes back, as JAX's does.

Each ``temporary`` binding names one of the stream's temporaries: for every
batch its ``key`` expression is evaluated over the batch, the temporary is
asked for those keys, and the rows it returns are registered as the
binding's ``table`` before ``flow``.

Config:

    type: sql
    query: "SELECT * FROM flow WHERE temp > 30"
    table_name: flow            # optional override
    temporary:                  # optional enrichment tables
      - name: devices           # a temporary of the stream
        table: devices          # the SQL table name (default: name)
        key: "device_id"        # expression over flow giving the lookup keys
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Optional

from arkflow_tpu_torch.batch import MessageBatch, column_to_pylist
from arkflow_tpu_torch.components import Processor, Resource, Temporary, register_processor
from arkflow_tpu_torch.errors import ConfigError, UnsupportedSql
from arkflow_tpu_torch.sql import ContextPool
from arkflow_tpu_torch.sql.eval import evaluate_expression
from arkflow_tpu_torch.sql.parser import assert_query_only, parse_select

DEFAULT_TABLE_NAME = "flow"
POOL_SIZE = 4  # the reference's pool of contexts


@dataclass
class TemporaryBinding:
    table: str
    temporary: Temporary
    key_expr: str


class SqlProcessor(Processor):
    def __init__(self, query: str, table_name: str = DEFAULT_TABLE_NAME,
                 temporaries: Optional[list[TemporaryBinding]] = None):
        assert_query_only(query)
        try:
            parse_select(query)  # pre-parse; fallback-dialect queries may still fail here
        except UnsupportedSql:
            pass  # executed by the fallback tier at runtime
        self.query = query
        self.table_name = table_name
        self.temporaries = temporaries or []
        self.pool = ContextPool(POOL_SIZE)

    async def process(self, batch: MessageBatch) -> list[MessageBatch]:
        if batch.num_rows == 0:
            return []
        async with self.pool.acquire() as ctx:
            for binding in self.temporaries:
                keys = column_to_pylist(evaluate_expression(batch, binding.key_expr))
                ctx.register_batch(binding.table, await binding.temporary.get(keys))
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
    bindings = []
    for t in config.get("temporary", []) or []:
        name = t.get("name")
        if name not in resource.temporaries:
            raise ConfigError(
                f"sql processor references unknown temporary {name!r} "
                f"(declared: {sorted(resource.temporaries)})"
            )
        bindings.append(TemporaryBinding(table=t.get("table", name),
                                         temporary=resource.temporaries[name],
                                         key_expr=t.get("key", "")))
        if not bindings[-1].key_expr:
            raise ConfigError(f"temporary {name!r} binding requires a 'key' expression")
    return SqlProcessor(query=config["query"],
                        table_name=config.get("table_name", DEFAULT_TABLE_NAME),
                        temporaries=bindings)
