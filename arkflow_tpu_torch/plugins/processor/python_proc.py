"""Python processor: user code over the port's batches, in-process.

Counterpart of ``arkflow_tpu/plugins/processor/python_proc.py``. The user
function receives the port's ``MessageBatch``, where JAX's receives a
``pyarrow.RecordBatch`` (the port has no ``pyarrow``; ROADMAP Queue C). The
batch offers what such functions use: ``column(name)``, ``column_names``,
``num_rows``, ``filter(mask)`` over a bool column or list, ``with_column``,
``to_pydict()`` and ``to_pylist()``. The function returns a batch, a list
of batches, a dict of columns, a list of row dicts, or None (drop); any
other type raises JAX's "returned unsupported type".

``blocking: true`` runs the function on the default executor; otherwise it
runs on the event loop and may be a coroutine function.

    type: python
    script: |
      def process(batch):
          return batch.filter([t > 30.0 for t in batch.to_pydict()["temp"]])
    # or:
    module: mypkg.transforms
    function: process        # default "process"
    blocking: false
"""

from __future__ import annotations

import asyncio
import importlib
from typing import Any, Callable

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Processor, Resource, register_processor
from arkflow_tpu_torch.errors import ConfigError, ProcessError


def _coerce_result(res: Any) -> list[MessageBatch]:
    if res is None:
        return []
    if isinstance(res, MessageBatch):
        return [res] if res.num_rows else []
    if isinstance(res, dict):
        return [MessageBatch.from_pydict(res)]
    if isinstance(res, list):
        if not res:
            return []
        if all(isinstance(r, dict) for r in res):
            return [MessageBatch.from_pylist(res)]
        out: list[MessageBatch] = []
        for r in res:
            out.extend(_coerce_result(r))
        return out
    raise ProcessError(f"python processor returned unsupported type {type(res).__name__}")


class PythonProcessor(Processor):
    def __init__(self, fn: Callable, blocking: bool = False):
        self.fn = fn
        self.blocking = blocking

    async def process(self, batch: MessageBatch) -> list[MessageBatch]:
        try:
            if self.blocking:
                res = await asyncio.get_running_loop().run_in_executor(None, self.fn, batch)
            else:
                res = self.fn(batch)
                if asyncio.iscoroutine(res):
                    res = await res
        except ProcessError:
            raise
        except Exception as e:
            raise ProcessError(f"python processor failed: {e}") from e
        return _coerce_result(res)


def _check(config: dict) -> None:
    if bool(config.get("script")) == bool(config.get("module")):
        raise ConfigError("python processor requires exactly one of 'script' or 'module'")


@register_processor("python", keys=("script", "module", "function", "blocking"),
                    check=_check)
def _build(config: dict, resource: Resource) -> PythonProcessor:
    script = config.get("script")
    module = config.get("module")
    fn_name = config.get("function", "process")
    if script:
        namespace: dict[str, Any] = {}
        try:
            exec(compile(script, "<python processor>", "exec"), namespace)
        except SyntaxError as e:
            raise ConfigError(f"python processor script error: {e}") from e
        fn = namespace.get(fn_name)
    else:
        try:
            mod = importlib.import_module(module)
        except ImportError as e:
            raise ConfigError(f"python processor: cannot import {module!r}: {e}") from e
        fn = getattr(mod, fn_name, None)
    if not callable(fn):
        raise ConfigError(f"python processor: function {fn_name!r} not found or not callable")
    return PythonProcessor(fn, blocking=bool(config.get("blocking", False)))
