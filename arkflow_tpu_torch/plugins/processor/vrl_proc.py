"""VRL processor: ``{type: vrl, statement: ...}`` blocks.

Counterpart of ``arkflow_tpu/plugins/processor/vrl_proc.py``: the statement
compiles once at build into a vectorized step plan (``sql/vrl.py``) and
each batch runs it over whole columns. A program outside the supported
subset fails at build and at ``--validate`` with JAX's message.
"""

from __future__ import annotations

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Processor, Resource, register_processor
from arkflow_tpu_torch.errors import ConfigError, ProcessError
from arkflow_tpu_torch.sql.vrl import VrlCompileError, apply_vrl, compile_vrl


class VrlProcessor(Processor):
    def __init__(self, statement: str):
        try:
            self.steps = compile_vrl(statement)
        except VrlCompileError:
            raise
        except Exception as e:
            raise ConfigError(f"vrl: failed to compile statement: {e}") from e
        if not self.steps:
            raise ConfigError("vrl: statement compiles to no operations")

    async def process(self, batch: MessageBatch) -> list[MessageBatch]:
        if batch.num_rows == 0:
            return []
        try:
            out = apply_vrl(batch, self.steps)
        except ProcessError:
            raise
        except Exception as e:
            raise ProcessError(f"vrl execution failed: {e}") from e
        return [out] if out.num_rows else []


def _check(config: dict) -> None:
    statement = config.get("statement")
    if not statement:
        raise ConfigError("vrl processor requires 'statement'")
    VrlProcessor(str(statement))


@register_processor("vrl", keys=("statement",), check=_check)
def _build(config: dict, resource: Resource) -> VrlProcessor:
    return VrlProcessor(str(config["statement"]))
