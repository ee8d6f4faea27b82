"""Modbus TCP input: poll coils and registers on an interval.

Counterpart of ``arkflow_tpu/plugins/input/modbus.py``: each read sleeps
``interval``, reads every configured point in turn and returns one row with
a column a point (a bool or an int, or a list of them where ``count`` > 1),
stamped ``__meta_source: modbus``. The row's columns are typed by
``column_from_pylist``, as ``pa.RecordBatch.from_pylist`` types JAX's.

Config:

    type: modbus
    host: 10.0.0.5
    port: 502
    unit: 1
    interval: 1s
    points:
      - {name: pump_on, kind: coil, address: 0}
      - {name: temp_raw, kind: holding, address: 100, count: 2}
"""

from __future__ import annotations

import asyncio

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Ack, Input, NoopAck, Resource, register_input
from arkflow_tpu_torch.connect.modbus_client import (FUNC_READ_COILS, FUNC_READ_DISCRETE,
                                                     FUNC_READ_HOLDING, FUNC_READ_INPUT,
                                                     ModbusClient)
from arkflow_tpu_torch.errors import ConfigError, EndOfInput
from arkflow_tpu_torch.utils.duration import parse_duration

_KINDS = {
    "coil": (FUNC_READ_COILS, "bits"),
    "discrete": (FUNC_READ_DISCRETE, "bits"),
    "holding": (FUNC_READ_HOLDING, "regs"),
    "input": (FUNC_READ_INPUT, "regs"),
}


def check_points(points: list) -> None:
    if not points:
        raise ConfigError("modbus input requires 'points'")
    for p in points:
        if p.get("kind") not in _KINDS:
            raise ConfigError(f"modbus point kind must be one of {sorted(_KINDS)}")
        if "name" not in p or "address" not in p:
            raise ConfigError("modbus point requires 'name' and 'address'")
        count = int(p.get("count", 1))
        limit = 2000 if _KINDS[p["kind"]][1] == "bits" else 125  # the protocol's maxima
        if not (1 <= count <= limit):
            raise ConfigError(
                f"modbus point {p['name']!r}: count must be in [1, {limit}], got {count}")


class ModbusInput(Input):
    def __init__(self, host: str, port: int, unit: int, interval_s: float, points: list[dict]):
        check_points(points)
        self.points = points
        self.interval_s = interval_s
        self._client = ModbusClient(host, port, unit)
        self._closed = False

    async def connect(self) -> None:
        await self._client.connect()

    async def read(self) -> tuple[MessageBatch, Ack]:
        if self._closed:
            raise EndOfInput()
        await asyncio.sleep(self.interval_s)
        row: dict = {}
        for p in self.points:
            func, kind = _KINDS[p["kind"]]
            count = int(p.get("count", 1))
            if kind == "bits":
                vals = await self._client.read_bits(func, int(p["address"]), count)
            else:
                vals = await self._client.read_registers(func, int(p["address"]), count)
            row[p["name"]] = [vals if count > 1 else vals[0]]
        return MessageBatch.from_pydict(row).with_source("modbus").with_ingest_time(), NoopAck()

    async def close(self) -> None:
        self._closed = True
        await self._client.close()


def _check(config: dict) -> None:
    """JAX's builder's refusals, in its order."""
    if not config.get("host"):
        raise ConfigError("modbus input requires 'host'")
    int(config.get("port", 502))
    int(config.get("unit", 1))
    parse_duration(config.get("interval", "1s"))
    check_points(list(config.get("points") or []))


@register_input("modbus", keys=("host", "port", "unit", "interval", "points"), check=_check)
def _build(config: dict, resource: Resource) -> ModbusInput:
    return ModbusInput(
        host=str(config["host"]),
        port=int(config.get("port", 502)),
        unit=int(config.get("unit", 1)),
        interval_s=parse_duration(config.get("interval", "1s")),
        points=list(config.get("points") or []),
    )
