"""Minimal Modbus TCP client (MBAP framing, the read function codes).

Counterpart of ``arkflow_tpu/connect/modbus_client.py``: read coils
(0x01), discrete inputs (0x02), holding registers (0x03) and input
registers (0x04), one request at a time. A lost connection raises
``Disconnection``, an exception response ``ReadError``.
"""

from __future__ import annotations

import asyncio
import struct
from typing import Optional

from arkflow_tpu_torch.errors import ConnectError, Disconnection, ReadError

FUNC_READ_COILS = 1
FUNC_READ_DISCRETE = 2
FUNC_READ_HOLDING = 3
FUNC_READ_INPUT = 4


class ModbusClient:
    def __init__(self, host: str, port: int = 502, unit: int = 1):
        self.host = host
        self.port = port
        self.unit = unit
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._tid = 0
        self._lock = asyncio.Lock()

    async def connect(self, timeout: float = 5.0) -> None:
        try:
            self._reader, self._writer = await asyncio.wait_for(
                asyncio.open_connection(self.host, self.port), timeout)
        except (OSError, asyncio.TimeoutError) as e:
            raise ConnectError(f"modbus connect to {self.host}:{self.port} failed: {e}") from e

    async def _request(self, func: int, address: int, count: int,
                       timeout: float = 5.0) -> bytes:
        async with self._lock:
            if self._writer is None:
                raise Disconnection("modbus not connected")
            self._tid = (self._tid + 1) % 0xFFFF
            pdu = struct.pack(">BHH", func, address, count)
            mbap = struct.pack(">HHHB", self._tid, 0, len(pdu) + 1, self.unit)
            self._writer.write(mbap + pdu)
            try:
                await self._writer.drain()
                header = await asyncio.wait_for(self._reader.readexactly(7), timeout)
                tid, _proto, length, _unit = struct.unpack(">HHHB", header)
                body = await asyncio.wait_for(self._reader.readexactly(length - 1), timeout)
            except (OSError, asyncio.IncompleteReadError, asyncio.TimeoutError) as e:
                self._writer = None
                raise Disconnection(f"modbus connection lost: {e}") from e
            if tid != self._tid:
                raise ReadError(f"modbus transaction mismatch {tid} != {self._tid}")
            if body[0] & 0x80:
                raise ReadError(f"modbus exception code {body[1]} for function {func}")
            return body[2:]  # function and byte count stripped

    async def read_bits(self, func: int, address: int, count: int) -> list[bool]:
        data = await self._request(func, address, count)
        return [bool(data[i // 8] & (1 << (i % 8))) for i in range(count)]

    async def read_registers(self, func: int, address: int, count: int) -> list[int]:
        data = await self._request(func, address, count)
        return list(struct.unpack(f">{count}H", data[: 2 * count]))

    async def close(self) -> None:
        if self._writer is not None:
            try:
                self._writer.close()
                await self._writer.wait_closed()
            except Exception:
                pass
            self._writer = None
