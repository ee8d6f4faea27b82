"""Host-side checksum of the Kafka record batch.

Counterpart of the pure-Python tier of ``arkflow_tpu/native/__init__.py``:
``crc32c`` (Castagnoli, reflected polynomial ``0x82F63B78``), table-driven
in Python. The JAX package's C++ tier and its other entry points are not
ported: the Kafka client (``connect/kafka_client.py``) and the Kafka
output's ``crc32c`` partitioner are the only callers.
"""

from __future__ import annotations

from typing import Optional

_CRC32C_TABLE: Optional[list[int]] = None


def _table() -> list[int]:
    global _CRC32C_TABLE
    if _CRC32C_TABLE is None:
        poly = 0x82F63B78
        table = []
        for i in range(256):
            c = i
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            table.append(c)
        _CRC32C_TABLE = table
    return _CRC32C_TABLE


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C of ``data``, continuing from ``crc``."""
    table = _table()
    crc = ~crc & 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return ~crc & 0xFFFFFFFF
