"""Synthetic generator input: the slice's source.

Counterpart of ``arkflow_tpu/plugins/input/generate.py``. Config:

    type: generate
    payload: 'hello world'            # one payload for every row
                                      # (``context``, the reference's name,
                                      # is read where ``payload`` is absent),
                                      # or
    payloads: ['short', 'longer ...'] # a mix rotated across rows
    interval: 10ms                    # optional; 0 = as fast as pulled
    batch_size: 64
    count: 2048                       # optional total-row cap, then EOF
    codec: json                       # optional; raw __value__ bytes otherwise
    tenants: 8                        # optional; stamp the reads round robin
                                      # with tenant0..tenant7 (multi-tenant
                                      # traffic for the fairness and quota
                                      # paths)

With a codec, the rows of the template are decoded once, when it is built,
and every batch is a slice of the decoded template.
"""

from __future__ import annotations

import asyncio
import json
from typing import Optional

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Ack, Input, NoopAck, Resource, register_input
from arkflow_tpu_torch.errors import ConfigError, EndOfInput
from arkflow_tpu_torch.plugins.codec.helper import build_codec, check_codec, decode_payloads
from arkflow_tpu_torch.utils.duration import parse_duration


class GenerateInput(Input):
    def __init__(self, payloads: list[bytes], interval_s: float, batch_size: int,
                 count: Optional[int], codec=None, tenants: int = 0):
        if batch_size <= 0:
            raise ConfigError("generate.batch_size must be positive")
        if not payloads:
            raise ConfigError("generate input requires a payload")
        if tenants < 0:
            raise ConfigError("generate.tenants must be non-negative")
        self.payloads = payloads
        self.interval_s = interval_s
        self.batch_size = batch_size
        self.count = count
        self.codec = codec
        self.tenants = tenants
        self._emitted = 0
        self._reads = 0
        self._template: Optional[MessageBatch] = None
        #: (tenant lane, rows) -> the stamped template slice
        self._stamped: dict[tuple[int, int], MessageBatch] = {}

    async def connect(self) -> None:
        self._emitted = 0

    async def read(self) -> tuple[MessageBatch, Ack]:
        if self.count is not None and self._emitted >= self.count:
            raise EndOfInput()
        if self.interval_s > 0:
            await asyncio.sleep(self.interval_s)
        n = self.batch_size
        if self.count is not None:
            n = min(n, self.count - self._emitted)
        # rows are built once and sliced thereafter; a payload mix rotates
        # across the rows of the template
        if self._template is None or self._template.num_rows < n:
            size = max(n, self.batch_size)
            self._template = decode_payloads(
                [self.payloads[i % len(self.payloads)] for i in range(size)], self.codec)
        batch = self._template if n == self._template.num_rows else self._template.slice(0, n)
        if self.tenants:
            # one tenant per read, round robin
            lane = self._reads % self.tenants
            key = (lane, batch.num_rows)
            stamped = self._stamped.get(key)
            if stamped is None:
                stamped = self._stamped[key] = batch.with_tenant(f"tenant{lane}")
            batch = stamped
        self._reads += 1
        self._emitted += n
        return batch.with_source("generate"), NoopAck()


@register_input("generate", keys=("payload", "context", "payloads", "interval", "batch_size",
                                  "count", "codec", "tenants"), check=check_codec)
def _build(config: dict, resource: Resource) -> GenerateInput:
    mix = config.get("payloads")
    if mix is not None:
        if not isinstance(mix, (list, tuple)) or not mix:
            raise ConfigError("generate.payloads must be a non-empty list")
        payloads = [(json.dumps(p) if isinstance(p, (dict, list)) else str(p)).encode()
                    for p in mix]
    else:
        payload = config.get("payload", config.get("context"))
        if payload is None:
            raise ConfigError("generate input requires 'payload' or 'payloads'")
        if isinstance(payload, (dict, list)):
            payload = json.dumps(payload)
        payloads = [str(payload).encode()]
    return GenerateInput(
        payloads=payloads,
        interval_s=parse_duration(config.get("interval", 0)),
        batch_size=int(config.get("batch_size", 1)),
        count=int(config["count"]) if config.get("count") is not None else None,
        codec=build_codec(config.get("codec"), resource),
        tenants=int(config.get("tenants", 0)),
    )
