"""Chaos processor: deterministic fault injection for pipeline testing.

Counterpart of ``arkflow_tpu/plugins/processor/chaos.py``. With
``thread_num: 1`` the failures are deterministic: ``fail_every`` raises on
every Nth batch and ``fail_rate`` draws from ``random.Random(seed)`` once a
batch, so one seed fails the same batch numbers in both packages. With
several workers the count and the generator are shared, so which batch
fails follows the scheduling (the rate still holds).

    type: chaos
    fail_every: 10          # raise on every Nth batch (0 = never)
    fail_rate: 0.05         # or: seeded random failure probability
    latency: 25ms           # added delay per batch
    seed: 7
"""

from __future__ import annotations

import asyncio
import random

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Processor, Resource, register_processor
from arkflow_tpu_torch.errors import ConfigError, ProcessError
from arkflow_tpu_torch.utils.duration import parse_duration


class ChaosProcessor(Processor):
    def __init__(self, fail_every: int = 0, fail_rate: float = 0.0,
                 latency_s: float = 0.0, seed: int = 0):
        if fail_every < 0 or not (0.0 <= fail_rate <= 1.0) or latency_s < 0:
            raise ConfigError("chaos: fail_every >= 0, 0 <= fail_rate <= 1, latency >= 0")
        self.fail_every = fail_every
        self.fail_rate = fail_rate
        self.latency_s = latency_s
        self._rng = random.Random(seed)
        self._count = 0

    async def process(self, batch: MessageBatch) -> list[MessageBatch]:
        self._count += 1
        if self.latency_s > 0:
            await asyncio.sleep(self.latency_s)
        if self.fail_every and self._count % self.fail_every == 0:
            raise ProcessError(f"chaos: injected failure on batch {self._count}")
        if self.fail_rate and self._rng.random() < self.fail_rate:
            raise ProcessError(f"chaos: injected random failure on batch {self._count}")
        return [batch]


@register_processor("chaos", keys=("fail_every", "fail_rate", "latency", "seed"))
def _build(config: dict, resource: Resource) -> ChaosProcessor:
    latency = config.get("latency")
    return ChaosProcessor(
        fail_every=int(config.get("fail_every", 0)),
        fail_rate=float(config.get("fail_rate", 0.0)),
        latency_s=parse_duration(latency) if latency is not None else 0.0,
        seed=int(config.get("seed", 0)),
    )
