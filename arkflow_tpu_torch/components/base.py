"""Component contracts the slice's streams are wired from.

Counterpart of ``arkflow_tpu/components/base.py`` (inputs, outputs,
processors and acks):

- ``Input``     pull-based source; ``read()`` returns ``(MessageBatch, Ack)``.
                Raise ``EndOfInput`` when exhausted.
- ``Output``    push sink.
- ``Processor`` batch -> list of batches. An empty list drops the batch
                (and acks it); more than one entry fans out.

Acks implement at-least-once delivery: an ``Ack`` fires only after the
batches produced from its read were written downstream.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass

from arkflow_tpu_torch.batch import MessageBatch


class Ack(abc.ABC):
    """Acknowledgement handle delivered alongside every read batch."""

    @abc.abstractmethod
    async def ack(self) -> None:
        """Confirm downstream success (commit offsets, ack broker, ...)."""

    async def nack(self) -> None:
        """Delivery gave up without success. Default no-op."""
        return None


class NoopAck(Ack):
    """For sources with nothing to acknowledge."""

    async def ack(self) -> None:
        return None


@dataclass
class Resource:
    """Shared build-time context passed to every builder (the slice's
    components need none of it yet)."""


class Input(abc.ABC):
    @abc.abstractmethod
    async def connect(self) -> None: ...

    @abc.abstractmethod
    async def read(self) -> tuple[MessageBatch, Ack]:
        """Next batch + its ack. Raises EndOfInput when exhausted."""

    async def close(self) -> None:
        return None


class Output(abc.ABC):
    @abc.abstractmethod
    async def connect(self) -> None: ...

    @abc.abstractmethod
    async def write(self, batch: MessageBatch) -> None: ...

    async def close(self) -> None:
        return None


class Processor(abc.ABC):
    async def connect(self) -> None:
        """Optional pre-flight hook, run before the input starts producing
        (model warmup, ...). Default: no-op."""
        return None

    @abc.abstractmethod
    async def process(self, batch: MessageBatch) -> list[MessageBatch]:
        """Transform one batch into zero or more batches."""

    async def close(self) -> None:
        return None
