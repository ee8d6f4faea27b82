"""Component contracts the slice's streams are wired from.

Counterpart of ``arkflow_tpu/components/base.py`` (inputs, outputs,
processors and acks):

- ``Input``     pull-based source; ``read()`` returns ``(MessageBatch, Ack)``.
                Raise ``EndOfInput`` when exhausted.
- ``Output``    push sink.
- ``Processor`` batch -> list of batches. An empty list drops the batch
                (and acks it); more than one entry fans out.
- ``Buffer``    write-side accumulator between input and pipeline
                (micro-batchers and windows).
- ``Codec``     payload bytes <-> typed columns (``Decoder`` + ``Encoder``).

Acks implement at-least-once delivery: an ``Ack`` fires only after the
batches produced from its read were written downstream. ``VecAck`` composes
the acks of the sources merged into one emission; ``split_ack`` shares one
source's ack across the emissions its rows were carved into. An ack is
``redeliverable`` when its ``nack`` makes the source deliver the batch
again in this session: only then does the stream nack a failed batch below
``max_delivery_attempts`` (a composite is redeliverable when every part is).
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Awaitable, Callable, Optional, Sequence

from arkflow_tpu_torch.batch import MessageBatch


class Ack(abc.ABC):
    """Acknowledgement handle delivered alongside every read batch."""

    #: True only when ``nack()`` makes the source deliver the batch again in
    #: this session, so the stream can count its attempts; otherwise a
    #: failed batch is quarantined (or dropped) at once instead of nacked
    redeliverable = False

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


class VecAck(Ack):
    """Composite ack: fires a collection of child acks in order."""

    def __init__(self, acks: Sequence[Ack] = ()):
        self.acks: list[Ack] = list(acks)

    def push(self, ack: Ack) -> None:
        self.acks.append(ack)

    @property
    def redeliverable(self) -> bool:  # type: ignore[override]
        return bool(self.acks) and all(
            getattr(a, "redeliverable", False) for a in self.acks)

    async def ack(self) -> None:
        # stops at the first child that raises, as the JAX package's does
        for a in self.acks:
            await a.ack()

    async def nack(self) -> None:
        for a in self.acks:
            await a.nack()


class FnAck(Ack):
    """Ack from a coroutine function."""

    def __init__(self, fn: Callable[[], Awaitable[None]]):
        self._fn = fn

    async def ack(self) -> None:
        await self._fn()


class _SplitState:
    __slots__ = ("ack", "remaining", "nacked")

    def __init__(self, ack: Ack, parts: int):
        self.ack = ack
        self.remaining = parts
        self.nacked = False


class _PartAck(Ack):
    """One share of a split source ack (see ``split_ack``)."""

    def __init__(self, state: _SplitState):
        self._state = state
        self._done = False

    @property
    def redeliverable(self) -> bool:  # type: ignore[override]
        return bool(getattr(self._state.ack, "redeliverable", False))

    async def _resolve(self, nack: bool) -> None:
        if self._done:  # idempotent: a retried ack must not double-count
            return
        self._done = True
        st = self._state
        st.nacked = st.nacked or nack
        st.remaining -= 1
        if st.remaining == 0:
            if st.nacked:
                await st.ack.nack()
            else:
                await st.ack.ack()

    async def ack(self) -> None:
        await self._resolve(False)

    async def nack(self) -> None:
        await self._resolve(True)


def split_ack(ack: Ack, parts: int) -> list[Ack]:
    """Split one source ack into ``parts`` shares, for a batch whose rows are
    carved across several emissions. The source acks once every share acked;
    if any share nacks, the source nacks instead, once all shares resolved,
    so the whole source batch is redelivered (duplicates of the rows already
    delivered are the at-least-once cost)."""
    if parts < 1:
        raise ValueError("split_ack needs at least one part")
    if parts == 1:
        return [ack]
    state = _SplitState(ack, parts)
    return [_PartAck(state) for _ in range(parts)]


@dataclass
class Resource:
    """Shared build-time context passed to every builder.

    - ``input_names``: child names registered by fan-in inputs
      (``multiple_inputs``), for the windowed SQL join's tables (its
      reader, like JAX's ``temporaries``, waits for the SQL engine).
    """

    input_names: list[str] = field(default_factory=list)


class Input(abc.ABC):
    #: True for pull-based sources that keep their backlog on the broker
    #: (kafka, redis list, nats JetStream, websocket), as in the JAX
    #: package: the stream pauses their reads while its overload controller
    #: sheds with a full window (``runtime/overload.input_pauses_on_overload``).
    pause_on_overload = False

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


class Buffer(abc.ABC):
    """Accumulator between input and pipeline (micro-batchers)."""

    @abc.abstractmethod
    async def write(self, batch: MessageBatch, ack: Ack) -> None: ...

    @abc.abstractmethod
    async def read(self) -> Optional[tuple[MessageBatch, Ack]]:
        """Blocks until a merged batch is due; None when closed and drained."""

    async def close(self) -> None:
        return None


class Decoder(abc.ABC):
    @abc.abstractmethod
    def decode(self, payload: bytes) -> MessageBatch: ...


class Encoder(abc.ABC):
    @abc.abstractmethod
    def encode(self, batch: MessageBatch) -> list[bytes]:
        """One payload per logical message (often one per row)."""


class Codec(Encoder, Decoder, abc.ABC):
    """Bidirectional codec."""
