"""Window buffers: tumbling, sliding and session.

Counterpart of ``arkflow_tpu/plugins/buffer/window.py`` without its ``query``
join, which runs the SQL engine (not yet ported: ``query`` raises at
``--validate`` and at build). ``inputs``, which names the join's tables, is
accepted as in the JAX package; without ``query`` it changes nothing.

- ``WindowBase`` keeps one queue per input name, from ``__meta_source``.
- Emission policies:
  - tumbling: a fixed ``interval`` from the first write of a window,
    non-overlapping;
  - sliding: message-count ``window_size`` / ``slide_size`` with overlap;
    window k covers messages ``[k*slide - window_size, k*slide)``, and a
    message is acked with the emission after which no later window holds
    it; an optional ``interval`` also emits the current window on a timer,
    holding no acks;
  - session: a ``gap`` of inactivity closes the session.
- Close flushes what is held. An emission's ``VecAck`` holds its sources'
  acks until the emitted batch is acked downstream (at-least-once).

    type: tumbling_window
    interval: 1s
    type: sliding_window
    window_size: 10
    slide_size: 5          # default window_size
    interval: 1s           # optional timer emission
    type: session_window
    gap: 500ms
"""

from __future__ import annotations

import asyncio
from collections import deque
from typing import Optional

from arkflow_tpu_torch.batch import META_SOURCE, MessageBatch
from arkflow_tpu_torch.components import Ack, Buffer, Resource, VecAck, register_buffer
from arkflow_tpu_torch.errors import ConfigError, not_ported
from arkflow_tpu_torch.utils.duration import parse_duration

DEFAULT_INPUT = "__default__"


class WindowBase(Buffer):
    """Shared machinery: per-input queues and the condition the reader waits on."""

    def __init__(self):
        self._queues: dict[str, deque] = {}
        self._cond = asyncio.Condition()
        self._closed = False

    # -- subclass hooks ----------------------------------------------------

    def _on_write_locked(self, now: float) -> None:
        """Called under the lock after a batch is queued."""

    def _next_deadline(self, now: float) -> Optional[float]:
        """Next instant at which _take_due may produce output, or None."""
        raise NotImplementedError

    def _take_due_locked(self, now: float, closing: bool) -> Optional[tuple[dict, VecAck]]:
        """If a window is due, drain it: {input_name: [batches]}, acks."""
        raise NotImplementedError

    # -- Buffer contract ---------------------------------------------------

    async def write(self, batch: MessageBatch, ack: Ack) -> None:
        name = batch.get_meta(META_SOURCE) or DEFAULT_INPUT
        async with self._cond:
            self._queues.setdefault(name, deque()).append((batch, ack))
            self._on_write_locked(asyncio.get_running_loop().time())
            self._cond.notify_all()

    async def read(self) -> Optional[tuple[MessageBatch, Ack]]:
        while True:
            async with self._cond:
                now = asyncio.get_running_loop().time()
                due = self._take_due_locked(now, closing=self._closed)
                if due is not None:
                    emitted = self._emit(due)
                    if emitted is not None:
                        return emitted
                    continue
                if self._closed:
                    return None
                deadline = self._next_deadline(now)
                timeout = None if deadline is None else max(0.0, deadline - now)
                try:
                    await asyncio.wait_for(self._cond.wait(), timeout=timeout)
                except asyncio.TimeoutError:
                    pass

    async def close(self) -> None:
        async with self._cond:
            self._closed = True
            self._cond.notify_all()

    # -- emission ----------------------------------------------------------

    @staticmethod
    def _emit(due: tuple[dict, VecAck]) -> Optional[tuple[MessageBatch, Ack]]:
        per_input, acks = due
        merged = [MessageBatch.concat(batches) for batches in per_input.values() if batches]
        if not merged:
            return None
        return MessageBatch.concat(merged), acks

    @staticmethod
    def _skip(acks: VecAck) -> None:
        """Fire a drained window's acks without an emission."""
        asyncio.get_running_loop().create_task(acks.ack())
        return None


class TumblingWindow(WindowBase):
    """Fixed, non-overlapping time window."""

    def __init__(self, interval_s: float):
        super().__init__()
        if interval_s <= 0:
            raise ConfigError("tumbling_window.interval must be positive")
        self.interval_s = interval_s
        self._window_start: Optional[float] = None

    def _on_write_locked(self, now: float) -> None:
        if self._window_start is None:
            self._window_start = now

    def _next_deadline(self, now: float) -> Optional[float]:
        if self._window_start is None:
            return None
        return self._window_start + self.interval_s

    def _take_due_locked(self, now: float, closing: bool):
        if not any(self._queues.values()):
            self._window_start = None
            return None
        due = closing or (
            self._window_start is not None and now >= self._window_start + self.interval_s)
        if not due:
            return None
        per_input = {name: [b for b, _ in q] for name, q in self._queues.items()}
        acks = VecAck([a for q in self._queues.values() for _, a in q])
        for q in self._queues.values():
            q.clear()
        self._window_start = None
        return per_input, acks


class SlidingWindow(WindowBase):
    """Message-count window with overlap: window k covers messages
    ``[k*slide - window_size, k*slide)``, the same whatever the reader's and
    writer's interleaving. A message's ack fires with the emission after
    which it can no longer appear in any later window. An optional
    ``interval`` also emits the current window's contents on a timer."""

    def __init__(self, window_size: int, slide_size: int, interval_s: float | None = None):
        super().__init__()
        if window_size <= 0 or slide_size <= 0:
            raise ConfigError("sliding_window sizes must be positive")
        if interval_s is not None and interval_s <= 0:
            raise ConfigError("sliding_window.interval must be positive")
        self.window_size = window_size
        self.slide_size = slide_size
        self.interval_s = interval_s
        self._last_interval_emit: float | None = None
        self._messages: deque = deque()  # (input_name, batch, ack, idx)
        self._total = 0
        self._next_boundary = slide_size
        self._last_emit_end = 0

    async def write(self, batch: MessageBatch, ack: Ack) -> None:  # one global order
        name = batch.get_meta(META_SOURCE) or DEFAULT_INPUT
        async with self._cond:
            self._messages.append((name, batch, ack, self._total))
            self._total += 1
            self._cond.notify_all()

    def _next_deadline(self, now: float) -> Optional[float]:
        if self.interval_s is None or not self._messages:
            return None
        if self._total <= self._last_emit_end:
            return None  # nothing new since the last emission: no timer to arm
        if self._last_interval_emit is None:
            self._last_interval_emit = now
        return self._last_interval_emit + self.interval_s

    def _take_due_locked(self, now: float, closing: bool):
        if not self._messages:
            return None
        if (self.interval_s is not None and self._last_interval_emit is not None
                and now >= self._last_interval_emit + self.interval_s
                and self._total > self._last_emit_end):
            # timer emission: the last window_size messages, nothing expires
            # (count boundaries still govern acks)
            self._last_interval_emit = now
            per_input: dict[str, list] = {}
            for name, b, _, idx in self._messages:
                if idx >= max(0, self._total - self.window_size):
                    per_input.setdefault(name, []).append(b)
            self._last_emit_end = self._total
            return per_input, VecAck()
        if self._total >= self._next_boundary:
            k = self._next_boundary
            self._next_boundary += self.slide_size
            expire_before = k + self.slide_size - self.window_size
        elif closing and self._total > self._last_emit_end:
            k = self._total  # the final partial window of messages not yet emitted
            self._next_boundary = k + self.slide_size
            expire_before = self._total
        elif closing:
            # every message went out in a boundary window: release the
            # remaining acks without emitting again
            acks = VecAck([a for _, _, a, _ in self._messages])
            self._messages.clear()
            return self._skip(acks)
        else:
            return None
        self._last_emit_end = k
        lo = max(0, k - self.window_size)
        per_input = {}
        for name, b, _, idx in self._messages:
            if lo <= idx < k:
                per_input.setdefault(name, []).append(b)
        acks = VecAck()
        while self._messages and self._messages[0][3] < expire_before:
            acks.push(self._messages.popleft()[2])
        return per_input, acks


class SessionWindow(WindowBase):
    """Activity-gap sessions: ``gap`` of silence closes the session."""

    def __init__(self, gap_s: float):
        super().__init__()
        if gap_s <= 0:
            raise ConfigError("session_window.gap must be positive")
        self.gap_s = gap_s
        self._last_write: Optional[float] = None

    def _on_write_locked(self, now: float) -> None:
        self._last_write = now

    def _next_deadline(self, now: float) -> Optional[float]:
        if self._last_write is None:
            return None
        return self._last_write + self.gap_s

    def _take_due_locked(self, now: float, closing: bool):
        if not any(self._queues.values()):
            return None
        due = closing or (self._last_write is not None and now >= self._last_write + self.gap_s)
        if not due:
            return None
        per_input = {name: [b for b, _ in q] for name, q in self._queues.items()}
        acks = VecAck([a for q in self._queues.values() for _, a in q])
        for q in self._queues.values():
            q.clear()
        self._last_write = None
        return per_input, acks


def _check(type_name: str, required: str):
    def check(config: dict) -> None:
        if config.get("query") is not None:
            raise not_ported(f"{type_name}.query (the windowed SQL join)")
        if config.get(required) is None:
            raise ConfigError(f"{type_name} requires {required!r}")
    return check


@register_buffer("tumbling_window", keys=("interval", "query", "inputs"),
                 check=_check("tumbling_window", "interval"))
def _build_tumbling(config: dict, resource: Resource) -> TumblingWindow:
    return TumblingWindow(parse_duration(config["interval"]))


@register_buffer("sliding_window", keys=("window_size", "slide_size", "interval", "query",
                                         "inputs"),
                 check=_check("sliding_window", "window_size"))
def _build_sliding(config: dict, resource: Resource) -> SlidingWindow:
    ws = config["window_size"]
    interval = config.get("interval")
    return SlidingWindow(int(ws), int(config.get("slide_size", ws)),
                         interval_s=parse_duration(interval) if interval is not None else None)


@register_buffer("session_window", keys=("gap", "query", "inputs"),
                 check=_check("session_window", "gap"))
def _build_session(config: dict, resource: Resource) -> SessionWindow:
    return SessionWindow(parse_duration(config["gap"]))
