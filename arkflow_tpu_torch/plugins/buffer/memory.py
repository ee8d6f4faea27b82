"""Memory buffer: capacity-or-timeout micro-batcher, with optional coalescing
onto the bucket grid.

Counterpart of ``arkflow_tpu/plugins/buffer/memory.py`` with a single lane.
Written batches accumulate until ``capacity`` rows are held or ``timeout``
passes since the first write, then leave as one merged batch whose
``VecAck`` holds the source acks until the merged batch is acked
downstream. With ``coalesce`` the emissions are carved by
``MicroBatchCoalescer`` instead: exactly the top batch bucket (row mode) or
a token-budget-filling row prefix (token mode, for packed serving), with the
``deadline`` bounding how long rows wait for a full emission. The coalescer
registers with ``bucket_cap_bus()``, so a runner's OOM cap shrinks it, and
the buffer registers as the bus's shape listener: a shape tuner's commit
(``tpu/tuner.py``) retargets its grid, token budget and deadline through
``retarget_shapes``, directly when the stream bound the tuner to it. The
coalescer's suspects (the sources of a nacked emission, redelivered) leave
alone and ahead of the held rows, on a deadline flush and on close too.

    type: memory
    capacity: 64           # rows (flush threshold; backpressure bound x4)
    timeout: 5ms
    coalesce:
      batch_buckets: [64]  # the runner's batch buckets
      deadline: 250ms      # max wait for a full emission (default: timeout)
      token_budget: 15872  # packed serving: tokens per emission
      token_field: __value__
      token_bytes: 4.0     # bytes-per-token estimate for subword tokenizers
      max_row_tokens: 256  # clamp per-row estimates to the truncation width

Not yet ported (they raise): ``coalesce.dp`` and tenant lanes (batches
carrying ``__meta_ext_tenant``); the overload hook is absent.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import Ack, Buffer, Resource, VecAck, register_buffer
from arkflow_tpu_torch.errors import ConfigError, not_ported
from arkflow_tpu_torch.tpu.bucketing import MicroBatchCoalescer, bucket_cap_bus
from arkflow_tpu_torch.utils.duration import parse_duration

#: the tenant column of the JAX package's multi-tenant lanes
META_EXT_TENANT = "__meta_ext_tenant"
_COALESCE_KEYS = ("batch_buckets", "deadline", "token_budget", "token_field",
                  "token_bytes", "max_row_tokens")


class MemoryBuffer(Buffer):
    #: write() blocks once held rows reach this multiple of capacity,
    #: restoring the backpressure the bounded queues give without a buffer
    BACKPRESSURE_FACTOR = 4

    def __init__(self, capacity: int, timeout_s: Optional[float] = None,
                 coalesce_buckets: Optional[list[int]] = None,
                 coalesce_deadline_s: Optional[float] = None,
                 token_budget: Optional[int] = None,
                 token_field: Optional[str] = None,
                 token_bytes: Optional[float] = None,
                 max_row_tokens: Optional[int] = None):
        if capacity <= 0:
            raise ConfigError("buffer.capacity must be positive")
        self.capacity = capacity
        self.timeout_s = timeout_s
        self._coalescer: Optional[MicroBatchCoalescer] = None
        self._deadline_s: Optional[float] = None
        #: the coalesce grid as configured or last retargeted (an OOM cap
        #: shrinks the coalescer's own, not this): what ``expect`` matches
        self._coalesce_buckets: Optional[tuple[int, ...]] = None
        self._max_row_tokens = max_row_tokens
        bound = capacity * self.BACKPRESSURE_FACTOR
        if coalesce_buckets:
            self._coalescer = MicroBatchCoalescer(
                coalesce_buckets, token_budget=token_budget, token_field=token_field,
                token_bytes=token_bytes, max_row_tokens=max_row_tokens)
            self._coalesce_buckets = self._coalescer.buckets
            # a runner's device OOM caps this coalescer's grid too, and a
            # tuner's commit retargets the buffer
            bucket_cap_bus().register(self._coalescer)
            bucket_cap_bus().register_listener(self)
            self._deadline_s = (coalesce_deadline_s if coalesce_deadline_s is not None
                                else timeout_s)
            if self._deadline_s is None:
                # without a deadline, sub-bucket rows (and their acks, split
                # shares included) would wait unemitted until shutdown
                raise ConfigError(
                    "buffer.coalesce requires 'deadline' (or a buffer 'timeout')")
            if self._coalescer.target > bound:
                raise ConfigError(
                    f"coalesce bucket {self._coalescer.target} exceeds the buffer's "
                    f"backpressure bound {bound} rows (raise capacity or shrink "
                    "batch_buckets)")
            if token_budget is not None and max_row_tokens is not None \
                    and token_budget > bound * max_row_tokens:
                # write() blocks at the bound, so held tokens never exceed
                # bound * max_row_tokens: every emission would wait out the
                # deadline and flush as a fragment
                raise ConfigError(
                    f"coalesce token_budget {token_budget} exceeds the buffer's "
                    f"attainable bound {bound * max_row_tokens} tokens (capacity x "
                    f"{self.BACKPRESSURE_FACTOR} rows x max_row_tokens; raise "
                    "capacity or shrink the budget)")
        self._held: list[tuple[MessageBatch, Ack]] = []
        self._held_rows = 0
        self._first_write_at: Optional[float] = None
        self._cond = asyncio.Condition()
        self._closed = False

    @property
    def coalescer(self) -> Optional[MicroBatchCoalescer]:
        """The coalescer ``retarget_shapes`` retargets (None without
        ``coalesce``): the bus's broadcast passes it over."""
        return self._coalescer

    def retarget_shapes(self, batch_buckets, token_budget, deadline_s, *,
                        expect=None) -> bool:
        """A shape tuner's commit: adopt a new coalesce grid, budget and
        deadline when the current grid is ``expect`` (the tuner's incumbent;
        a mismatch is another stream's grid, or a misconfiguration the tuner
        logs). Buckets above the backpressure bound are dropped, and the
        budget is held to what the bound lets the buffer hold. Returns
        whether it applied."""
        c = self._coalescer
        if c is None:
            return False
        if expect is not None and self._coalesce_buckets != tuple(sorted(expect)):
            return False
        bound = self.capacity * self.BACKPRESSURE_FACTOR
        buckets = tuple(sorted(int(b) for b in batch_buckets if int(b) <= bound))
        if not buckets:
            return False
        self._coalesce_buckets = buckets
        if token_budget is not None and c.token_budget is not None \
                and self._max_row_tokens is not None:
            token_budget = min(token_budget, bound * self._max_row_tokens)
        c.retarget(buckets, token_budget)
        if deadline_s is not None:
            self._deadline_s = deadline_s
        return True

    async def write(self, batch: MessageBatch, ack: Ack) -> None:
        if batch.has_column(META_EXT_TENANT):
            raise not_ported("memory buffer tenant lanes")
        async with self._cond:
            while (self._held_rows >= self.capacity * self.BACKPRESSURE_FACTOR
                   and not self._closed):
                await self._cond.wait()
            if self._first_write_at is None:
                self._first_write_at = asyncio.get_running_loop().time()
            if self._coalescer is not None:
                self._coalescer.add(batch, ack)
            else:
                self._held.append((batch, ack))
            self._held_rows += batch.num_rows
            # always notify: a waiting reader recomputes its deadline
            self._cond.notify_all()

    def _emitted_locked(self, emission: tuple[MessageBatch, Ack]) -> tuple[MessageBatch, Ack]:
        self._held_rows -= emission[0].num_rows
        self._cond.notify_all()  # wake writers blocked on backpressure
        return emission

    def _emit_locked(self) -> tuple[MessageBatch, Ack]:
        """Plain path: every held batch as one merged emission."""
        batch = MessageBatch.concat([b for b, _ in self._held])
        ack = VecAck([a for _, a in self._held])
        self._held = []
        self._first_write_at = None
        return self._emitted_locked((batch, ack))

    def _emit_coalesced_locked(self, *, flush: bool) -> Optional[tuple[MessageBatch, Ack]]:
        c = self._coalescer
        emission = c.pop_flush() if flush else c.pop_exact()
        if emission is None:
            return None
        if c.pending == 0:
            self._first_write_at = None
        else:
            # the held tail's deadline restarts, else a long-ago first write
            # would flush every tail at once (no coalescing at all)
            self._first_write_at = asyncio.get_running_loop().time()
        return self._emitted_locked(emission)

    async def read(self) -> Optional[tuple[MessageBatch, Ack]]:
        if self._coalescer is not None:
            return await self._read_coalesced()
        while True:
            async with self._cond:
                if self._held_rows >= self.capacity:
                    return self._emit_locked()
                if self._closed:
                    return self._emit_locked() if self._held else None
                timeout = None
                if self.timeout_s is not None and self._first_write_at is not None:
                    now = asyncio.get_running_loop().time()
                    timeout = max(0.0, self._first_write_at + self.timeout_s - now)
                    if timeout <= 0 and self._held:
                        return self._emit_locked()
                try:
                    await asyncio.wait_for(self._cond.wait(), timeout=timeout)
                except asyncio.TimeoutError:
                    if self._held:
                        return self._emit_locked()

    async def _read_coalesced(self) -> Optional[tuple[MessageBatch, Ack]]:
        while True:
            async with self._cond:
                deadline_over = False
                timeout = None
                if self._first_write_at is not None:
                    now = asyncio.get_running_loop().time()
                    timeout = max(0.0, self._first_write_at + self._deadline_s - now)
                    deadline_over = timeout <= 0
                emission = self._emit_coalesced_locked(flush=self._closed or deadline_over)
                if emission is not None:
                    return emission
                if self._closed:
                    return None
                try:
                    await asyncio.wait_for(self._cond.wait(), timeout=timeout)
                except asyncio.TimeoutError:
                    pass  # the loop re-evaluates the deadline flush

    async def close(self) -> None:
        async with self._cond:
            self._closed = True
            self._cond.notify_all()


def _positive_int(value, what: str) -> int:
    if isinstance(value, bool) or not isinstance(value, int) or value < 1:
        raise ConfigError(f"buffer.coalesce {what} must be a positive int, got {value!r}")
    return value


def _check(config: dict) -> None:
    if config.get("capacity") is None:
        raise ConfigError("memory buffer requires 'capacity'")
    coalesce = config.get("coalesce") or {}
    if not isinstance(coalesce, dict):
        raise ConfigError("buffer.coalesce must be a mapping")
    for key in coalesce:
        if key not in _COALESCE_KEYS:
            raise not_ported(f"buffer.coalesce.{key}")
    if coalesce and not coalesce.get("batch_buckets"):
        raise ConfigError("buffer.coalesce requires 'batch_buckets'")
    if coalesce.get("token_budget") is not None:
        _positive_int(coalesce["token_budget"], "token_budget")
    if coalesce.get("token_bytes") is not None and float(coalesce["token_bytes"]) <= 0:
        raise ConfigError(
            f"buffer.coalesce token_bytes must be positive, got {coalesce['token_bytes']}")
    if coalesce.get("max_row_tokens") is not None:
        _positive_int(int(coalesce["max_row_tokens"]), "max_row_tokens")


@register_buffer("memory", keys=("capacity", "timeout", "coalesce"), check=_check)
def _build(config: dict, resource: Resource) -> MemoryBuffer:
    coalesce = config.get("coalesce") or {}
    timeout = config.get("timeout")
    deadline = coalesce.get("deadline")
    token_bytes = coalesce.get("token_bytes")
    max_row_tokens = coalesce.get("max_row_tokens")
    return MemoryBuffer(
        capacity=int(config["capacity"]),
        timeout_s=parse_duration(timeout) if timeout is not None else None,
        coalesce_buckets=[int(b) for b in coalesce.get("batch_buckets") or []] or None,
        coalesce_deadline_s=parse_duration(deadline) if deadline is not None else None,
        token_budget=coalesce.get("token_budget"),
        token_field=coalesce.get("token_field"),
        token_bytes=float(token_bytes) if token_bytes is not None else None,
        max_row_tokens=int(max_row_tokens) if max_row_tokens is not None else None,
    )
