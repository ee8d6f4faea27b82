"""Memory buffer: capacity-or-timeout micro-batcher, with optional coalescing
onto the bucket grid.

Counterpart of ``arkflow_tpu/plugins/buffer/memory.py``. Written batches
accumulate until ``capacity`` rows are held or ``timeout`` passes since the
first write, then leave merged, one batch per tenant, whose ``VecAck``
holds the source acks until the merged batch is acked downstream. With ``coalesce`` the emissions are carved by
``MicroBatchCoalescer`` instead: exactly the top batch bucket (row mode) or
a token-budget-filling row prefix (token mode, for packed serving), with the
``deadline`` bounding how long rows wait for a full emission. The coalescer
registers with ``bucket_cap_bus()``, so a runner's OOM cap shrinks it, and
the buffer registers as the bus's shape listener: a shape tuner's commit
(``tpu/tuner.py``) retargets its grid, token budget and deadline through
``retarget_shapes``, directly when the stream bound the tuner to it. The
coalescer's suspects (the sources of a nacked emission, redelivered) leave
alone and ahead of the held rows, on a deadline flush and on close too.

Tenant lanes: rows of different tenants (``__meta_ext_tenant``) never share
an emission, which has one fair-share and quota identity and one cache
fingerprint. With ``coalesce`` each tenant has its own coalescer (a lane);
the untagged lane stays apart, since its batches lack the tenant column and
would not concatenate with tagged ones. Exact pops visit the lanes round
robin, and a deadline flush serves every backlogged lane in one pass. The
lane count is capped by ``cap_tenant_label`` (the controller's rule: its
configured tenants reserved, ``max_tracked`` when the stream's controller
is attached through ``attach_overload_controller``, else 64), the long
tail sharing one tagged ``__other__`` lane. A lane made late takes the
current grid and budget (after a tuner's retarget) and the bus's OOM cap.

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

Not yet ported (it raises): ``coalesce.dp``.
"""

from __future__ import annotations

import asyncio
from collections import deque
from typing import Optional

from arkflow_tpu_torch.batch import META_EXT_TENANT, MessageBatch
from arkflow_tpu_torch.components import Ack, Buffer, Resource, VecAck, register_buffer
from arkflow_tpu_torch.errors import ConfigError, not_ported
from arkflow_tpu_torch.runtime.overload import DEFAULT_TENANT, MAX_TENANT_LABELS, cap_tenant_label
from arkflow_tpu_torch.tpu.bucketing import MicroBatchCoalescer, bucket_cap_bus
from arkflow_tpu_torch.utils.duration import parse_duration

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
        #: tenant key -> its coalescer; None is the untagged lane
        #: (``self._coalescer``)
        self._tenant_coalescers: dict[Optional[str], MicroBatchCoalescer] = {}
        #: round-robin order of the lanes' exact pops and flushes
        self._lane_rr: deque[Optional[str]] = deque()
        #: what a late lane is made from (the grid and budget follow retargets)
        self._coalesce_kwargs: Optional[dict] = None
        #: the stream's tenant policy (``attach_overload_controller``)
        self._tenant_policy = None
        bound = capacity * self.BACKPRESSURE_FACTOR
        if coalesce_buckets:
            self._coalesce_kwargs = dict(token_budget=token_budget, token_field=token_field,
                                         token_bytes=token_bytes,
                                         max_row_tokens=max_row_tokens)
            self._coalescer = self._new_lane(None, coalesce_buckets)
            self._coalesce_buckets = self._coalescer.buckets
            # a tuner's commit retargets the buffer
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
        #: emissions already carved (per tenant, or by a flush pass) that
        #: read() hands out next; their rows still count in ``_held_rows``
        self._ready: deque[tuple[MessageBatch, Ack]] = deque()
        self._held_rows = 0
        self._first_write_at: Optional[float] = None
        self._cond = asyncio.Condition()
        self._closed = False

    def _new_lane(self, key: Optional[str], buckets) -> MicroBatchCoalescer:
        lane = MicroBatchCoalescer(buckets, **self._coalesce_kwargs)
        # a runner's device OOM caps every lane's grid (registering replays
        # the current cap onto a late lane)
        bucket_cap_bus().register(lane)
        self._tenant_coalescers[key] = lane
        self._lane_rr.append(key)
        return lane

    @staticmethod
    def _tenant_key(batch: MessageBatch) -> Optional[str]:
        """None for a batch without the tenant column (its schema differs
        from a tagged batch's); an empty tenant is ``default``, as the
        controller labels it."""
        if not batch.has_column(META_EXT_TENANT):
            return None
        return batch.tenant("") or DEFAULT_TENANT

    def attach_overload_controller(self, controller) -> None:
        """The stream's hook (``runtime/overload.attach_overload``): lanes cap
        with the controller's reserved tenants and ``max_tracked``."""
        self._tenant_policy = controller.cfg.tenants

    def _lane(self, batch: MessageBatch) -> MicroBatchCoalescer:
        key = self._tenant_key(batch)
        if key is not None:
            policy = self._tenant_policy
            key = cap_tenant_label(
                key, self._tenant_coalescers, reserved=(policy.weights if policy is not None else ()),
                cap=(policy.max_tracked if policy is not None else MAX_TENANT_LABELS))
        lane = self._tenant_coalescers.get(key)
        if lane is None:
            lane = self._new_lane(key, self._coalesce_buckets)
        return lane

    @property
    def pending_entries(self) -> int:
        """Held entries over every lane (coalescer mode)."""
        return sum(c.pending for c in self._tenant_coalescers.values())

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
        if token_budget is not None and c.token_budget is not None:
            if self._max_row_tokens is not None:
                token_budget = min(token_budget, bound * self._max_row_tokens)
            self._coalesce_kwargs["token_budget"] = token_budget
        for lane in self._tenant_coalescers.values():
            lane.retarget(buckets, token_budget)
        if deadline_s is not None:
            self._deadline_s = deadline_s
        return True

    async def write(self, batch: MessageBatch, ack: Ack) -> None:
        async with self._cond:
            while (self._held_rows >= self.capacity * self.BACKPRESSURE_FACTOR
                   and not self._closed):
                await self._cond.wait()
            if self._first_write_at is None:
                self._first_write_at = asyncio.get_running_loop().time()
            if self._coalescer is not None:
                self._lane(batch).add(batch, ack)
            else:
                self._held.append((batch, ack))
            self._held_rows += batch.num_rows
            # always notify: a waiting reader recomputes its deadline
            self._cond.notify_all()

    def _emit_locked(self) -> tuple[MessageBatch, Ack]:
        """Plain path: the held batches merged, one emission per tenant in
        order of first arrival. The first goes out now, the rest wait in
        ``_ready`` for the next reads, still counted in ``_held_rows``."""
        groups: dict[Optional[str], list[tuple[MessageBatch, Ack]]] = {}
        for b, a in self._held:
            groups.setdefault(self._tenant_key(b), []).append((b, a))
        self._held = []
        self._first_write_at = None
        for pairs in groups.values():
            self._ready.append((MessageBatch.concat([b for b, _ in pairs]),
                                VecAck([a for _, a in pairs])))
        return self._pop_ready_locked()

    def _pop_ready_locked(self) -> tuple[MessageBatch, Ack]:
        batch, ack = self._ready.popleft()
        self._held_rows -= batch.num_rows
        self._cond.notify_all()  # wake writers blocked on backpressure
        return batch, ack

    def _emit_coalesced_locked(self, *, flush: bool) -> Optional[tuple[MessageBatch, Ack]]:
        """An exact emission from the lanes in round-robin order; on
        ``flush`` (deadline, close) one pass first takes a flush emission
        from every lane into ``_ready``, so K lanes' tails do not wait K
        deadlines."""
        if flush and not self._ready:
            for _ in range(len(self._lane_rr)):
                key = self._lane_rr[0]
                self._lane_rr.rotate(-1)
                emission = self._tenant_coalescers[key].pop_flush()
                if emission is not None:
                    self._ready.append(emission)
        if self._ready:
            emission = self._ready.popleft()
        else:
            emission = None
            for _ in range(len(self._lane_rr)):
                key = self._lane_rr[0]
                self._lane_rr.rotate(-1)
                emission = self._tenant_coalescers[key].pop_exact()
                if emission is not None:
                    break
            if emission is None:
                return None
        self._held_rows -= emission[0].num_rows
        if self.pending_entries == 0 and not self._ready:
            self._first_write_at = None
        else:
            # the held tail's deadline restarts, else a long-ago first write
            # would flush every tail at once (no coalescing at all)
            self._first_write_at = asyncio.get_running_loop().time()
        self._cond.notify_all()  # wake writers blocked on backpressure
        return emission

    async def read(self) -> Optional[tuple[MessageBatch, Ack]]:
        if self._coalescer is not None:
            return await self._read_coalesced()
        while True:
            async with self._cond:
                if self._ready:  # tenant groups of an earlier flush first
                    return self._pop_ready_locked()
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
