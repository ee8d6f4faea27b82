"""Token-bucket rate limiter of the HTTP input.

Counterpart of ``arkflow_tpu/utils/rate_limiter.py``: refill and acquire
run under a lock, on ``time.monotonic()``; ``time_until`` gives the
``Retry-After`` of a 429 without spending tokens.
"""

from __future__ import annotations

import math
import threading
import time

from arkflow_tpu_torch.errors import ConfigError


class TokenBucket:
    def __init__(self, capacity: int | float, refill_per_sec: float):
        if capacity <= 0 or refill_per_sec <= 0:
            raise ConfigError("rate limiter needs positive capacity and refill rate")
        self.capacity = float(capacity)
        self.refill_per_sec = float(refill_per_sec)
        self._tokens = float(capacity)
        self._last = time.monotonic()
        # concurrent try_acquire/time_until callers (tenant buckets shared
        # across worker threads): refill+test+consume must be one atomic
        # step or two racing acquirers both spend the same tokens
        self._lock = threading.Lock()

    def _refill(self, now: float) -> None:
        # monotonic never steps backward, but guard the subtraction anyway:
        # a bucket constructed on one thread and first used on another may
        # observe interleaved _last updates during lock-free reads in tests
        elapsed = max(0.0, now - self._last)
        self._tokens = min(self.capacity, self._tokens + elapsed * self.refill_per_sec)
        self._last = now

    def try_acquire(self, n: float = 1.0) -> bool:
        with self._lock:
            self._refill(time.monotonic())
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def drain(self, n: float = 1.0) -> None:
        """Consume ``n`` tokens unconditionally — the balance may go
        NEGATIVE (debt). For admission paths that gate on a
        capacity-clamped availability check but must charge the REAL cost
        of an oversized unit: the debt throttles every subsequent
        acquisition until the refill pays it off, so a batch 10x the burst
        allowance still averages out to the contracted rate instead of
        riding the clamp 10x over quota."""
        with self._lock:
            self._refill(time.monotonic())
            self._tokens -= n

    def time_until(self, n: float = 1.0) -> float:
        """Seconds until ``n`` tokens will be available (0.0 = available
        now). Does NOT consume tokens — the HTTP input's 429 path computes
        ``Retry-After`` from the deficit so well-behaved clients back off
        for exactly as long as the bucket needs. ``n`` beyond capacity can
        never be satisfied: returns ``math.inf``."""
        if n > self.capacity:
            return math.inf
        with self._lock:
            self._refill(time.monotonic())
            if self._tokens >= n:
                return 0.0
            return (n - self._tokens) / self.refill_per_sec
