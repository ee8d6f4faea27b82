"""Per-output circuit breaker for the delivery path.

Counterpart of ``arkflow_tpu/utils/circuit_breaker.py``: a three-state
breaker (closed -> open -> half-open -> closed) around ``output.write``.
After ``failure_threshold`` consecutive failures it opens and callers wait
out ``reset_timeout``; the first caller after the cooldown is the half-open
probe, whose outcome closes the breaker or opens it for another cooldown.
A breaker never drops work: ``acquire()`` delays callers, it does not fail
them. The optional ``gauge`` and ``trip_counter`` are the JAX package's
metric hooks (``arkflow_circuit_state``, ``arkflow_circuit_trips_total``);
the plain attributes ``state`` and ``trips`` are kept beside them.
"""

from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Any, Mapping, Optional, Union

from arkflow_tpu_torch.errors import ConfigError
from arkflow_tpu_torch.utils.duration import parse_duration

CLOSED, OPEN, HALF_OPEN = 0, 1, 2
_STATE_NAMES = {CLOSED: "closed", OPEN: "open", HALF_OPEN: "half_open"}


@dataclass(frozen=True)
class CircuitBreakerConfig:
    #: consecutive write failures that trip the breaker open
    failure_threshold: int = 5
    #: seconds the breaker stays open before a half-open probe
    reset_timeout_s: float = 30.0

    @classmethod
    def from_config(cls, cfg: Union[Mapping[str, Any], bool, None]
                    ) -> Optional["CircuitBreakerConfig"]:
        """None or False: disabled (None); True: the defaults; a mapping:
        parsed."""
        if cfg is None or cfg is False:
            return None
        if cfg is True:
            return cls()
        if not isinstance(cfg, Mapping):
            raise ConfigError("circuit_breaker must be a mapping or boolean")
        c = cls(failure_threshold=int(cfg.get("failure_threshold", 5)),
                reset_timeout_s=parse_duration(str(cfg.get("reset_timeout", "30s"))))
        if c.failure_threshold < 1:
            raise ConfigError("circuit_breaker failure_threshold must be >= 1")
        if c.reset_timeout_s < 0:
            raise ConfigError("circuit_breaker reset_timeout must be >= 0")
        return c


class CircuitBreaker:
    """Wrap write attempts in ``await acquire()`` and ``record_success()`` /
    ``record_failure()``. ``gauge`` and ``trip_counter``: optional metrics
    fed beside ``state`` and ``trips``."""

    def __init__(self, config: CircuitBreakerConfig, gauge=None, trip_counter=None):
        self.config = config
        self.gauge = gauge
        self.trip_counter = trip_counter
        self._state = CLOSED
        self._consecutive_failures = 0
        self._opened_at = 0.0
        self._probe_in_flight = False
        #: closed -> open transitions (JAX: ``arkflow_circuit_trips_total``)
        self.trips = 0
        #: transition log (bounded), for tests and debugging
        self.history: list[str] = [_STATE_NAMES[CLOSED]]
        if self.gauge is not None:
            self.gauge.set(CLOSED)

    @property
    def state(self) -> str:
        """``closed``, ``open`` or ``half_open`` (JAX:
        ``arkflow_circuit_state``)."""
        return _STATE_NAMES[self._state]

    def _set_state(self, state: int) -> None:
        if state == self._state:
            return
        self._state = state
        if len(self.history) < 1024:
            self.history.append(_STATE_NAMES[state])
        if self.gauge is not None:
            self.gauge.set(state)

    def _trip(self) -> None:
        self._opened_at = time.monotonic()
        self._set_state(OPEN)
        self.trips += 1
        if self.trip_counter is not None:
            self.trip_counter.inc()

    async def acquire(self) -> None:
        """Wait until the breaker permits a write attempt. Returns holding
        the probe slot when half-open: the caller must follow with exactly
        one ``record_success()`` or ``record_failure()``."""
        while True:
            if self._state == CLOSED:
                return
            if self._state == OPEN:
                remaining = self._opened_at + self.config.reset_timeout_s - time.monotonic()
                if remaining > 0:
                    await asyncio.sleep(remaining)
                    continue
                self._set_state(HALF_OPEN)
                self._probe_in_flight = False
            if self._state == HALF_OPEN:
                if not self._probe_in_flight:
                    self._probe_in_flight = True  # this caller is the probe
                    return
                # another probe is in flight; wait for its verdict
                await asyncio.sleep(min(0.01, self.config.reset_timeout_s or 0.01))

    def record_success(self) -> None:
        self._consecutive_failures = 0
        self._probe_in_flight = False
        if self._state != CLOSED:
            self._set_state(CLOSED)

    def record_failure(self) -> None:
        self._consecutive_failures += 1
        if self._state == HALF_OPEN:
            # a failed probe: back to a full cooldown
            self._probe_in_flight = False
            self._trip()
        elif self._state == CLOSED and \
                self._consecutive_failures >= self.config.failure_threshold:
            self._trip()
