"""Runner health state machine: whether a runner's device is trusted.

Counterpart of ``arkflow_tpu/tpu/health.py``. Every ``ModelRunner`` owns a
``RunnerHealth`` (through its ``ServingRunnerCore``):

    HEALTHY   -- serving normally
    DEGRADED  -- serving at reduced capability (the batch grid was capped
                 after a device OOM); the next successful step promotes it
                 back to HEALTHY (the cap itself stays, in ``bucket_cap``)
    UNHEALTHY -- a step hung past its deadline or failed; batches wait until
                 a recovery probe is due, with exponential backoff between
                 probes
    DEAD      -- ``dead_after`` consecutive incidents without one success;
                 terminal
    CORRUPT   -- quarantined for a proven integrity failure (a param-digest
                 drift confirmed by a failed golden probe, ``tpu/integrity.py``);
                 never re-admitted by the probe schedule, because a corrupt
                 device can pass a liveness probe and still answer wrongly.
                 Only ``mark_repaired`` (after a verified repair) exits it.

Step outcomes drive the transitions (``mark_success``, ``mark_unhealthy``,
``mark_degraded``). A recovery probe is a real traffic batch: when it is
due, one caller claims it (``join_or_begin_probe``) and every other caller
waits, and that batch's own step deadline bounds the damage if the device
is still hung. The state is exported on the ``arkflow_tpu_runner_health``
gauge (``GAUGE_VALUE``) when the owner passes one, as in the JAX package,
and on ``report()``.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional

from arkflow_tpu_torch.errors import ConfigError
from arkflow_tpu_torch.utils.duration import parse_duration

logger = logging.getLogger("arkflow_torch.health")

HEALTHY = "healthy"
DEGRADED = "degraded"
UNHEALTHY = "unhealthy"
DEAD = "dead"
CORRUPT = "corrupt"

#: gauge encoding for ``arkflow_tpu_runner_health``
GAUGE_VALUE = {HEALTHY: 0, DEGRADED: 1, UNHEALTHY: 2, DEAD: 3, CORRUPT: 4}


@dataclass(frozen=True)
class HealthConfig:
    """The recovery-probe schedule (config: ``health:`` on ``gpu_inference``)."""

    #: first probe delay after an incident; doubles per consecutive incident
    probe_backoff_s: float = 0.5
    #: cap on the probe backoff
    probe_backoff_cap_s: float = 30.0
    #: consecutive incidents (no success in between) before the runner is
    #: declared DEAD; 0 = never give up
    dead_after: int = 8

    @classmethod
    def from_config(cls, cfg: Optional[dict]) -> "HealthConfig":
        if not cfg:
            return cls()
        if not isinstance(cfg, dict):
            raise ConfigError("tpu_inference 'health' must be a mapping")

        def dur(key: str, default: float) -> float:
            raw = cfg.get(key)
            if raw is None:
                return default
            val = parse_duration(raw)
            if val <= 0:
                raise ConfigError(f"health.{key} must be positive")
            return val

        dead_after = cfg.get("dead_after", cls.dead_after)
        if not isinstance(dead_after, int) or dead_after < 0:
            raise ConfigError("health.dead_after must be an int >= 0")
        return cls(probe_backoff_s=dur("probe_backoff", cls.probe_backoff_s),
                   probe_backoff_cap_s=dur("probe_backoff_cap", cls.probe_backoff_cap_s),
                   dead_after=dead_after)


class RunnerHealth:
    """Thread-safe health tracker (marks arrive from executor threads and the
    event loop alike). ``clock`` is injectable for deterministic tests."""

    def __init__(self, config: Optional[HealthConfig] = None, *, name: str = "runner",
                 clock: Callable[[], float] = time.monotonic, gauge=None):
        self.cfg = config or HealthConfig()
        self._gauge = gauge
        self.name = name
        self._clock = clock
        self._lock = threading.Lock()
        self._state = HEALTHY
        if gauge is not None:
            gauge.set(GAUGE_VALUE[HEALTHY])
        self._consecutive_failures = 0
        self._next_probe_at = 0.0
        self._probing = False
        #: a dispatcher claimed the probe for a batch that re-enters through
        #: the runner's own gate: exactly one joiner may consume the claim
        self._probe_handoff = False
        self._last_reason = ""

    def _set(self, state: str) -> None:
        self._state = state
        if self._gauge is not None:
            self._gauge.set(GAUGE_VALUE[state])

    # -- inspection --------------------------------------------------------

    @property
    def state(self) -> str:
        return self._state

    def report(self) -> dict:
        """JSON-able snapshot for ``/health``."""
        with self._lock:
            rep = {"state": self._state, "consecutive_failures": self._consecutive_failures}
            if self._last_reason:
                rep["last_reason"] = self._last_reason
            if self._state == UNHEALTHY:
                rep["next_probe_in_s"] = round(max(0.0, self._next_probe_at - self._clock()), 3)
            return rep

    @property
    def probing(self) -> bool:
        """A recovery probe is claimed and has not ended yet."""
        return self._probing

    def probe_due(self, now: Optional[float] = None) -> bool:
        return (self._state == UNHEALTHY
                and (self._clock() if now is None else now) >= self._next_probe_at)

    def seconds_until_probe(self, now: Optional[float] = None) -> float:
        with self._lock:
            if self._state != UNHEALTHY:
                return 0.0
            return max(0.0, self._next_probe_at - (self._clock() if now is None else now))

    def available(self, now: Optional[float] = None) -> bool:
        """May a batch be dispatched here now? HEALTHY/DEGRADED always;
        UNHEALTHY only when a probe is due and nobody is probing."""
        s = self._state
        if s in (HEALTHY, DEGRADED):
            return True
        if s == UNHEALTHY:
            return not self._probing and self.probe_due(now)
        return False

    # -- transitions -------------------------------------------------------

    def try_begin_probe(self, now: Optional[float] = None) -> bool:
        """Claim the recovery-probe slot for a dispatcher. True when the
        caller should dispatch now: serving normally, or it just claimed
        the due probe."""
        with self._lock:
            if self._state in (HEALTHY, DEGRADED):
                return True
            if self._state in (DEAD, CORRUPT):
                return False
            now = self._clock() if now is None else now
            if self._probing or now < self._next_probe_at:
                return False
            self._probing = True
            self._probe_handoff = True
            return True

    def join_or_begin_probe(self, now: Optional[float] = None) -> bool:
        """Like ``try_begin_probe``, but the one batch a dispatcher claimed
        the probe for joins it; every other concurrent caller waits instead
        of piling onto a device that may still be hung."""
        with self._lock:
            if self._state in (HEALTHY, DEGRADED):
                return True
            if self._state in (DEAD, CORRUPT):
                return False
            if self._probing:
                if self._probe_handoff:
                    self._probe_handoff = False
                    return True
                return False
            now = self._clock() if now is None else now
            if now < self._next_probe_at:
                return False
            self._probing = True
            return True

    def mark_success(self) -> None:
        """A step completed: clear the incident streak, re-admit a suspect.
        CORRUPT stays: a quarantined runner still completes steps (wrong
        answers are the failure), so only ``mark_repaired`` re-admits it."""
        with self._lock:
            if self._state in (DEAD, CORRUPT):
                return
            self._probing = False
            self._probe_handoff = False
            self._consecutive_failures = 0
            if self._state != HEALTHY:
                logger.info("[%s] runner recovered -> HEALTHY", self.name)
                self._last_reason = ""
                self._set(HEALTHY)

    def mark_degraded(self, reason: str) -> None:
        """Serving continues at reduced capability (the batch grid capped)."""
        with self._lock:
            if self._state == HEALTHY:
                logger.warning("[%s] runner DEGRADED: %s", self.name, reason)
                self._last_reason = reason
                self._set(DEGRADED)

    def mark_unhealthy(self, reason: str) -> None:
        """An incident (deadline miss, failed step): stop serving, schedule
        a recovery probe with exponential backoff; DEAD at ``dead_after``."""
        with self._lock:
            if self._state in (DEAD, CORRUPT):
                return
            self._probing = False
            self._probe_handoff = False
            self._consecutive_failures += 1
            self._last_reason = reason
            if self.cfg.dead_after and self._consecutive_failures >= self.cfg.dead_after:
                logger.error("[%s] runner DEAD after %d consecutive incidents (last: %s)",
                             self.name, self._consecutive_failures, reason)
                self._set(DEAD)
                return
            backoff = min(self.cfg.probe_backoff_s
                          * (2.0 ** min(self._consecutive_failures - 1, 32)),
                          self.cfg.probe_backoff_cap_s)
            self._next_probe_at = self._clock() + backoff
            logger.warning("[%s] runner UNHEALTHY (%s); probe in %.2fs (incident %d)",
                           self.name, reason, backoff, self._consecutive_failures)
            self._set(UNHEALTHY)

    def mark_corrupt(self, reason: str) -> None:
        """Quarantine for a proven integrity failure; only ``mark_repaired``
        exits this state."""
        with self._lock:
            if self._state in (DEAD, CORRUPT):
                return
            self._probing = False
            self._probe_handoff = False
            self._last_reason = reason
            logger.error("[%s] runner CORRUPT, quarantined: %s", self.name, reason)
            self._set(CORRUPT)

    def mark_repaired(self) -> bool:
        """Exit quarantine after a verified repair. False (no change) from
        any other state: a repair never resurrects a DEAD runner."""
        with self._lock:
            if self._state != CORRUPT:
                return False
            self._probing = False
            self._probe_handoff = False
            self._consecutive_failures = 0
            self._last_reason = ""
            logger.info("[%s] runner repaired -> HEALTHY", self.name)
            self._set(HEALTHY)
            return True
