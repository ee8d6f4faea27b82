"""Retry with capped exponential backoff, for output writes and input
reconnects.

Counterpart of ``arkflow_tpu/utils/retry.py``: bounded attempts, an
exponential delay with a cap and optional jitter, and validation shared by
every config block that carries a ``retry`` (or ``reconnect``) mapping.
"""

from __future__ import annotations

import asyncio
import logging
import random
from dataclasses import dataclass
from typing import Callable, Optional

from arkflow_tpu_torch.errors import ConfigError

logger = logging.getLogger("arkflow_torch.retry")


@dataclass(frozen=True)
class RetryConfig:
    max_attempts: int = 3
    initial_delay_ms: int = 100
    max_delay_ms: int = 5000
    backoff_multiplier: float = 2.0
    #: 0..1 fraction of the capped delay added as random noise
    jitter: float = 0.0

    @classmethod
    def from_config(cls, cfg: Optional[dict]) -> "RetryConfig":
        if not cfg:
            return cls()
        rc = cls(
            max_attempts=int(cfg.get("max_attempts", 3)),
            initial_delay_ms=int(cfg.get("initial_delay_ms", 100)),
            max_delay_ms=int(cfg.get("max_delay_ms", 5000)),
            backoff_multiplier=float(cfg.get("backoff_multiplier", 2.0)),
            jitter=float(cfg.get("jitter", 0.0)),
        )
        rc.validate()
        return rc

    def validate(self) -> None:
        if self.max_attempts < 1:
            raise ConfigError("retry max_attempts must be >= 1")
        if self.initial_delay_ms < 0 or self.max_delay_ms < self.initial_delay_ms:
            raise ConfigError("retry delays must satisfy 0 <= initial <= max")
        if self.backoff_multiplier < 1.0:
            raise ConfigError("retry backoff_multiplier must be >= 1.0")
        if not (0.0 <= self.jitter <= 1.0):
            raise ConfigError("retry jitter must be in [0, 1]")

    def delay_s(self, attempt: int) -> float:
        """Delay before retry ``attempt`` (0-based): capped exponential, plus
        jitter. The exponent is clamped, since a reconnect-forever loop
        passes unbounded attempt counts (``2.0 ** 1024`` overflows)."""
        d = self.initial_delay_ms * (self.backoff_multiplier ** min(attempt, 64))
        d = min(d, self.max_delay_ms) / 1000.0
        if self.jitter:
            d *= 1.0 + random.random() * self.jitter
        return d


async def retry_with_backoff(op, config: RetryConfig, *, what: str = "operation",
                             retry_on: tuple = (Exception,),
                             on_retry: Optional[Callable[[], None]] = None):
    """``await op()`` with up to ``config.max_attempts`` tries. A
    ``ConfigError`` fails fast (backoff cannot heal a bad config);
    ``on_retry`` fires before each re-attempt."""
    last: Optional[Exception] = None
    for attempt in range(config.max_attempts):
        try:
            return await op()
        except ConfigError:
            raise
        except retry_on as e:
            last = e
            if attempt < config.max_attempts - 1:
                delay = config.delay_s(attempt)
                logger.warning("%s failed (attempt %d/%d): %s; retrying in %.2fs",
                               what, attempt + 1, config.max_attempts, e, delay)
                await asyncio.sleep(delay)
                if on_retry is not None:
                    on_retry()
    raise last
