"""Humantime-style duration parsing.

Counterpart of ``arkflow_tpu/utils/duration.py``: config durations accept
``"10ms"``, ``"5s"``, ``"1m 30s"``, ``"2h"`` and bare numbers (seconds).
"""

from __future__ import annotations

import math
import re

from arkflow_tpu_torch.errors import ConfigError

_UNITS = {
    "ns": 1e-9,
    "us": 1e-6,
    "µs": 1e-6,
    "ms": 1e-3,
    "s": 1.0,
    "sec": 1.0,
    "secs": 1.0,
    "second": 1.0,
    "seconds": 1.0,
    "m": 60.0,
    "min": 60.0,
    "mins": 60.0,
    "minute": 60.0,
    "minutes": 60.0,
    "h": 3600.0,
    "hr": 3600.0,
    "hour": 3600.0,
    "hours": 3600.0,
    "d": 86400.0,
    "day": 86400.0,
    "days": 86400.0,
}

_PART = re.compile(r"(\d+(?:\.\d+)?)\s*([a-zµ]+)")


def parse_duration(value: object) -> float:
    """Parse a config duration into seconds (float)."""
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        if value < 0 or not math.isfinite(value):
            raise ConfigError(f"non-finite or negative duration: {value}")
        return float(value)
    if not isinstance(value, str):
        raise ConfigError(f"cannot parse duration from {type(value).__name__}: {value!r}")
    s = value.strip().lower()
    if not s:
        raise ConfigError("empty duration")
    try:
        return parse_duration(float(s))
    except (ValueError, ConfigError):
        pass
    total = 0.0
    pos = 0
    matched = False
    for m in _PART.finditer(s):
        if s[pos:m.start()].strip():
            raise ConfigError(f"invalid duration {value!r}")
        num, unit = m.groups()
        if unit not in _UNITS:
            raise ConfigError(f"unknown duration unit {unit!r} in {value!r}")
        total += float(num) * _UNITS[unit]
        pos = m.end()
        matched = True
    if not matched or s[pos:].strip():
        raise ConfigError(f"invalid duration {value!r}")
    return total
