"""Deterministic fault schedules.

Counterpart of ``arkflow_tpu/plugins/fault/schedule.py``. A schedule is a
list of fault specs consulted once per operation (read, write or process
call) of the wrapper that owns it. Triggers:

- ``at: N``       fire at the Nth operation (1-based), ``times`` consecutive
                  operations (default 1)
- ``every: N``    fire on every Nth operation
- ``rate: 0.05``  seeded random firing probability per operation
- ``match: "s"``  fire when the batch payload contains the substring
                  (output and processor faults only)

``times`` bounds the firings (0 = unlimited; 1 by default for ``at``,
unlimited otherwise). ``burst`` (input only) multiplies offered load: each
firing read is delivered ``factor`` times (default 4). The firing state
lives in the spec's own config dict (``_state``), so a one-shot fault fires
once even if the component is built again from the same config. A kind the
JAX package knows and the port does not carry yet raises "not yet ported".
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field
from typing import Any, Iterable, Mapping, Optional

from arkflow_tpu_torch.errors import ConfigError, not_ported
from arkflow_tpu_torch.utils.duration import parse_duration


@dataclass
class FaultSpec:
    kind: str
    at: Optional[int] = None
    every: Optional[int] = None
    rate: float = 0.0
    times: int = 1  # 0 = unlimited
    duration_s: float = 0.0
    factor: int = 4  # burst only: offered-load multiplier per firing read
    match: Optional[bytes] = None
    message: str = ""
    #: firing state, shared with the config dict
    state: dict = field(default_factory=dict)

    @property
    def fired(self) -> int:
        return self.state.get("fired", 0)

    def _mark_fired(self) -> None:
        self.state["fired"] = self.fired + 1


def parse_faults(cfg_list: Any, allowed_kinds: frozenset[str], family: str,
                 unported_kinds: frozenset[str] = frozenset()) -> list[FaultSpec]:
    if cfg_list is None:
        return []
    if not isinstance(cfg_list, list):
        raise ConfigError(f"fault {family}: 'faults' must be a list")
    specs: list[FaultSpec] = []
    for raw in cfg_list:
        if not isinstance(raw, Mapping):
            raise ConfigError(f"fault {family}: each fault must be a mapping")
        kind = raw.get("kind")
        if kind in unported_kinds:
            raise not_ported(f"fault {family} kind {kind!r}")
        if kind not in allowed_kinds:
            raise ConfigError(
                f"fault {family}: unknown kind {kind!r} (allowed: {sorted(allowed_kinds)})")
        at, every = raw.get("at"), raw.get("every")
        rate = float(raw.get("rate", 0.0))
        match = raw.get("match")
        if match is not None and family == "input":
            # input faults are decided before the read: a match could never fire
            raise ConfigError(
                "fault input: 'match' is only supported on output/processor faults")
        if at is None and every is None and rate == 0.0 and match is None:
            raise ConfigError(f"fault {family}: {kind} needs a trigger (at / every / rate / match)")
        if at is not None and (not isinstance(at, int) or at < 1):
            raise ConfigError(f"fault {family}: 'at' must be an int >= 1")
        if every is not None and (not isinstance(every, int) or every < 1):
            raise ConfigError(f"fault {family}: 'every' must be an int >= 1")
        if not (0.0 <= rate <= 1.0):
            raise ConfigError(f"fault {family}: 'rate' must be in [0, 1]")
        times = raw.get("times", 1 if at is not None else 0)
        if not isinstance(times, int) or times < 0:
            raise ConfigError(f"fault {family}: 'times' must be an int >= 0")
        duration = raw.get("duration")
        if kind == "hang" and duration is None:
            duration = "30s"  # long enough to trip any sane watchdog
        factor = raw.get("factor", 4)
        if kind == "burst" and (not isinstance(factor, int) or factor < 2):
            raise ConfigError(f"fault {family}: burst 'factor' must be an int >= 2")
        specs.append(FaultSpec(
            kind=kind, at=at, every=every, rate=rate, times=times, factor=factor,
            duration_s=parse_duration(duration) if duration is not None else 0.0,
            match=match.encode() if isinstance(match, str) else match,
            message=str(raw.get("message", f"chaos: injected {kind}")),
            state=raw.setdefault("_state", {}) if isinstance(raw, dict) else {}))
    return specs


class FaultSchedule:
    """Per-wrapper schedule; one seeded RNG drives every ``rate`` trigger."""

    def __init__(self, specs: Iterable[FaultSpec], seed: int = 0):
        self.specs = list(specs)
        self.seed = seed
        self._rng = random.Random(seed)

    def due(self, op: int, payload: Optional[bytes] = None,
            kinds: Optional[frozenset[str]] = None) -> list[FaultSpec]:
        """Specs (of ``kinds``, None: all) firing at 1-based operation
        ``op``; consumes their budgets."""
        out: list[FaultSpec] = []
        for spec in self.specs:
            if kinds is not None and spec.kind not in kinds:
                continue
            if spec.at is not None:
                trig = op >= spec.at
            elif spec.every is not None:
                trig = op % spec.every == 0
            elif spec.rate > 0.0:
                trig = self._rng.random() < spec.rate
            else:
                trig = spec.match is not None
            if trig and spec.match is not None:
                trig = payload is not None and spec.match in payload
            if not trig or (spec.times and spec.fired >= spec.times):
                continue
            spec._mark_fired()
            out.append(spec)
        return out
