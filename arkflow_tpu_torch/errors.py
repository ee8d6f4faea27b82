"""Error taxonomy of the port (the subset the slice raises).

Mirrors ``arkflow_tpu/errors.py``. Two errors are control flow, not
failures: ``EndOfInput`` (a finite source is exhausted; the stream drains
and shuts down) and ``Disconnection`` (a transient transport loss; the
stream reconnects the input on a capped exponential schedule).
"""

from __future__ import annotations


class ArkError(Exception):
    """Base class for all engine errors."""


class ConfigError(ArkError):
    """Invalid or missing configuration, or a key the port does not carry."""


class ConnectError(ArkError):
    """Failed to establish a connection to an external system."""


class ReadError(ArkError):
    """Failed to read from an input."""


class WriteError(ArkError):
    """Failed to write to an output."""


class ProcessError(ArkError):
    """A processor failed on a batch."""


class CodecError(ArkError):
    """Encode/decode failure."""


class EndOfInput(ArkError):
    """Control flow: the input is exhausted; shut the stream down gracefully."""

    def __init__(self, msg: str = "end of input"):
        super().__init__(msg)


class Disconnection(ArkError):
    """Control flow: transient disconnect; the runtime retries the connection."""

    def __init__(self, msg: str = "disconnected"):
        super().__init__(msg)


class Overloaded(ArkError):
    """The engine is shedding load: admission rejected the batch or request
    before the worker queue (the deadline cannot be met, the queue window is
    full, the priority band is browned out, or a tenant is over its quota).
    Carries the drain estimate, so a transport can tell its client when to
    retry (HTTP 429 ``Retry-After``)."""

    def __init__(self, msg: str = "overloaded", retry_after_s: float = 1.0):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class StepDeadlineExceeded(ArkError):
    """A device step missed its ``step_deadline``: the runner treats the
    device as hung (UNHEALTHY), abandons the step, and the stream nacks the
    batch so a redelivering source delivers it again."""


class RunnerDead(ArkError):
    """A runner is DEAD (its recovery probes ran out) or quarantined
    (CORRUPT); it serves no batch."""


class SwapError(ArkError):
    """A hot swap (``tpu/swap.py``) was rejected or rolled back; the prior
    weights served throughout."""


class TunerError(ArkError):
    """A runtime shape retune (``tpu/tuner.py``) failed its warm or was
    rolled back at its probe: every flipped unit re-adopted the incumbent
    bucket grid. Like ``SwapError``, it never implies an interruption of
    traffic, and no coalescer was touched."""


class UnsupportedSql(ArkError):
    """Raised by the native SQL planner when a query needs the fallback engine."""


def not_ported(what: str) -> ConfigError:
    """The error every config key the port does not carry yet raises."""
    return ConfigError(f"{what} is not yet ported to arkflow_tpu_torch")
