"""Fault-injecting component wrappers (``type: fault``).

Counterpart of ``arkflow_tpu/plugins/fault/wrappers.py``:

    input:
      type: fault
      seed: 7
      redeliver_unacked: true      # act as an in-process broker: a nacked or
                                   # ack-failed batch is delivered again, and
                                   # EOF waits for the deliveries in flight
      inner: {type: memory, messages: [...]}
      faults:
        - {kind: disconnect, at: 4}           # read #4 raises Disconnection
        - {kind: reconnect_fail, at: 1}       # the first reconnect probe fails
        - {kind: latency, every: 3, duration: 5ms}
        - {kind: error, at: 6}                # read #6 raises ReadError
        - {kind: ack_fail, at: 2}             # that read's ack raises once
        - {kind: ack_dup, at: 5}              # that read's ack fires twice
        - {kind: crash, at: 9}                # a plain RuntimeError
        - {kind: burst, every: 1, times: 0, factor: 4}  # each read delivered
                                              # 4 times (3 duplicates)

    output:
      type: fault
      inner: {type: drop}
      faults:
        - {kind: error, at: 2, times: 3}      # 3 consecutive writes fail
        - {kind: error, match: poison}        # every write of a poison batch
        - {kind: latency, rate: 0.1, duration: 10ms}

    processors:
      - type: fault
        inner: {type: gpu_inference, ...}  # or gpu_generate; identity if absent
        faults:
          - {kind: hang, at: 5, duration: 3s}  # wedge the runner's next step
          - {kind: oom, at: 9}                 # the next step runs out of memory
          - {kind: bitflip, at: 7}             # garble one live param leaf
          - {kind: sdc, at: 9}                 # garble every step's outputs
          - {kind: swap_corrupt, at: 6}        # the next swap restores garbage
          - {kind: swap_crash, at: 8}          # the next swap crashes mid-flip
          - {kind: error, match: poison}       # raise on a poison batch
          - {kind: latency, every: 2, duration: 5ms}
          - {kind: crash, at: 3}               # a plain RuntimeError

The step kinds are armed on the inner processor's ``runner`` (a
``gpu_generate`` processor's is its generation server, which refuses
``sdc``: it picks tokens on the device) and the swap kinds on its
``swapper``, reached through ``_inner`` as in the JAX package.
The wrapper exposes that ``runner``, ``swapper`` and ``integrity`` as its
own, so the engine's ``/health`` and ``/admin/swap`` see them through any
depth of wrapping. Crash faults raise a plain ``RuntimeError`` (not an
``ArkError``), so they escape the stream's contained error paths; their
firing state lives in the config dict. The ``net_*`` processor kinds raise
"not yet ported" (they need the cluster dispatcher).

An input fault's first ``connect`` connects the inner input; later ones are
reconnect probes after a ``Disconnection`` and leave the inner input as it
is (a broker keeps its log). Ack faults ride a ``_TrackingAck``: a failed
ack requeues the batch when the wrapper is the broker
(``redeliver_unacked``), then raises.
"""

from __future__ import annotations

import asyncio
from collections import deque
from typing import Optional

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import (
    Ack,
    Input,
    NoopAck,
    Output,
    Processor,
    Resource,
    register_input,
    register_output,
    register_processor,
)
from arkflow_tpu_torch.components.registry import build_component, check_component
from arkflow_tpu_torch.errors import (
    ArkError,
    ConfigError,
    ConnectError,
    Disconnection,
    EndOfInput,
    ProcessError,
    ReadError,
    WriteError,
)
from arkflow_tpu_torch.plugins.fault.schedule import FaultSchedule, FaultSpec, parse_faults

INPUT_KINDS = frozenset(
    {"latency", "disconnect", "error", "crash", "ack_fail", "ack_dup",
     "reconnect_fail", "burst"})
OUTPUT_KINDS = frozenset({"latency", "error", "crash"})
PROCESSOR_KINDS = frozenset(
    {"latency", "error", "crash", "hang", "oom", "bitflip", "sdc", "swap_corrupt",
     "swap_crash"})
#: the JAX package's kinds the port does not carry yet
UNPORTED_PROCESSOR_KINDS = frozenset(
    {"net_delay", "net_stall", "net_blackhole", "net_reset", "net_corrupt"})
#: armed on the inner processor's runner: the fault fires inside its next step
_STEP_KINDS = frozenset({"hang", "oom", "bitflip", "sdc"})
_SDC_KINDS = frozenset({"bitflip", "sdc"})
#: armed on the inner processor's swapper, consumed by its next swap
_SWAP_KINDS = frozenset({"swap_corrupt", "swap_crash"})
_ACK_KINDS = frozenset({"ack_fail", "ack_dup"})
#: kinds counted on read operations; ``reconnect_fail`` runs on its own
#: reconnect counter, so reads never spend its budget
_READ_KINDS = INPUT_KINDS - {"reconnect_fail"}


def _batch_bytes(batch: MessageBatch) -> bytes:
    """Payload bytes that ``match`` triggers look into."""
    try:
        return b"\n".join(batch.to_binary())
    except ArkError:
        return repr(batch.to_pydict()).encode()


class _TrackingAck(Ack):
    """A delivery of the fault input: applies its ack faults and reports
    its settlement (acked, failed or nacked) to the input, which redelivers
    a nacked or ack-failed batch when it is the broker."""

    def __init__(self, owner: "FaultInjectingInput", batch: MessageBatch, inner: Ack,
                 fail_times: int = 0, dup: bool = False, tracked: bool = False):
        self._owner = owner
        self._batch = batch
        self._inner = inner
        self._fail_times = fail_times
        self._dup = dup
        self._tracked = tracked
        #: the stream nacks a failed batch for redelivery only through acks
        #: whose source redelivers in this session
        self.redeliverable = owner.redeliver_unacked
        self._settled = False

    def _settle(self) -> None:
        if not self._settled:
            self._settled = True
            if self._tracked:
                self._owner._on_settled()

    async def ack(self) -> None:
        if self._fail_times > 0:
            self._fail_times -= 1
            # a lost ack means the broker redelivers; only a wrapper that is
            # the broker can (else the batch would sit in a deque EOF never
            # drains)
            if self._owner.redeliver_unacked:
                self._owner._requeue(self._batch, self._inner)
            self._settle()
            raise WriteError("chaos: injected ack failure")
        await self._inner.ack()
        if self._dup:
            self._dup = False
            await self._inner.ack()  # a duplicated ack must be harmless
        self._settle()

    async def nack(self) -> None:
        if self._owner.redeliver_unacked:
            if not self._settled:
                self._owner._requeue(self._batch, self._inner)
        else:
            await self._inner.nack()
        self._settle()


class FaultInjectingInput(Input):
    def __init__(self, inner: Input, schedule: FaultSchedule, redeliver_unacked: bool = False):
        self._inner = inner
        self._sched = schedule
        self.redeliver_unacked = redeliver_unacked
        self._connected = False
        self._reads = 0
        #: reconnect probes made (each later ``connect``)
        self._reconnects = 0
        self._inner_eof = False
        #: deliveries handed out and not yet settled (``redeliver_unacked``)
        self._outstanding = 0
        self._requeued: deque[tuple[MessageBatch, Ack]] = deque()
        self._settled_ev = asyncio.Event()
        #: deliveries handed out again from the requeue (after a nack, an
        #: ack failure, or a burst's duplicates)
        self.redeliveries = 0

    def _requeue(self, batch: MessageBatch, inner_ack: Ack) -> None:
        self._requeued.append((batch, inner_ack))

    def _on_settled(self) -> None:
        self._outstanding -= 1
        self._settled_ev.set()

    async def connect(self) -> None:
        if not self._connected:
            await self._inner.connect()
            self._connected = True
            return
        # a reconnect probe after an injected Disconnection: the inner input
        # is not reset (a broker keeps its log)
        self._reconnects += 1
        for spec in self._sched.due(self._reconnects, kinds=frozenset({"reconnect_fail"})):
            raise ConnectError(spec.message)

    async def read(self) -> tuple[MessageBatch, Ack]:
        while True:
            if self._requeued:
                batch, inner_ack = self._requeued.popleft()
                self.redeliveries += 1
                return self._hand_out(batch, inner_ack, ())
            if self._inner_eof:
                if not self.redeliver_unacked or self._outstanding == 0:
                    raise EndOfInput()
                # deliveries in flight may still nack: EOF once all settled
                self._settled_ev.clear()
                if self._outstanding > 0 and not self._requeued:
                    await self._settled_ev.wait()
                continue
            self._reads += 1
            due = self._sched.due(self._reads, kinds=_READ_KINDS)
            # latency, disconnect, error and crash act before the inner read
            # (they replace it, losing no data)
            for spec in due:
                if spec.kind == "latency":
                    await asyncio.sleep(spec.duration_s)
                elif spec.kind == "disconnect":
                    raise Disconnection(spec.message)
                elif spec.kind == "error":
                    raise ReadError(spec.message)
                elif spec.kind == "crash":
                    raise RuntimeError(spec.message)
            try:
                batch, ack = await self._inner.read()
            except EndOfInput:
                self._inner_eof = True
                continue
            for spec in due:
                if spec.kind == "burst":
                    # factor - 1 duplicates ride the requeue behind the real
                    # read; their acks are no-ops (the real one settles once)
                    for _ in range(spec.factor - 1):
                        self._requeue(batch, NoopAck())
            return self._hand_out(batch, ack, tuple(s for s in due if s.kind in _ACK_KINDS))

    def _hand_out(self, batch: MessageBatch, inner_ack: Ack,
                  ack_specs: tuple[FaultSpec, ...]) -> tuple[MessageBatch, Ack]:
        if not self.redeliver_unacked and not ack_specs:
            return batch, inner_ack
        if self.redeliver_unacked:
            self._outstanding += 1
        fail_times = sum(1 for s in ack_specs if s.kind == "ack_fail")
        dup = any(s.kind == "ack_dup" for s in ack_specs)
        return batch, _TrackingAck(self, batch, inner_ack, fail_times, dup,
                                   tracked=self.redeliver_unacked)

    async def close(self) -> None:
        await self._inner.close()


class FaultInjectingOutput(Output):
    def __init__(self, inner: Output, schedule: FaultSchedule):
        self._inner = inner
        self._sched = schedule
        self._writes = 0
        # match triggers need the payload; skip building it otherwise
        self._needs_payload = any(s.match is not None for s in schedule.specs)

    async def connect(self) -> None:
        await self._inner.connect()

    async def write(self, batch: MessageBatch) -> None:
        self._writes += 1
        payload = _batch_bytes(batch) if self._needs_payload else None
        for spec in self._sched.due(self._writes, payload=payload):
            if spec.kind == "latency":
                await asyncio.sleep(spec.duration_s)
            elif spec.kind == "error":
                raise WriteError(spec.message)
            elif spec.kind == "crash":
                raise RuntimeError(spec.message)
        await self._inner.write(batch)

    async def close(self) -> None:
        await self._inner.close()


class FaultInjectingProcessor(Processor):
    def __init__(self, inner: Optional[Processor], schedule: FaultSchedule):
        self._inner = inner
        self._sched = schedule
        self._calls = 0
        self._needs_payload = any(s.match is not None for s in schedule.specs)

    async def connect(self) -> None:
        if self._inner is not None:
            await self._inner.connect()

    @property
    def runner(self):
        """The inner processor's runner: chaos wrapping must not hide its
        health from the engine's ``/health``."""
        return getattr(self._inner, "runner", None)

    @property
    def swapper(self):
        """The inner processor's hot-swap manager."""
        return getattr(self._inner, "swapper", None)

    @property
    def integrity(self):
        """The inner processor's integrity monitor."""
        return getattr(self._inner, "integrity", None)

    async def process(self, batch: MessageBatch) -> list[MessageBatch]:
        self._calls += 1
        payload = _batch_bytes(batch) if self._needs_payload else None
        for spec in self._sched.due(self._calls, payload=payload):
            if spec.kind == "latency":
                await asyncio.sleep(spec.duration_s)
            elif spec.kind == "crash":
                raise RuntimeError(spec.message)
            elif spec.kind in _STEP_KINDS:
                await self._apply_step_fault(spec)
            elif spec.kind in _SWAP_KINDS:
                inject = getattr(self.swapper, "inject_swap_fault", None)
                if inject is None:
                    raise ProcessError(f"chaos: {spec.kind} requires a hot-swappable inner "
                                       "processor (gpu_inference, gpu_generate)")
                inject(spec.kind)
            else:  # error
                raise ProcessError(spec.message)
        if self._inner is None:
            return [batch]
        return await self._inner.process(batch)

    async def _apply_step_fault(self, spec) -> None:
        """Arm a step fault on the inner processor's runner, so it fires in
        its next step; without a runner a hang stalls here and an oom
        raises, and the corruption kinds refuse (they must corrupt real
        device state)."""
        inject = getattr(self.runner, "inject_step_fault", None)
        if inject is not None:
            inject(spec.kind, spec.duration_s)
            return
        if spec.kind in _SDC_KINDS:
            raise ProcessError(f"chaos: {spec.kind} requires an inner processor with a "
                               "device runner (gpu_inference, gpu_generate)")
        if spec.kind == "hang":
            await asyncio.sleep(spec.duration_s if spec.duration_s > 0 else 30.0)
        else:
            raise ProcessError(f"out of memory: {spec.message}")

    async def close(self) -> None:
        if self._inner is not None:
            await self._inner.close()


# -- builders -----------------------------------------------------------------


def _check_input(config: dict) -> None:
    parse_faults(config.get("faults"), INPUT_KINDS, "input")
    if not config.get("inner"):
        raise ConfigError("fault input requires an 'inner' input config")
    check_component("input", config["inner"])


def _check_processor(config: dict) -> None:
    parse_faults(config.get("faults"), PROCESSOR_KINDS, "processor", UNPORTED_PROCESSOR_KINDS)
    if config.get("inner"):
        check_component("processor", config["inner"])


def _check_output(config: dict) -> None:
    parse_faults(config.get("faults"), OUTPUT_KINDS, "output")
    if not config.get("inner"):
        raise ConfigError("fault output requires an 'inner' output config")
    check_component("output", config["inner"])


def _schedule(config: dict, allowed: frozenset[str], family: str,
              unported: frozenset[str] = frozenset()) -> FaultSchedule:
    return FaultSchedule(parse_faults(config.get("faults"), allowed, family, unported),
                         seed=int(config.get("seed", 0)))


@register_input("fault", keys=("inner", "faults", "seed", "redeliver_unacked"),
                check=_check_input)
def _build_input(config: dict, resource: Resource) -> FaultInjectingInput:
    return FaultInjectingInput(
        build_component("input", config["inner"], resource),
        _schedule(config, INPUT_KINDS, "input"),
        redeliver_unacked=bool(config.get("redeliver_unacked", False)))


@register_processor("fault", keys=("inner", "faults", "seed"), check=_check_processor)
def _build_processor(config: dict, resource: Resource) -> FaultInjectingProcessor:
    inner_cfg = config.get("inner")
    inner = build_component("processor", inner_cfg, resource) if inner_cfg else None
    return FaultInjectingProcessor(
        inner, _schedule(config, PROCESSOR_KINDS, "processor", UNPORTED_PROCESSOR_KINDS))


@register_output("fault", keys=("inner", "faults", "seed"), check=_check_output)
def _build_output(config: dict, resource: Resource) -> FaultInjectingOutput:
    return FaultInjectingOutput(build_component("output", config["inner"], resource),
                                _schedule(config, OUTPUT_KINDS, "output"))
