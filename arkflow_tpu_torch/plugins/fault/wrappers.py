"""Fault-injecting component wrappers (``type: fault``).

Counterpart of ``arkflow_tpu/plugins/fault/wrappers.py`` for the kinds the
lifecycle slice needs:

    input:
      type: fault
      seed: 7
      redeliver_unacked: true      # act as an in-process broker: a nacked
                                   # batch is delivered again, and EOF waits
                                   # for the deliveries in flight
      inner: {type: generate, ...}
      faults:
        - {kind: latency, every: 3, duration: 5ms}

    processors:
      - type: fault
        inner: {type: gpu_inference, ...}  # or gpu_generate
        faults:
          - {kind: hang, at: 5, duration: 3s}  # wedge the runner's next step
          - {kind: oom, at: 9}                 # the next step runs out of memory
          - {kind: bitflip, at: 7}             # garble one live param leaf
          - {kind: sdc, at: 9}                 # garble every step's outputs
          - {kind: swap_corrupt, at: 6}        # the next swap restores garbage
          - {kind: swap_crash, at: 8}          # the next swap crashes mid-flip
          - {kind: error, match: poison}       # raise on a poison batch

The step kinds are armed on the inner processor's ``runner`` (a
``gpu_generate`` processor's is its generation server, which refuses
``sdc``: it picks tokens on the device) and the swap kinds on its
``swapper``, reached through ``_inner`` as in the JAX package.
The wrapper exposes that ``runner``, ``swapper`` and ``integrity`` as its
own, so the engine's ``/health`` and ``/admin/swap`` see them through any
depth of wrapping.
Every other kind (``disconnect``, ``crash``, ``ack_fail``, ``burst``, the
``net_*`` kinds, ...) and the output wrapper raise "not yet ported".
"""

from __future__ import annotations

import asyncio
from collections import deque
from typing import Optional

from arkflow_tpu_torch.batch import MessageBatch
from arkflow_tpu_torch.components import (
    Ack,
    Input,
    Processor,
    Resource,
    register_input,
    register_output,
    register_processor,
)
from arkflow_tpu_torch.components.registry import build_component, check_component
from arkflow_tpu_torch.errors import ConfigError, EndOfInput, ProcessError, not_ported
from arkflow_tpu_torch.plugins.fault.schedule import FaultSchedule, parse_faults

INPUT_KINDS = frozenset({"latency"})
PROCESSOR_KINDS = frozenset(
    {"error", "hang", "oom", "bitflip", "sdc", "swap_corrupt", "swap_crash"})
#: the JAX package's kinds the port does not carry yet
UNPORTED_INPUT_KINDS = frozenset(
    {"disconnect", "error", "crash", "ack_fail", "ack_dup", "reconnect_fail", "burst"})
UNPORTED_PROCESSOR_KINDS = frozenset(
    {"latency", "crash", "net_delay", "net_stall", "net_blackhole", "net_reset",
     "net_corrupt"})
#: armed on the inner processor's runner: the fault fires inside its next step
_STEP_KINDS = frozenset({"hang", "oom", "bitflip", "sdc"})
_SDC_KINDS = frozenset({"bitflip", "sdc"})
#: armed on the inner processor's swapper, consumed by its next swap
_SWAP_KINDS = frozenset({"swap_corrupt", "swap_crash"})


class _TrackingAck(Ack):
    """A delivery of the redelivering input: a nack puts the batch back in
    the input's queue; either way the delivery is settled."""

    #: the stream nacks a failed batch for redelivery only through such acks
    redeliverable = True

    def __init__(self, owner: "FaultInjectingInput", batch: MessageBatch, inner: Ack):
        self._owner = owner
        self._batch = batch
        self._inner = inner
        self._settled = False

    def _settle(self) -> None:
        if not self._settled:
            self._settled = True
            self._owner._on_settled()

    async def ack(self) -> None:
        await self._inner.ack()
        self._settle()

    async def nack(self) -> None:
        if not self._settled:
            self._owner._requeued.append((self._batch, self._inner))
        self._settle()


class FaultInjectingInput(Input):
    def __init__(self, inner: Input, schedule: FaultSchedule, redeliver_unacked: bool = False):
        self._inner = inner
        self._sched = schedule
        self.redeliver_unacked = redeliver_unacked
        self._reads = 0
        self._inner_eof = False
        self._outstanding = 0
        self._requeued: deque[tuple[MessageBatch, Ack]] = deque()
        self._settled_ev = asyncio.Event()
        #: deliveries handed out again after a nack
        self.redeliveries = 0

    def _on_settled(self) -> None:
        self._outstanding -= 1
        self._settled_ev.set()

    async def connect(self) -> None:
        await self._inner.connect()

    async def read(self) -> tuple[MessageBatch, Ack]:
        while True:
            if self._requeued:
                batch, inner_ack = self._requeued.popleft()
                self.redeliveries += 1
                return self._hand_out(batch, inner_ack)
            if self._inner_eof:
                if not self.redeliver_unacked or self._outstanding == 0:
                    raise EndOfInput()
                # deliveries in flight may still nack: EOF once all settled
                self._settled_ev.clear()
                if self._outstanding > 0 and not self._requeued:
                    await self._settled_ev.wait()
                continue
            self._reads += 1
            for spec in self._sched.due(self._reads):
                await asyncio.sleep(spec.duration_s)  # latency, the one input kind
            try:
                batch, ack = await self._inner.read()
            except EndOfInput:
                self._inner_eof = True
                continue
            return self._hand_out(batch, ack)

    def _hand_out(self, batch: MessageBatch, inner_ack: Ack) -> tuple[MessageBatch, Ack]:
        if not self.redeliver_unacked:
            return batch, inner_ack
        self._outstanding += 1
        return batch, _TrackingAck(self, batch, inner_ack)

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
        payload = b"\n".join(batch.to_binary()) if self._needs_payload else None
        for spec in self._sched.due(self._calls, payload=payload):
            if spec.kind in _STEP_KINDS:
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
    parse_faults(config.get("faults"), INPUT_KINDS, "input", UNPORTED_INPUT_KINDS)
    if not config.get("inner"):
        raise ConfigError("fault input requires an 'inner' input config")
    check_component("input", config["inner"])


def _check_processor(config: dict) -> None:
    parse_faults(config.get("faults"), PROCESSOR_KINDS, "processor", UNPORTED_PROCESSOR_KINDS)
    if config.get("inner"):
        check_component("processor", config["inner"])


def _check_output(config: dict) -> None:
    raise not_ported("the fault output")


def _schedule(config: dict, allowed: frozenset[str], family: str,
              unported: frozenset[str]) -> FaultSchedule:
    return FaultSchedule(parse_faults(config.get("faults"), allowed, family, unported),
                         seed=int(config.get("seed", 0)))


@register_input("fault", keys=("inner", "faults", "seed", "redeliver_unacked"),
                check=_check_input)
def _build_input(config: dict, resource: Resource) -> FaultInjectingInput:
    return FaultInjectingInput(
        build_component("input", config["inner"], resource),
        _schedule(config, INPUT_KINDS, "input", UNPORTED_INPUT_KINDS),
        redeliver_unacked=bool(config.get("redeliver_unacked", False)))


@register_processor("fault", keys=("inner", "faults", "seed"), check=_check_processor)
def _build_processor(config: dict, resource: Resource) -> FaultInjectingProcessor:
    inner_cfg = config.get("inner")
    inner = build_component("processor", inner_cfg, resource) if inner_cfg else None
    return FaultInjectingProcessor(
        inner, _schedule(config, PROCESSOR_KINDS, "processor", UNPORTED_PROCESSOR_KINDS))


@register_output("fault", keys=("inner", "faults", "seed"), check=_check_output)
def _build_output(config: dict, resource: Resource):
    raise not_ported("the fault output")
