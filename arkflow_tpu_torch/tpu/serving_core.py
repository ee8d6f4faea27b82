"""The serving core: health, step deadlines, rebuilds and chaos of one runner.

Counterpart of ``arkflow_tpu/tpu/serving_core.py``. ``ServingRunnerCore`` is
the self-healing layer a serving runner composes (the batch runner here;
the generation server is written to compose it the same way):

- **health**: a ``RunnerHealth`` and the admission gates (``heal_gate``,
  ``heal_gate_sync``) that fail fast on DEAD or CORRUPT, wait out the probe
  backoff, claim the recovery probe, and run a scheduled rebuild first;
- **deadlines**: ``run_deadlined`` and ``run_deadlined_sync`` run one
  blocking step on a borrowed watchdog thread and abandon it on a miss
  (the wedged thread goes with its discarded executor, never the shared
  default one). A miss counts, marks UNHEALTHY, schedules a rebuild and
  raises ``StepDeadlineExceeded``, so the batch nacks for redelivery. The
  abandoned step (the zombie) runs to its end; the owner's ``on_zombie``
  then releases what it held;
- **dispatch bookkeeping**: ``note_external_failure`` marks a step that a
  dispatcher (the swap manager's probe, the integrity monitor) saw raise;
- **chaos**: ``inject_step_fault`` arms one-shot ``hang`` and ``oom``
  faults consumed at the top of the next step (``apply_chaos``) and the
  persistent ``sdc`` fault that garbles every step's outputs
  (``corrupt_outputs``) until the integrity repair clears it.

Differences from the JAX core:

- the owner's ``rebuild_fn`` replaces its CUDA graphs (``tpu/runner.py``
  ``_rebuild_after_incident``), which captures again and can take a while,
  so the async gate runs it on an executor thread, never on the loop;
- ``is_oom_error`` knows ``torch.cuda.OutOfMemoryError`` by type, and
  cuBLAS's ``CUBLAS_STATUS_ALLOC_FAILED``, besides the message words;
- the plain counters ``deadline_misses`` and ``rebuilds`` are kept beside
  the JAX core's metrics (``arkflow_tpu_step_deadline_misses``,
  ``arkflow_tpu_runner_rebuilds_total``, and the health gauge
  ``arkflow_tpu_runner_health``), which carry the owner's ``labels``;
- ``on_tpu_backend`` has no counterpart: the port's auto paths ask the
  runner's ``torch.device`` instead.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import logging
import re
import threading
import time
from collections import deque
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from arkflow_tpu_torch.errors import ConfigError, RunnerDead, StepDeadlineExceeded
from arkflow_tpu_torch.obs import global_registry
from arkflow_tpu_torch.tpu.health import CORRUPT, DEAD, UNHEALTHY, HealthConfig, RunnerHealth
from arkflow_tpu_torch.utils.duration import parse_duration

logger = logging.getLogger("arkflow_torch.serving_core")

#: a shape key with no graph yet captures before it replays; the watchdog
#: scales the step deadline by this factor unless ``step_deadline_first``
#: pins the budget of such first steps
FIRST_COMPILE_DEADLINE_SCALE = 10.0


class InjectedOom(RuntimeError):
    """Chaos-injected device OOM (``inject_step_fault('oom')``): it walks
    the real degradation path."""

    def __init__(self, msg: str = "CUDA out of memory: chaos: injected device OOM"):
        super().__init__(msg)


#: words of an allocation failure in a message (cuBLAS reports its own as a
#: RuntimeError naming its status)
_OOM_SIGNATURES = ("resource_exhausted", "resource exhausted", "out of memory", "oom",
                   "cublas_status_alloc_failed")


def is_oom_error(e: BaseException) -> bool:
    """Device allocation failure? ``torch.cuda.OutOfMemoryError`` (the
    caching allocator's) by type first, then a word-boundary match on the
    message: a bare substring test would read any message with "boom" in
    it as an OOM."""
    if isinstance(e, (torch.cuda.OutOfMemoryError, InjectedOom, MemoryError)):
        return True
    msg = str(e).lower()
    return any(re.search(rf"\b{re.escape(sig)}\b", msg) for sig in _OOM_SIGNATURES)


def parse_core_config(config: Mapping[str, Any]) -> dict:
    """The self-healing keys of a device processor config
    (``step_deadline``, ``step_deadline_first``, ``health``) as the keyword
    arguments ``ServingRunnerCore`` and the runner take."""
    step_deadline = config.get("step_deadline")
    step_deadline_first = config.get("step_deadline_first")
    return dict(
        step_deadline_s=parse_duration(step_deadline) if step_deadline is not None else None,
        step_deadline_first_s=(parse_duration(step_deadline_first)
                               if step_deadline_first is not None else None),
        health_config=HealthConfig.from_config(config.get("health")),
    )


def _garble(v):
    """One output of an ``sdc`` step: floats negated (every argmax flips),
    integers shifted by one; wrong answers that look healthy."""
    if isinstance(v, torch.Tensor):
        if v.dim() < 1:
            return v
        if v.is_floating_point():
            return -v
        return v + 1 if v.dtype != torch.bool else v
    arr = np.asarray(v)
    if arr.ndim < 1:
        return v
    if np.issubdtype(arr.dtype, np.floating):
        return -arr
    if np.issubdtype(arr.dtype, np.integer):
        return arr + 1
    return v


class ServingRunnerCore:
    """Health, deadline, chaos and rebuild substrate for one serving runner.
    Deadline misses arrive from executor threads and the event loop alike;
    watchdog executors are borrowed under a lock and the rebuild flag is
    double-checked."""

    def __init__(self, *, name: str, labels: Optional[dict] = None,
                 step_deadline_s: Optional[float] = None,
                 step_deadline_first_s: Optional[float] = None,
                 health_config: Optional[HealthConfig] = None,
                 rebuild_fn: Optional[Callable[[], None]] = None):
        if step_deadline_s is not None and step_deadline_s <= 0:
            raise ConfigError(f"step_deadline must be positive, got {step_deadline_s}")
        if step_deadline_first_s is not None and step_deadline_first_s <= 0:
            raise ConfigError(
                f"step_deadline_first must be positive, got {step_deadline_first_s}")
        self.name = name
        self.step_deadline_s = step_deadline_s
        #: a first step of a shape key captures its graph (and, without
        #: warmup, may build a kernel) before it replays: its own budget, so
        #: a cold key is not misread as a hung device
        self.step_deadline_first_s = (
            step_deadline_first_s if step_deadline_first_s is not None
            else (step_deadline_s * FIRST_COMPILE_DEADLINE_SCALE
                  if step_deadline_s is not None else None))
        self.rebuild_fn = rebuild_fn
        reg = global_registry()
        self.health = RunnerHealth(
            health_config, name=name,
            gauge=reg.gauge("arkflow_tpu_runner_health",
                            "runner health state (0 healthy, 1 degraded, 2 unhealthy, 3 dead)",
                            labels))
        self.m_deadline_miss = reg.counter(
            "arkflow_tpu_step_deadline_misses",
            "device steps abandoned after exceeding step_deadline", labels)
        self.m_rebuilds = reg.counter(
            "arkflow_tpu_runner_rebuilds_total",
            "jitted-step rebuilds after a deadline miss", labels)
        #: steps abandoned after exceeding their deadline
        self.deadline_misses = 0
        #: rebuilds after a deadline miss
        self.rebuilds = 0
        #: abandoned steps that have not ended yet
        self.zombies = 0
        self._count_lock = threading.Lock()
        #: one-shot chaos faults the next steps consume
        self._chaos: deque = deque()
        #: persistent silent data corruption, until the integrity repair
        self.sdc_armed = False
        self._needs_rebuild = False
        self._rebuild_lock = threading.Lock()
        #: recycled single-thread watchdog executors, never the shared
        #: default executor: a miss discards one with its wedged thread
        self._watchdog_free: list[concurrent.futures.ThreadPoolExecutor] = []
        self._watchdog_lock = threading.Lock()

    # -- chaos -------------------------------------------------------------

    def inject_step_fault(self, kind: str, duration_s: float = 0.0) -> None:
        """Arm a fault on the step path: ``hang`` wedges the next step for
        ``duration_s`` (30 s when 0) so the watchdog fires; ``oom`` raises
        an ``InjectedOom`` in the next step; ``sdc`` garbles every step's
        outputs until ``clear_sdc``. ``bitflip`` changes the param tree,
        which the core does not hold: runners take it before delegating."""
        if kind == "sdc":
            self.sdc_armed = True
            return
        if kind not in ("hang", "oom"):
            raise ConfigError(f"unknown step fault kind {kind!r} (hang/oom/sdc)")
        self._chaos.append((kind, float(duration_s)))

    def apply_chaos(self) -> None:
        """Step-thread side of ``inject_step_fault``: runs at the top of a
        step, before any lock of the step is taken."""
        try:
            kind, duration_s = self._chaos.popleft()
        except IndexError:
            return
        if kind == "hang":
            time.sleep(duration_s if duration_s > 0 else 30.0)
        else:
            raise InjectedOom()

    def corrupt_outputs(self, out):
        """The armed ``sdc`` fault applied to a step's outputs (numpy arrays
        or tensors, in a dict); identity when no fault is armed."""
        if not self.sdc_armed:
            return out
        return {k: _garble(v) for k, v in out.items()}

    def clear_sdc(self) -> None:
        """Integrity repair side: the corrupting device was replaced."""
        self.sdc_armed = False

    # -- deadlines ---------------------------------------------------------

    def deadline_for(self, first: bool) -> Optional[float]:
        """The watchdog budget of one step: ``first`` (the key has no graph
        yet) takes the first-step budget."""
        if self.step_deadline_s is None:
            return None
        return self.step_deadline_first_s if first else self.step_deadline_s

    @staticmethod
    def deadline_remaining(deadline_s: float, dispatched_at: float, *,
                           floor: float = 0.05) -> float:
        """Budget left for a step already enqueued (``dispatch_depth`` > 1):
        its deadline runs from its own enqueue, floored so host jitter
        cannot turn an on-time step into a zero-budget miss."""
        return max(deadline_s - (time.monotonic() - dispatched_at), floor)

    def _borrow_watchdog(self) -> concurrent.futures.ThreadPoolExecutor:
        with self._watchdog_lock:
            if self._watchdog_free:
                return self._watchdog_free.pop()
        return concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="arkflow-step-watchdog")

    def _return_watchdog(self, ex) -> None:
        with self._watchdog_lock:
            self._watchdog_free.append(ex)

    def _deadline_miss(self, fut, deadline: float,
                       on_zombie: Optional[Callable[[], None]]) -> StepDeadlineExceeded:
        """An abandoned step: count the miss, schedule a rebuild, mark the
        runner UNHEALTHY, and have the zombie's end retrieve its result and
        run ``on_zombie``."""
        with self._count_lock:
            self.deadline_misses += 1
            self.zombies += 1
        self.m_deadline_miss.inc()
        self.schedule_rebuild()
        self.health.mark_unhealthy(f"step exceeded its {deadline:.3g}s deadline")

        def reap(f) -> None:
            try:
                f.exception()
            except BaseException:
                pass
            if on_zombie is not None:
                on_zombie()
            with self._count_lock:
                self.zombies -= 1

        fut.add_done_callback(reap)
        return StepDeadlineExceeded(
            f"device step exceeded its {deadline:.3g}s deadline "
            "(runner marked unhealthy; batch nacked for redelivery)")

    def run_deadlined_sync(self, fn: Callable[[], Any], deadline: float,
                           on_zombie: Optional[Callable[[], None]] = None):
        """Run ``fn`` on a watchdog thread and wait at most ``deadline``."""
        ex = self._borrow_watchdog()
        fut = ex.submit(fn)
        try:
            out = fut.result(timeout=deadline)
        except concurrent.futures.TimeoutError:
            ex.shutdown(wait=False)  # abandon: the wedged thread goes with it
            raise self._deadline_miss(fut, deadline, on_zombie) from None
        except BaseException:
            self._return_watchdog(ex)
            raise
        self._return_watchdog(ex)
        return out

    async def run_deadlined(self, fn: Callable[[], Any], deadline: float,
                            on_zombie: Optional[Callable[[], None]] = None):
        """Async twin of ``run_deadlined_sync``: the loop waits, not a thread."""
        ex = self._borrow_watchdog()
        cfut = ex.submit(fn)
        fut = asyncio.wrap_future(cfut)
        done, _ = await asyncio.wait({fut}, timeout=deadline)
        if not done:
            ex.shutdown(wait=False)
            fut.cancel()  # the zombie's end is reaped on ``cfut``, not here
            raise self._deadline_miss(cfut, deadline, on_zombie)
        self._return_watchdog(ex)
        return fut.result()

    # -- rebuilds ----------------------------------------------------------

    def schedule_rebuild(self) -> None:
        self._needs_rebuild = True

    def rebuild_if_needed(self) -> None:
        """Run the owner's rebuild after a deadline miss: graphs replayed
        across a device hang are not trusted, so the probe step runs on new
        ones. Double-checked so concurrent probes rebuild once."""
        if not self._needs_rebuild or self.rebuild_fn is None:
            return
        with self._rebuild_lock:
            if not self._needs_rebuild:
                return
            self._needs_rebuild = False
            try:
                self.rebuild_fn()
            except StepDeadlineExceeded:
                raise  # the miss marked the runner and scheduled a rebuild
            except BaseException as e:
                self._needs_rebuild = True
                self.health.mark_unhealthy(f"rebuild failed: {e}")
                raise
        with self._count_lock:
            self.rebuilds += 1
        self.m_rebuilds.inc()

    # -- admission gates ---------------------------------------------------

    def _admit(self) -> Optional[bool]:
        """None while the caller must wait; else whether it holds the probe."""
        h = self.health
        if h.state == DEAD:
            raise RunnerDead(f"runner {h.name} is DEAD; not serving")
        if h.state == CORRUPT:
            raise RunnerDead(f"runner {h.name} is quarantined (CORRUPT) pending "
                             "integrity repair; not serving")
        suspect = h.state == UNHEALTHY
        return suspect if h.join_or_begin_probe() else None

    def heal_gate_sync(self) -> bool:
        """Admission for the runner's own callers: DEAD and CORRUPT raise;
        UNHEALTHY waits out the backoff, claims the probe and rebuilds if
        needed (the step that follows is the recovery probe). Returns
        whether this caller holds the probe: if its step fails otherwise
        than by a deadline miss, it ends the probe with ``end_failed_probe``."""
        while (probing := self._admit()) is None:
            time.sleep(min(max(self.health.seconds_until_probe(), 0.01), 0.5))
        self.rebuild_if_needed()
        return probing

    async def heal_gate(self) -> bool:
        """Async twin of ``heal_gate_sync``; the rebuild runs on an executor
        thread."""
        while (probing := self._admit()) is None:
            await asyncio.sleep(min(max(self.health.seconds_until_probe(), 0.01), 0.5))
        if self._needs_rebuild:
            await asyncio.get_running_loop().run_in_executor(None, self.rebuild_if_needed)
        return probing

    def end_failed_probe(self, e: BaseException) -> None:
        """The probe step of this caller raised: unless the failure marked
        the runner itself (a deadline miss, an OOM at the smallest bucket),
        mark it here, which releases the claim and re-arms the backoff. The
        JAX runner leaves the claim held, and the runner then waits for a
        probe that never ends."""
        if self.health.probing:
            self.health.mark_unhealthy(f"probe step failed: {e}")

    # -- dispatcher-side bookkeeping ---------------------------------------

    def note_external_failure(self, e: Exception) -> None:
        """Health marking a dispatcher applies to a step that raised.
        Deadline misses and OOMs marked themselves inside the step; any
        other failure marks here, which also releases a probe claim."""
        if isinstance(e, (StepDeadlineExceeded, RunnerDead)) or is_oom_error(e):
            return
        self.health.mark_unhealthy(f"step failed: {e}")

    # -- /health -----------------------------------------------------------

    def health_report(self) -> dict:
        rep = self.health.report()
        rep["deadline_misses"] = self.deadline_misses
        rep["rebuilds"] = self.rebuilds
        rep["zombies"] = self.zombies
        if self.sdc_armed:
            rep["sdc_armed"] = True
        return rep
