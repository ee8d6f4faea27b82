"""The compiled step: one CUDA graph per warmed shape key.

Counterpart of what ``jax.jit`` gives the JAX runner and generation server
(``arkflow_tpu/tpu/runner.py`` ``_build_jitted``, ``tpu/serving.py``'s
jitted decode, prefill and chunk): an executable per input shape, built at
the first step of that shape and kept warm. Here it is a
``torch.cuda.CUDAGraph`` per shape key, replayed over static input and
output buffers, so a step costs one graph launch of host work instead of
one launch per op.

``CompiledStep.run(key, fn, inputs, out)`` copies ``inputs`` into the key's
static inputs, replays the key's graph (or, at the key's first step,
captures it), copies the static outputs into the host buffers ``out`` and
records an event after that copy. A lock covers copy-in -> replay -> the
enqueue of the copy-out, so steps of several executor threads never cross
static buffers.

Capture, at the first step of a key:

- one eager call of ``fn`` on the capture stream, which every
  ``CompiledStep`` of the device shares (captures of different objects take
  turns on it). It is that step's real work, and its outputs are the
  step's outputs; it also loads the kernel libraries, makes the tile's
  per-device shared-memory grant (``csrc/mma_tile.cuh``) and creates the
  cuBLAS handle and workspace of that stream before the capture needs
  them. cuBLAS keeps a workspace per (handle, stream) for the life of the
  process, so the shared stream keeps them bounded by the threads that
  capture, not by the runners ever built;
- then ``torch.cuda.graph(..., capture_error_mode="thread_local")``: other
  executor threads may pin memory or wait on events meanwhile, which the
  default global mode would count against the capture. Automatic garbage
  collection is off while it runs: a collection in the capturing thread
  could destroy another object's graph, which invalidates the capture.

The graphs of one ``CompiledStep`` share one memory pool. That is safe
because every step is issued on the one stream of the device in the order
the callers take the lock, and every static output is copied out (or, for
the generation server's device-resident next tokens, copied into the next
step's static input) before the next replay is enqueued: no graph's
intermediates can overwrite another graph's outputs that are still to be
read. A capture between live replays (the shape tuner's warm, ``warm=True``;
a key's first traffic step) keeps it so: it holds the lock, its eager call
runs on the capture stream after everything enqueued before it and before
everything enqueued after it, the capture itself runs nothing, and its
static outputs, like every graph's, stay allocated for as long as the
graph, so no other graph's intermediates ever take their blocks. The
copy stream's prefetches allocate outside the pool. ``release`` drops a
graph only after a device synchronisation, with no replay or copy-out of
it outstanding, and the graph never replays again: its blocks go back to
the pool's free list, where later captures take them.

Launch counts: a kernel wrapper ticks its ``LaunchCounter`` when the step
is captured, and the kernel does not run then. The capture's ticks are
tallied apart (``capturing``) instead of counted, kept with the graph, and
added again at every replay, so a count still equals the launches that ran.

On a CPU device (tests) and with ``eager=True`` (the A/B comparisons of
``chip_smoke.py`` and ``profile_step``) the same object calls ``fn`` on
the same static buffers at every step, without capture. On CUDA a capture
or replay error raises: nothing quietly carries on eagerly.

Three lifecycle primitives (the swap, repair and rebuild of the runner,
``tpu/runner.py``, and of the generation server, ``tpu/serving.py``):

- **A capture that raises is discarded.** The key gets no entry, so no
  half-captured graph is ever replayed, and its next step captures anew.
  The blocks the failed capture allocated go back to the shared pool's free
  list; when no other graph shares the pool, the pool is dropped with the
  graph and its memory returned to the device. An allocator OOM inside
  ``torch.cuda.graph(...)`` leaves as that OOM, even when ending the broken
  capture raises too, so it reaches the runner's OOM path like any other.
- **``copy_params_(live, new)``** copies a new param tree into the live
  tensors in place: the graphs read the addresses they were captured with,
  so a weight change may never rebind a tensor they hold. Shapes, dtypes
  and strides are checked first (a mismatch raises ``ConfigError``; the
  column-major int8 ``w_q`` of ``models/quantize.py`` keeps its strides).
  The copies are enqueued on the step stream under the lock, so every
  replay enqueued before them reads the old weights and every later one
  the new.
- **``zero_(*tensors)``** zeroes state the graphs read by address (the
  generation server's KV pools after a swap) the same way.
"""

from __future__ import annotations

import gc
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import numpy as np
import torch

from arkflow_tpu_torch.errors import ConfigError
from arkflow_tpu_torch.ops.ragged_attention import CapturedLaunches, capturing

StepFn = Callable[..., dict]

#: one capture stream per device, shared by every ``CompiledStep``: cuBLAS
#: keeps a workspace per (handle, stream) for the life of the process, so a
#: stream per step object would hold one more workspace (32 MiB on Hopper)
#: for every runner ever built, and a runner rebuilt after a crash would
#: leak it. Captures of different step objects serialise on the lock, as a
#: stream can hold one capture at a time.
_CAPTURE: dict = {}
_CAPTURE_GUARD = threading.Lock()


def _capture_stream(device: torch.device) -> tuple[torch.cuda.Stream, threading.Lock]:
    with _CAPTURE_GUARD:
        entry = _CAPTURE.get(device)
        if entry is None:
            entry = _CAPTURE[device] = (torch.cuda.Stream(device), threading.Lock())
        return entry


@dataclass
class _Entry:
    """One shape key: its static inputs, and on CUDA its graph, static
    outputs and the launches its capture recorded."""

    inputs: dict[str, torch.Tensor]
    graph: Optional[torch.cuda.CUDAGraph] = None
    outputs: dict[str, torch.Tensor] = field(default_factory=dict)
    launches: Optional[CapturedLaunches] = None


@dataclass
class Step:
    """One enqueued step: the host buffers its outputs are copied into,
    the event recorded after that copy (None on the CPU, where the copy is
    synchronous), and the outputs on the device (the static outputs of a
    replayed graph: valid until the next step of this ``CompiledStep``)."""

    out: dict[str, torch.Tensor]
    event: Optional[torch.cuda.Event]
    result: dict[str, torch.Tensor]


class CompiledStep:
    """One CUDA graph per shape key, replayed over static buffers."""

    def __init__(self, device: torch.device, *, eager: bool = False):
        self.device = device
        self.eager = eager
        #: graphs are captured on CUDA unless eager
        self.graphed = device.type == "cuda" and not eager
        self._lock = threading.Lock()
        self._entries: dict[Any, _Entry] = {}
        self._pool = None
        #: shape keys built: on CUDA (not eager) each is a captured graph,
        #: on the CPU and with ``eager`` the key's static buffers alone
        self.captures = 0
        #: of those, built by a ``warm`` step (the shape tuner's warm)
        self.warm_captures = 0
        #: steps per key after its first (its capture), warmup included
        self.replays: dict[Any, int] = {}

    def keys(self) -> list:
        with self._lock:
            return list(self._entries)

    def __contains__(self, key) -> bool:
        """Has ``key`` a graph (on the CPU or eager: static buffers) yet?"""
        return key in self._entries

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        """Drop every graph and static buffer (the next step of each key
        captures again), once the steps in flight have finished reading
        them."""
        with self._lock:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._entries.clear()
            self.replays.clear()
            self._pool = None

    def release(self, keys) -> int:
        """Drop the graphs and static buffers of ``keys`` (keys it does not
        hold are passed over) once the steps in flight have finished with
        them; a later step of such a key captures again. Returns the keys
        dropped."""
        with self._lock:
            gone = [k for k in keys if k in self._entries]
            if gone and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            for k in gone:
                del self._entries[k]
                del self.replays[k]
            return len(gone)

    def run(self, key, fn: StepFn, inputs: dict[str, torch.Tensor],
            out: Optional[dict[str, torch.Tensor]] = None,
            event: Optional[torch.cuda.Event] = None,
            wait: Optional[torch.cuda.Event] = None, warm: bool = False) -> Step:
        """Enqueue one step of ``key``: ``inputs`` (host or device tensors
        of the key's shapes) into the static inputs, the graph's replay (at
        the key's first step its capture; on the CPU or eager ``fn``), the
        outputs into ``out`` (host buffers, made, pinned on CUDA, when
        None), then ``event`` (made when None) recorded. ``wait``: an event
        the step's stream waits for first (a prefetch's copies). ``warm``: a
        capture this step makes counts in ``warm_captures`` too. Nothing
        here waits for the device."""
        with self._lock:
            cuda = self.device.type == "cuda"
            if cuda and wait is not None:
                torch.cuda.current_stream(self.device).wait_event(wait)
            entry = self._entries.get(key)
            if entry is None:
                step = self._first_step(key, fn, inputs, out, event)
                self.warm_captures += int(warm)
                return step
            for name, t in entry.inputs.items():
                t.copy_(inputs[name], non_blocking=True)
            if entry.graph is not None:
                entry.graph.replay()
                entry.launches.replay()
                result = entry.outputs
            else:
                result = fn(**entry.inputs)
            self.replays[key] += 1
            return self._copy_out(result, out, event)

    def _first_step(self, key, fn: StepFn, inputs, out, event) -> Step:
        static = {name: torch.empty(t.shape, dtype=t.dtype, device=self.device)
                  for name, t in inputs.items()}
        entry = _Entry(inputs=static)
        if not self.graphed:
            for name, t in static.items():
                t.copy_(inputs[name], non_blocking=True)
            step = self._copy_out(fn(**static), out, event)
        else:
            side, capture_lock = _capture_stream(self.device)
            with capture_lock:
                step = self._capture(fn, inputs, static, entry, out, event, side)
        self._entries[key] = entry
        self.replays[key] = 0
        self.captures += 1
        return step

    def _capture(self, fn: StepFn, inputs, static, entry, out, event,
                 side: torch.cuda.Stream) -> Step:
        """The key's eager first step on the capture stream, then its
        capture into ``entry``."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        main = torch.cuda.current_stream(self.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for name, t in static.items():
                t.copy_(inputs[name], non_blocking=True)
            step = self._copy_out(fn(**static), out, event)
        main.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # no automatic collection inside the capture: it could free
        # another object's graph here (``cudaGraphExecDestroy``), which
        # a capturing stream refuses, and the capture would be lost
        collecting = gc.isenabled()
        gc.disable()
        try:
            with capturing() as launched:
                with torch.cuda.graph(graph, pool=self._pool, stream=side,
                                      capture_error_mode="thread_local"):
                    entry.outputs = fn(**static)
        except BaseException as e:
            del graph
            if not any(x.graph is not None for x in self._entries.values()):
                self._pool = None
            torch.cuda.empty_cache()
            raise _first_oom(e) from e
        finally:
            if collecting:
                gc.enable()
        entry.graph, entry.launches = graph, launched
        return step

    def copy_params_(self, live: dict, new: dict, *, retain: bool = False) -> Optional[dict]:
        """Copy the tree ``new`` into the tensors of ``live`` in place (the
        graphs keep reading the same addresses), after checking that both
        trees have the same leaves with the same shapes, dtypes and
        strides. ``retain``: first copy the live tree into fresh tensors of
        the same strides and return it (a rollback token). The copies are
        enqueued on the step stream under the lock, behind every step
        already enqueued."""
        pairs = _leaf_pairs(live, new)
        with self._lock:
            kept = None
            if retain:
                kept = tree_map(lambda t: t.clone(memory_format=torch.preserve_format), live)
            with torch.no_grad():
                for dst, src in pairs:
                    dst.copy_(src, non_blocking=True)
            return kept

    def zero_(self, *tensors: torch.Tensor) -> None:
        """Zero ``tensors`` in place (state the graphs read by address, such
        as KV pools), enqueued on the step stream under the lock like
        ``copy_params_``."""
        with self._lock, torch.no_grad():
            for t in tensors:
                t.zero_()

    def _copy_out(self, result: dict, out, event) -> Step:
        cuda = self.device.type == "cuda"
        if out is None:
            out = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=cuda)
                   for k, v in result.items()}
        for k, v in result.items():
            out[k].copy_(v, non_blocking=True)
        if cuda:
            event = event if event is not None else torch.cuda.Event()
            event.record()
        return Step(out, event if cuda else None, result)


def _first_oom(e: BaseException) -> BaseException:
    """The allocator OOM in ``e``'s chain (ending a capture that an OOM
    broke may raise an error of its own), else ``e``."""
    seen = e
    while seen is not None:
        if isinstance(seen, torch.cuda.OutOfMemoryError):
            return seen
        seen = seen.__cause__ or seen.__context__
    return e


def tree_map(fn, tree: dict) -> dict:
    """``fn`` on every leaf of a param tree (nested dicts of tensors)."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def _leaf_pairs(live: dict, new: dict, path: str = "") -> list[tuple[torch.Tensor, torch.Tensor]]:
    """(live leaf, new leaf) of two trees that must match leaf for leaf in
    shape, dtype and strides; a ``ConfigError`` names the first that does
    not."""
    if set(live) != set(new):
        missing, extra = sorted(set(live) - set(new)), sorted(set(new) - set(live))
        raise ConfigError(f"param tree mismatch at {path or 'the root'}: the new tree "
                          f"lacks {missing} and has {extra} beyond the live one")
    pairs = []
    for k, dst in live.items():
        src, where = new[k], f"{path}[{k!r}]"
        if isinstance(dst, dict) or isinstance(src, dict):
            if not (isinstance(dst, dict) and isinstance(src, dict)):
                raise ConfigError(f"param tree mismatch at {where}: a subtree against a leaf")
            pairs += _leaf_pairs(dst, src, where)
            continue
        if dst.shape != src.shape or dst.dtype != src.dtype or dst.stride() != src.stride():
            raise ConfigError(
                f"param {where}: live {dst.dtype} {tuple(dst.shape)} strides {dst.stride()} "
                f"vs new {src.dtype} {tuple(src.shape)} strides {src.stride()}")
        pairs.append((dst, src))
    return pairs


class HostSet:
    """The host buffers of one step at one shape key: its inputs (``arrays``
    are numpy views to fill in place) and, from its first step on, its
    outputs; pinned on CUDA, so both copies run without a synchronisation.
    ``event`` is recorded after the step's copy-out: the set may be filled
    again, or its outputs read, once it has passed. ``device`` and
    ``ready`` hold a runner's prefetched device copies of the inputs and
    the event after those copies."""

    def __init__(self, key, shapes: dict[str, tuple[tuple, Any]], pinned: bool):
        self.key = key
        self.inputs: dict[str, torch.Tensor] = {}
        self.arrays: dict[str, np.ndarray] = {}
        for name, (shape, dtype) in shapes.items():
            t = torch.from_numpy(np.zeros(shape, dtype))
            if pinned:
                t = t.pin_memory()
            self.inputs[name] = t
            self.arrays[name] = t.numpy()
        self.out: Optional[dict[str, torch.Tensor]] = None
        self.event: Optional[torch.cuda.Event] = None
        self.device: Optional[dict[str, torch.Tensor]] = None
        self.ready: Optional[torch.cuda.Event] = None

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()

    def take(self, step: Step) -> None:
        """Keep a step's output buffers and event for the set's next step."""
        self.out, self.event = step.out, step.event

    def outputs(self, n: Optional[int] = None) -> dict[str, np.ndarray]:
        """Wait for the copy-out, then copies of the first ``n`` rows of
        every output (the set's buffers are refilled by its next step)."""
        self.wait()
        return {k: v.numpy()[:n].copy() for k, v in self.out.items()}


class DutyCycle:
    """The busy share of a device queue on the host clock: busy from the
    dispatch that finds it empty to the completion that empties it, idle
    between (``arkflow_tpu/tpu/runner.py`` ``_track_dispatch``,
    ``_track_complete``, ``duty_cycle``). A step counts as busy from its
    dispatch, so an eager step's own host dispatch is busy time too. The
    optional metrics are the JAX runner's ``arkflow_tpu_device_busy_seconds_total``,
    ``arkflow_tpu_infeed_stall_seconds_total``,
    ``arkflow_tpu_device_idle_gap_seconds`` and ``arkflow_tpu_steps_inflight``."""

    def __init__(self, *, busy=None, stall=None, idle_gap=None, inflight=None):
        self._lock = threading.Lock()
        self.inflight = 0
        self.busy_s = 0.0
        self.stall_s = 0.0
        self._busy_start = 0.0
        self._last_idle_start: Optional[float] = None
        #: optional metrics fed beside the sums: busy and stall counters
        #: (seconds), the idle-gap histogram, the in-flight gauge
        self._m_busy, self._m_stall = busy, stall
        self._m_idle_gap, self._m_inflight = idle_gap, inflight

    def dispatch(self, now: float) -> None:
        with self._lock:
            if self.inflight == 0:
                if self._last_idle_start is not None:
                    gap = now - self._last_idle_start
                    self.stall_s += gap
                    if self._m_stall is not None:
                        self._m_stall.inc(gap)
                    if self._m_idle_gap is not None:
                        self._m_idle_gap.observe(gap)
                self._busy_start = now
            self.inflight += 1
            if self._m_inflight is not None:
                self._m_inflight.set(self.inflight)

    def complete(self, now: float) -> None:
        with self._lock:
            self.inflight -= 1
            if self._m_inflight is not None:
                self._m_inflight.set(self.inflight)
            if self.inflight == 0:
                self.busy_s += now - self._busy_start
                if self._m_busy is not None:
                    self._m_busy.inc(now - self._busy_start)
                self._last_idle_start = now

    def share(self) -> float:
        """Busy fraction since the first dispatch (1.0 = never idle)."""
        with self._lock:
            total = self.busy_s + self.stall_s
            return self.busy_s / total if total > 0 else 0.0
