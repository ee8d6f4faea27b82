"""ModelRunner: the single-device execution provider for streaming inference.

Counterpart of the single-device path of ``arkflow_tpu/tpu/runner.py``:
batch -> pad to a (batch, seq) bucket -> model on the device -> unpad.

- The device is explicit: ``device=None`` means CUDA, and without a card the
  runner raises instead of carrying on quietly on the CPU. ``device="cpu"``
  runs the same code on the CPU (tests), where the model's attention takes
  the kernel's plain version.
- The step is compiled: one CUDA graph per padded shape key
  (``tpu/compiled_step.py``), captured at the key's first step -- every
  key of ``grid_shapes`` at ``warmup`` -- and replayed after, counted in
  ``captures`` and ``dispatch_counts()``. ``eager=True`` (a keyword only,
  like ``jax.disable_jit``) runs every step op by op, for A/B comparisons.
- Padding, as the JAX runner counts it, on traffic steps only (not
  warmup, warm captures or ``traffic=False`` probes): ``padded_rows``,
  ``executed_rows``, and for token models ``true_tokens`` against
  ``token_capacity`` (bucket rows x seq bucket), so ``1 - true_tokens /
  token_capacity`` is the capacity-weighted padding waste the shape tuner's
  claims rest on. ``health_report()`` gives them.
- The retune surface of the shape tuner (``tpu/tuner.py``):
  ``count_new_shapes(policy)`` (grid keys without a graph yet),
  ``warm_shapes`` and ``warm_shapes_live`` (capture them; the live one
  under the in-flight permit and the first-step deadline, while serving)
  and ``retarget_buckets`` (the atomic flip). Warm captures are counted in
  ``warm_captures``, apart from the on-path ``captures``. A step pads
  against the grid it was given or found at its start, held
  (``hold_grid``) until it ends: a packed window carved before a flip is
  padded on the grid it was carved for. ``release_graphs`` drops the graphs
  of keys in no grid that may still serve (the live one, the tuner's kept
  rollback grid, the held ones), counted in ``released_graphs``.
- The dispatch plane of the JAX runner: ``_pad_inputs`` pads into a
  recycled pinned staging set (``StagingPool``); the eager prefetch copies
  it to the device on a copy stream before the in-flight permit, bounded
  by ``max_in_flight + 1``; ``infer`` runs host prep and the step on
  executor threads, never on the event loop, with at most
  ``max_in_flight`` steps dispatching at once; ``dispatch_depth`` 2
  releases the permit once a step is enqueued and fetches its outputs
  outside it; ``duty_cycle()`` is the device queue's busy share.
  ``torch.inference_mode`` is entered inside the executor thread (it is
  thread-local); outputs come back to the host through the set's pinned
  output buffers and one event.
- Metrics (``obs/metrics.py``, labelled ``model`` and, packed, ``packed:
  1``, the JAX runner's names): ``arkflow_tpu_infer_seconds``, rows, pad
  rows, fill ratio, padding waste, exec rows, tokens and token capacity
  (traffic steps only, beside the plain counters below), compiles (the
  on-path ``captures``) and warm compiles (``warm_captures``), steps in
  flight, device busy seconds, infeed stall seconds and the idle-gap
  histogram (from ``duty_cycle``'s tracker), infeed prep seconds, prefetch
  active, OOMs and the bucket cap. The JAX runner's donation and pp-bubble
  gauges have no counterpart (no donation, no pp plane).
- Trace stages (``obs/trace.py``, under the stream's ``process`` span):
  ``infeed_prep`` (pad and stage), ``device_dispatch_wait`` (the wait for
  an in-flight permit, above 0.5 ms) and ``device_step_first`` /
  ``device_step`` (attr ``bucket_rows``): the host clock from the
  dispatch, or at ``dispatch_depth`` 2 from this step's own enqueue, to
  the fetch that ends it. They are recorded on the event loop, around the
  awaited executor calls: an executor thread has no trace scope.
- The ragged kernel needs right-padded masks. A mask that is not a
  contiguous prefix of ones raises when flash was forced in config, and
  otherwise switches the runner to the plain attention for good, counted in
  ``flash_fallbacks``.
- ``packed=True`` serves token-packed layouts (``tpu/packing.py``) through
  the family's ``apply_packed``: the row dim pads to a batch bucket, the
  example dim to an example bucket, and a layout over the grid raises
  (callers carve it first with ``carve_row_windows``).
- ``serving_dtype="int8"`` quantizes the host tree (``models/quantize.py``)
  before the transfer, padded or packed; every dense layer then runs an
  int8 product and the attention stays on the float path.
- Tensor families (``vit_embedder``, ``lstm_ae``: fixed-shape float inputs,
  no ``"seq"`` dim) pad over the batch dimension only: one shape key, so
  one CUDA graph, per batch bucket, and no seq grid. Their outputs come
  back with their own trailing dims (an embedding ``[B, D]``). The token
  models' assumptions (``input_ids`` sizing the packed grid, the mask
  check) hold on the packed and token paths only. ``lstm_ae`` serves in
  float32, so a runner on CUDA warns when float32 matmuls may run in TF32
  (``torch.set_float32_matmul_precision`` other than ``"highest"``).

The lifecycle (the JAX runner's self-healing, swap and integrity surfaces):

- **Composition.** The runner composes a ``ServingRunnerCore``
  (``tpu/serving_core.py``): ``infer_sync`` and ``infer`` pass its heal gate,
  then run the step under ``run_deadlined*`` when ``step_deadline`` is set.
  A key with no graph yet takes ``step_deadline_first``: it covers the
  capture, its eager first step and, without warmup, a kernel's first
  build.
- **Chaos** (``inject_step_fault``) runs at the top of the step, before
  the ``CompiledStep`` lock, so a ``hang`` holds no lock the probe needs.
  A step that misses its deadline (the zombie) keeps its staging set until
  it ends.
- **Rebuild.** After a miss, the probe's gate builds a new ``CompiledStep``
  (fresh lock, static buffers and graph pool) and captures the warmed keys
  again, under the first-step deadline; the old one is left to the zombie
  and dropped when it returns. ``captures`` counts the recaptures.
- **OOM.** A step that runs out of device memory caps the batch grid below
  its bucket (``bucket_cap``), announces the cap on ``bucket_cap_bus()`` and
  marks the runner DEGRADED; a padded batch is split and retried on the
  capped grid, a packed one re-raised so it is repacked on redelivery.
- **Weights.** Every change keeps the live tensors' addresses, which the
  graphs read: ``adopt_params`` (swap, rollback, repair) copies a tree into
  them (``CompiledStep.copy_params_``) and returns the prior tree as a
  copy, and a chaos ``bitflip`` writes one leaf in place. ``place_params``
  stages a candidate in fresh tensors; ``host_params`` keeps the converted
  host tree, the integrity repair's source.
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
import os
import threading
import time
from functools import partial
from typing import Any, Optional, Sequence

import numpy as np
import torch

from arkflow_tpu_torch.errors import ConfigError, StepDeadlineExceeded
from arkflow_tpu_torch.models import get_model
from arkflow_tpu_torch.models.quantize import quantize_for_serving
from arkflow_tpu_torch.obs import global_registry
from arkflow_tpu_torch.obs.trace import record_stage
from arkflow_tpu_torch.tpu.bucketing import BucketPolicy, bucket_cap_bus
from arkflow_tpu_torch.tpu.compiled_step import CompiledStep, DutyCycle, HostSet, tree_map
from arkflow_tpu_torch.tpu.health import HealthConfig
from arkflow_tpu_torch.tpu.serving_core import ServingRunnerCore, is_oom_error

logger = logging.getLogger("arkflow_torch.runner")

_SERVING_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                   "float16": torch.float16}


def _env_flash_floor(default: int = 0) -> int:
    """``ARKFLOW_FLASH_MIN_SEQ``, tolerantly: a malformed value logs a warning
    and gives the default (explicit config values raise). The default is 0
    on the H100 until a measurement there says the kernel loses at short seq."""
    raw = os.environ.get("ARKFLOW_FLASH_MIN_SEQ")
    if raw is None:
        return default
    try:
        return int(raw)
    except ValueError:
        logger.warning("ARKFLOW_FLASH_MIN_SEQ=%r is not an int; using %d", raw, default)
        return default


def resolve_device(device: Any = None) -> torch.device:
    """``None`` means CUDA. Raises when CUDA is asked for (or implied) and no
    card is present: the runner never falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ConfigError(f"device {str(dev)!r} unsupported (cuda or cpu)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise ConfigError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def check_serving_dtype(serving_dtype: Optional[str]) -> None:
    if serving_dtype not in (None, "int8", *_SERVING_DTYPES):
        raise ConfigError(
            f"serving_dtype {serving_dtype!r} invalid (float32/bfloat16/float16/int8)")


def convert_for_serving(params, serving_dtype: Optional[str], family_name: str = ""):
    """Cast or quantize a host param tree for the serving dtype, before it
    goes to the device (as the JAX runner does):

    - ``int8``: W8A8 dynamic quantization (``models/quantize.py``): dense
      weights to per-channel int8, every other floating leaf to bf16;
    - ``bfloat16``/``float16``: every floating leaf cast;
    - ``float32``/None: unchanged."""
    check_serving_dtype(serving_dtype)
    if serving_dtype == "int8":
        params, n_q = quantize_for_serving(params)
        logger.info("[%s] int8 serving: %d dense layers quantized", family_name, n_q)
        return params
    if serving_dtype in (None, "float32"):
        return params
    target = _SERVING_DTYPES[serving_dtype]
    return tree_map(lambda t: t.to(target) if t.is_floating_point() else t, params)


def init_host_params(family, cfg, seed: int, checkpoint: Optional[str] = None) -> dict:
    """A param tree on the host: the family's init from
    ``torch.Generator().manual_seed(seed)``, then, with ``checkpoint``, the
    checkpoint restored into its structure (``tpu/checkpoint.py``)."""
    params = family.init(torch.Generator().manual_seed(seed), cfg)
    if checkpoint:
        from arkflow_tpu_torch.tpu.checkpoint import restore

        params = restore(checkpoint, params)
        logger.info("restored checkpoint from %s", checkpoint)
    return params


class StagingPool:
    """Recycled host staging buffers (``HostSet``s, pinned on CUDA), keyed
    by padded shape, as the JAX runner's ``_StagingPool``: in steady state
    every step lands in an already-seen bucket, so ``_pad_inputs`` pads into
    a recycled set instead of allocating. A set is checked out in prep and
    returned only after its step's outputs were fetched, so a recycled set
    can never race a copy still in flight. Thread-safe: prep runs on
    executor threads.

    Sizing invariant: ``max_per_key`` must cover every set that can be
    checked out on one key at once -- the dispatched-not-fetched steps
    (``dispatch_depth`` of them at depth > 1, in-flight steps otherwise)
    plus one set in prep. ``acquire`` never blocks (it returns None on an
    empty stack and the caller allocates), but an undersized cap silently
    brings back a fresh pinned allocation per step (``release`` drops sets
    beyond the cap), so the owner states the bound (``min_required``) and
    construction asserts the cap covers it."""

    def __init__(self, max_per_key: int, min_required: int = 1):
        assert max_per_key >= min_required >= 1, (
            f"staging max_per_key={max_per_key} cannot cover the "
            f"{min_required} concurrently-held buffer sets per key")
        self._free: dict[tuple, list[HostSet]] = {}
        self._max = max_per_key
        self._lock = threading.Lock()

    def acquire(self, key: tuple) -> Optional[HostSet]:
        with self._lock:
            stack = self._free.get(key)
            return stack.pop() if stack else None

    def release(self, bufs: HostSet) -> None:
        with self._lock:
            stack = self._free.setdefault(bufs.key, [])
            if len(stack) < self._max:
                stack.append(bufs)


def _pad_into(dst: np.ndarray, src: np.ndarray) -> None:
    """``src`` into the leading corner of ``dst``, zeros elsewhere: the JAX
    ``pad_seq_dim`` then ``pad_batch_dim``, in place. A seq dim longer than
    ``dst``'s is cut (the top seq bucket truncates); more rows than ``dst``
    holds raise."""
    if src.shape[0] > dst.shape[0]:
        raise ValueError(f"batch {src.shape[0]} exceeds bucket {dst.shape[0]}")
    region = tuple(slice(0, min(a, b)) for a, b in zip(dst.shape, src.shape))
    dst.fill(0)
    dst[region] = src[region]


def shape_key(shapes: dict[str, tuple]) -> tuple:
    """A padded step's shape key: its name-sorted (name, shape) pairs, as
    the JAX runner's ``_shape_key`` and ``_grid_shape_key``."""
    return tuple((k, tuple(v)) for k, v in sorted(shapes.items()))


class ModelRunner:
    def __init__(
        self,
        model: str,
        model_config: Optional[dict] = None,
        *,
        buckets: Optional[BucketPolicy] = None,
        seed: int = 0,
        device: Any = None,
        serving_dtype: Optional[str] = None,
        max_in_flight: int = 2,
        dispatch_depth: int = 1,
        host_params: Optional[dict] = None,
        packed: bool = False,
        eager: bool = False,
        checkpoint: Optional[str] = None,
        step_deadline_s: Optional[float] = None,
        step_deadline_first_s: Optional[float] = None,
        health_config: Optional[HealthConfig] = None,
    ):
        self.device = resolve_device(device)
        self.family = get_model(model)
        self.cfg = self.family.make_config(**(model_config or {}))
        if self.device.type == "cuda" and torch.get_float32_matmul_precision() != "highest":
            logger.warning("[%s] float32 matmuls may run in TF32 (float32 matmul precision "
                           "%r): float32 models leave their float32 floor", model,
                           torch.get_float32_matmul_precision())
        raw_flash = getattr(self.cfg, "use_flash_attention", False)
        self.cfg = self._resolve_auto_flags(self.cfg, self.device, packed)
        #: flash explicitly requested in config (never mutated): only then
        #: does an unservable mask raise; auto-chosen flash falls back
        self._flash_user_forced = raw_flash is True
        self._lock = threading.Lock()
        self.buckets = buckets or BucketPolicy()
        self.packed = packed
        if packed:
            if "apply_packed" not in self.family.extras:
                raise ConfigError(
                    f"model {model!r} has no packed execution (its family "
                    "publishes no apply_packed/packed_input_spec)")
            self._apply = self.family.extras["apply_packed"]
            self.spec = self.family.extras["packed_input_spec"](self.cfg)
        else:
            self._apply = self.family.apply
            self.spec = self.family.input_spec(self.cfg)
        self.serving_dtype = serving_dtype
        if host_params is None:
            # init on the CPU from an explicit generator, then one transfer
            host_params = init_host_params(self.family, self.cfg, seed, checkpoint)
        #: the layout a checkpoint restores into (a swap's ``prepare``): the
        #: unconverted tree's shapes, dtypes and strides, as meta tensors
        self.checkpoint_layout = tree_map(
            lambda t: torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="meta"),
            host_params)
        #: the converted host tree: the integrity repair re-adopts it and the
        #: golden reference is computed from it
        self.host_params = tree_map(lambda t: t.cpu(),
                                     convert_for_serving(host_params, serving_dtype, model))
        self.params = self.place_params(self.host_params)
        #: per-leaf digests of the live tree (``tpu/integrity.py``); None until
        #: the integrity monitor's first digest pass after boot or an adopt
        self.param_digests: Optional[dict[str, str]] = None
        # 2: one step computes while the next one's host work overlaps it
        if max_in_flight < 1:
            raise ConfigError(f"max_in_flight must be >= 1, got {max_in_flight}")
        self.max_in_flight = max_in_flight
        #: 1: a step holds its in-flight permit through dispatch and output
        #: fetch. 2: the permit is released once the step is enqueued, and
        #: the fetch (the wait for its copy-out) runs outside the in-flight
        #: window under the depth permit, so the next step's copies and
        #: replay overlap this one's compute even at max_in_flight 1
        if dispatch_depth < 1:
            raise ConfigError(f"dispatch_depth must be >= 1, got {dispatch_depth}")
        self.dispatch_depth = dispatch_depth
        self._inflight_sem: Optional[asyncio.Semaphore] = None
        #: bounds prefetched input sets on the device (held through the
        #: step): one more than the in-flight depth
        self._prefetch_sem: Optional[asyncio.Semaphore] = None
        #: bounds dispatched-not-fetched steps at dispatch_depth > 1
        self._depth_sem: Optional[asyncio.Semaphore] = None
        self._sem_loop: Optional[asyncio.AbstractEventLoop] = None
        # held sets per key: at depth > 1 the depth permit bounds the
        # dispatched-not-fetched steps (each holds its set until the fetch),
        # at depth 1 the in-flight permit; plus one set in prep either way
        self._staging = StagingPool(
            max_per_key=self.max_in_flight + self.dispatch_depth,
            min_required=(self.dispatch_depth if self.dispatch_depth > 1
                          else self.max_in_flight) + 1)
        #: the prefetch's host-to-device copies run on their own stream
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        #: one CUDA graph per padded shape key (``eager``: none, every step
        #: runs op by op, for A/B comparisons)
        self._compiled = CompiledStep(self.device, eager=eager)
        #: captures, and warm captures, of the ``CompiledStep``s that
        #: rebuilds replaced
        self._retired_captures = 0
        self._retired_warm = 0
        #: grids that steps in flight pad against (``hold_grid``): holders
        self._held: dict[BucketPolicy, int] = {}
        #: the grids ``release_graphs`` keeps besides the live one
        self._kept: tuple[BucketPolicy, ...] = ()
        #: keys of grids nothing serves that a held grid still needs:
        #: dropped once its last holder lets go
        self._stale: set = set()
        #: graphs dropped by ``release_graphs``
        self.released_graphs = 0
        reg = global_registry()
        labels = {"model": model, **({"packed": "1"} if packed else {})}
        self._register_metrics(reg, labels)
        self._duty = DutyCycle(busy=self.m_busy_s, stall=self.m_stall_s,
                               idle_gap=self.m_idle_gap, inflight=self.m_inflight)
        #: captures and warm captures already counted on the metrics
        self._m_captures_seen = self._m_warm_seen = 0
        self._dispatch_counts: dict[tuple, int] = {}
        #: model steps run on the device (warmup included)
        self.device_steps = 0
        #: of those, steps on packed layouts
        self.packed_steps = 0
        #: traffic steps' padding (warmup, warm captures and probes
        #: excluded): bucket rows beyond the true rows, bucket rows run,
        #: and for token models true tokens and the token slots (bucket
        #: rows x seq bucket) they were padded to
        self.padded_rows = 0
        self.executed_rows = 0
        self.true_tokens = 0
        self.token_capacity = 0
        #: true rows inferred (traffic only)
        self.rows = 0
        #: times the runner switched from the kernel to the plain attention
        #: because a mask was not right-padded
        self.flash_fallbacks = 0
        #: steps that ran out of device memory
        self.ooms = 0
        #: milliseconds of the last rebuild (a new ``CompiledStep`` and the
        #: recaptures), None before the first
        self.last_rebuild_ms: Optional[float] = None
        self.core = ServingRunnerCore(
            name=model, labels=labels, step_deadline_s=step_deadline_s,
            step_deadline_first_s=step_deadline_first_s, health_config=health_config,
            rebuild_fn=self._rebuild_after_incident)
        self.health = self.core.health
        self.m_prefetch_on.set(1 if self._copy_stream is not None else 0)
        self.m_bucket_cap.set(self.bucket_cap)

    def _register_metrics(self, reg, labels: dict) -> None:
        """The JAX runner's metric families, under its names and help."""
        self.m_infer = reg.histogram("arkflow_tpu_infer_seconds", "device step latency", labels)
        self.m_rows = reg.counter("arkflow_tpu_rows_total", "rows inferred", labels)
        self.m_pad = reg.counter("arkflow_tpu_pad_rows_total", "padding rows (waste)", labels)
        self.m_fill = reg.histogram(
            "arkflow_tpu_batch_fill_ratio", "true rows / bucket rows", labels,
            buckets=[0.125, 0.25, 0.5, 0.75, 0.9, 1.0])
        self.m_compiles = reg.counter("arkflow_tpu_compiles_total", "bucket compiles", labels)
        self.m_warm_compiles = reg.counter(
            "arkflow_tpu_warm_compiles_total",
            "bucket executables compiled OFF the serving path (shape-tuner "
            "warm/probe; compiles_total stays flat across a tuned flip)", labels)
        self.m_exec_rows = reg.counter(
            "arkflow_tpu_exec_rows_total",
            "bucket rows dispatched to the device, padding included (the "
            "honest FLOPs denominator; rows_total counts true examples)", labels)
        self.m_tokens = reg.counter(
            "arkflow_tpu_tokens_total",
            "true (non-padding) tokens dispatched — packed runners and "
            "unpacked token models (attention-mask sum) alike; the "
            "numerator of effective tokens/sec", labels)
        self.m_token_capacity = reg.counter(
            "arkflow_tpu_token_capacity_total",
            "token slots dispatched (bucket rows x padded seq): "
            "1 - tokens_total/capacity is the capacity-weighted padding "
            "waste INCLUDING seq padding — the honest aggregate; the "
            "per-step waste histogram over-weights small tail windows and "
            "reads row fill only for unpacked runners", labels)
        self.m_inflight = reg.gauge(
            "arkflow_tpu_steps_inflight", "device steps dispatched, not yet complete", labels)
        self.m_busy_s = reg.counter(
            "arkflow_tpu_device_busy_seconds_total",
            "wall seconds with >=1 step in flight (duty-cycle numerator)", labels)
        self.m_stall_s = reg.counter(
            "arkflow_tpu_infeed_stall_seconds_total",
            "wall seconds the device sat idle between steps (host-bound)", labels)
        self.m_idle_gap = reg.histogram(
            "arkflow_tpu_device_idle_gap_seconds",
            "gap between step N completing and step N+1 launching "
            "(device idle between consecutive steps)", labels)
        self.m_prep = reg.histogram(
            "arkflow_tpu_infeed_prep_seconds",
            "host-side infeed prep (pad/stage/validate) per step", labels)
        self.m_waste = reg.histogram(
            "arkflow_padding_waste_frac",
            "padding fraction of each dispatched bucket (pad rows / bucket rows; "
            "token padding frac for packed runners)", labels,
            buckets=[0.0, 0.125, 0.25, 0.5, 0.75, 0.9, 1.0])
        self.m_prefetch_on = reg.gauge(
            "arkflow_tpu_prefetch_active",
            "1 when eager host->device prefetch is enabled for this runner", labels)
        self.m_oom = reg.counter(
            "arkflow_tpu_oom_total",
            "device RESOURCE_EXHAUSTED / OOM failures observed in steps", labels)
        self.m_bucket_cap = reg.gauge(
            "arkflow_tpu_bucket_cap",
            "largest batch bucket currently served (shrinks after device OOM)", labels)

    def _sync_capture_metrics(self) -> None:
        """Carry new captures and warm captures onto their counters; the
        caller holds ``_lock``."""
        caps, warm = self.captures, self.warm_captures
        if caps > self._m_captures_seen:
            self.m_compiles.inc(caps - self._m_captures_seen)
            self._m_captures_seen = caps
        if warm > self._m_warm_seen:
            self.m_warm_compiles.inc(warm - self._m_warm_seen)
            self._m_warm_seen = warm

    @property
    def captures(self) -> int:
        """Shape keys captured on the serving path (the JAX runner's compile
        count): at warmup, at a key's first step and by rebuilds; a CUDA
        graph each on CUDA, on the CPU or ``eager`` the key's static
        buffers. The shape tuner's warm captures are not in it."""
        return (self._retired_captures + self._compiled.captures
                - self.warm_captures)

    @property
    def warm_captures(self) -> int:
        """Shape keys captured by ``warm_shapes``/``warm_shapes_live`` (the
        JAX runner's warm compiles)."""
        return self._retired_warm + self._compiled.warm_captures

    def graph_counts(self) -> dict:
        """The tuner report's graph counts: keys held now, on-path and warm
        captures, and graphs released."""
        return {"keys": len(self._compiled), "captures": self.captures,
                "warm_captures": self.warm_captures, "released": self.released_graphs}

    @property
    def bucket_cap(self) -> int:
        """The largest batch bucket served; shrinks after a device OOM."""
        return self.buckets.max_batch()

    @property
    def deadline_misses(self) -> int:
        return self.core.deadline_misses

    @property
    def rebuilds(self) -> int:
        return self.core.rebuilds

    @staticmethod
    def _resolve_auto_flags(cfg, device: torch.device, packed: bool = False):
        """``use_flash_attention=None`` means auto: the ragged kernel on CUDA,
        the plain attention on the CPU. ``ARKFLOW_FLASH=0`` forces the plain
        attention even over an explicit ``use_flash_attention: true`` (and
        ``packed_flash: true``). An unset ``flash_min_seq`` takes
        ``ARKFLOW_FLASH_MIN_SEQ`` (default 0).

        Packed runners resolve ``packed_flash=None`` the same way: the
        segment kernel on CUDA (one device here), the pair-mask attention on
        the CPU, where an explicit ``packed_flash: true`` takes the kernel's
        plain version through its wrapper. The JAX package leaves its
        segment kernel off by default only because it had no A/B run on a
        TPU (``arkflow_tpu/ops/segment_attention.py``); ``chip_smoke.py``
        runs that A/B on the H100 (kernel against the pair mask and the
        unpacked ragged path, same texts), so on CUDA the kernel is the
        default."""
        if not hasattr(cfg, "use_flash_attention"):
            return cfg
        if packed and getattr(cfg, "packed_flash", False) is None:
            on = device.type == "cuda" and os.environ.get("ARKFLOW_FLASH", "1") != "0"
            cfg = dataclasses.replace(cfg, packed_flash=on)
        if os.environ.get("ARKFLOW_FLASH", "1") == "0":
            return dataclasses.replace(cfg, use_flash_attention=False,
                                       **({"packed_flash": False}
                                          if hasattr(cfg, "packed_flash") else {}))
        if cfg.use_flash_attention is not None:
            if (cfg.use_flash_attention and cfg.flash_min_seq is None
                    and os.environ.get("ARKFLOW_FLASH_MIN_SEQ")):
                return dataclasses.replace(cfg, flash_min_seq=_env_flash_floor())
            return cfg
        on_cuda = device.type == "cuda"
        extra = {}
        if on_cuda and cfg.flash_min_seq is None:
            extra["flash_min_seq"] = _env_flash_floor()
        return dataclasses.replace(cfg, use_flash_attention=on_cuda, **extra)

    def _disable_flash(self) -> None:
        """Auto fallback: serve with the plain attention from now on.
        Concurrent prep threads may call this together; it counts once. The
        captured graphs replay the kernel, so every one is dropped: the next
        step of each shape captures again from the new ``cfg`` (the JAX
        ``_build_jitted`` rebuilds for the same reason)."""
        with self._lock:
            if not self.cfg.use_flash_attention:
                return
            self.cfg = dataclasses.replace(self.cfg, use_flash_attention=False)
            self.flash_fallbacks += 1
            self._compiled.clear()

    # -- shape plumbing ----------------------------------------------------

    def _padded_shapes(self, inputs: dict[str, np.ndarray],
                       policy: BucketPolicy) -> dict[str, tuple]:
        """Every input's bucket shape on ``policy``. Packed: the [P, S] row
        arrays take a batch bucket, the [E] example arrays an example
        bucket."""
        if self.packed:
            rows = policy.batch_bucket(inputs["input_ids"].shape[0])
            examples = policy.example_bucket(inputs["example_row"].shape[0])
        else:
            rows = examples = policy.batch_bucket(next(iter(inputs.values())).shape[0])
        shapes = {}
        for name, (_, trailing) in self.spec.items():
            arr = inputs.get(name)
            if arr is None:
                raise ConfigError(f"model {self.family.name!r} missing input {name!r}")
            dims = tuple(policy.seq_bucket(arr.shape[1]) if d == "seq" else d
                         for d in trailing)
            shapes[name] = (rows if "seq" in trailing else examples, *dims)
        return shapes

    def _staging_set(self, shapes: dict[str, tuple]) -> HostSet:
        key = shape_key(shapes)
        bufs = self._staging.acquire(key)
        if bufs is None:
            bufs = HostSet(key, {n: (s, self.spec[n][0]) for n, s in shapes.items()},
                           pinned=self.device.type == "cuda")
        return bufs

    def _pad_inputs(self, inputs: dict[str, np.ndarray], traffic: bool = True,
                    policy: Optional[BucketPolicy] = None) -> tuple[HostSet, int]:
        """Pad every input to its bucket on ``policy`` (None: the live
        grid), straight into a staging set (``HostSet.arrays``); returns
        (set, true count: rows, or examples when packed). Rows longer than
        the top seq bucket are truncated to it. Packed layouts pad P to a
        batch bucket (dead rows: segment 0) and E to an example bucket (pad
        examples point at row 0, position 0 and are sliced off by the true
        count); a layout over the grid, or over an OOM cap set since it was
        carved, raises. A ``traffic`` step counts its padding."""
        policy = policy if policy is not None else self.buckets
        if self.packed:
            p = inputs["input_ids"].shape[0]
            e = inputs["example_row"].shape[0]
            mb, me = min(policy.max_batch(), self.bucket_cap), policy.max_examples()
            if p > mb or e > me:
                raise ConfigError(
                    f"packed batch ({p} rows / {e} examples) exceeds the grid (max {mb} "
                    f"rows / {me} examples); carve row windows that fit before "
                    "dispatch (tpu/packing.py carve_row_windows)")
            n = e
        else:
            n = next(iter(inputs.values())).shape[0]
        bufs = self._staging_set(self._padded_shapes(inputs, policy))
        for name, (dtype, _) in self.spec.items():
            _pad_into(bufs.arrays[name], np.asarray(inputs[name], dtype=dtype))
        if traffic:
            self._count_padding(inputs, bufs)
        return bufs, n

    def _count_padding(self, inputs: dict[str, np.ndarray], bufs: HostSet) -> None:
        """A traffic step's padding, as the JAX runner's ``_pad_inputs``
        counts it: packed, rows are packed rows and tokens the live segment
        slots; padded, tokens are the (truncated) mask's ones."""
        bucket = self._bucket_rows(bufs)
        tokens = capacity = 0
        if self.packed:
            true_rows = inputs["input_ids"].shape[0]
            tokens = int(np.count_nonzero(np.asarray(inputs["segment_ids"]) > 0))
            capacity = bufs.arrays["input_ids"].size
        else:
            true_rows = next(iter(inputs.values())).shape[0]
            mask = bufs.arrays.get("attention_mask")
            if mask is not None:
                tokens, capacity = int(mask.sum()), mask.size
        with self._lock:
            self.padded_rows += bucket - true_rows
            self.executed_rows += bucket
            self.true_tokens += tokens
            self.token_capacity += capacity
        # packed: the step's token fill; padded: its row fill (JAX's forms)
        if self.packed:
            fill = tokens / capacity if capacity else 0.0
            waste = 1.0 - fill
        else:
            fill, waste = true_rows / bucket, (bucket - true_rows) / bucket
        self.m_pad.inc(bucket - true_rows)
        self.m_fill.observe(fill)
        self.m_waste.observe(waste)
        self.m_exec_rows.inc(bucket)
        self.m_tokens.inc(tokens)
        self.m_token_capacity.inc(capacity)

    def _prep(self, inputs: dict[str, np.ndarray], traffic: bool = True,
              policy: Optional[BucketPolicy] = None) -> tuple[HostSet, int]:
        t0 = time.perf_counter()
        try:
            bufs, n = self._pad_inputs(inputs, traffic, policy)
            try:
                self._check_mask(bufs.arrays)
            except BaseException:
                self._staging.release(bufs)
                raise
            return bufs, n
        finally:
            if traffic:
                self.m_prep.observe(time.perf_counter() - t0)

    def _check_mask(self, padded: dict[str, np.ndarray]) -> None:
        if not getattr(self.cfg, "use_flash_attention", False) or "attention_mask" not in padded:
            return
        m = padded["attention_mask"]
        # buckets below the floor take the plain attention, which serves
        # any mask: no reason to fail or to give up the kernel for them
        if m.shape[1] < (self.cfg.flash_min_seq or 0):
            return
        # the kernel reads row sums as prefix lengths; a non-contiguous
        # mask (left padding) would silently mis-attend
        lengths = m.sum(axis=1)
        prefix = (np.arange(m.shape[1])[None, :] < lengths[:, None]).astype(m.dtype)
        if not np.array_equal(prefix, m):
            if self._flash_user_forced:
                raise ConfigError(
                    "use_flash_attention requires right-padded attention "
                    "masks (contiguous prefix of ones)")
            logger.warning(
                "[%s] non-right-padded attention mask: switching from the "
                "ragged kernel to the plain attention", self.family.name)
            self._disable_flash()

    def grid_shapes(self, policy: BucketPolicy) -> list[dict[str, tuple]]:
        """Every padded-input shape ``policy`` can put on the device, as
        the JAX runner's ``grid_shapes``: each (batch, seq) bucket; packed,
        each (row bucket, example bucket) pair with the row bucket at most
        the example bucket (a packed row holds at least one example), at
        each seq bucket. ``warmup`` walks it."""
        has_seq = any("seq" in t for _, t in self.spec.values())
        seqs = list(policy.seq_buckets) if has_seq else [None]
        if self.packed:
            pairs = [(pb, eb) for eb in policy.example_buckets()
                     for pb in policy.batch_buckets if pb <= eb]
        else:
            pairs = [(bb, bb) for bb in policy.batch_buckets]
        shapes = []
        for pb, eb in pairs:
            for sl in seqs:
                shapes.append({
                    name: (eb if self.packed and "seq" not in trailing else pb,
                           *(sl if d == "seq" else d for d in trailing))
                    for name, (_, trailing) in self.spec.items()})
        return shapes

    # -- execution ---------------------------------------------------------

    def _forward(self, **inputs: torch.Tensor) -> dict:
        return self._apply(self.params, self.cfg, **inputs)

    def _to_device(self, bufs: HostSet) -> None:
        """The eager prefetch: the set's inputs to device buffers of its
        own on the copy stream, without a synchronisation; the step's
        stream waits for ``bufs.ready`` before its copy into the graph's
        static inputs. Runs before the in-flight permit, so batch n+1's
        transfer overlaps batch n's compute. On the CPU the host buffers
        serve as they are."""
        if self._copy_stream is None:
            bufs.device = bufs.inputs
            return
        with torch.cuda.stream(self._copy_stream):
            if bufs.device is None:
                # allocated on the copy stream that writes them: a block
                # from the step stream's pool may still be in use by a step
                # in flight there, which the copy is not ordered after
                bufs.device = {k: torch.empty(v.shape, dtype=v.dtype, device=self.device)
                               for k, v in bufs.inputs.items()}
                bufs.ready = torch.cuda.Event()
            # the device buffers are the set's own: the step that last read
            # them finished before the set came back to the pool
            for k, v in bufs.inputs.items():
                bufs.device[k].copy_(v, non_blocking=True)
            bufs.ready.record()

    def _enqueue(self, compiled: CompiledStep, bufs: HostSet, traffic: bool = True,
                 warm: bool = False) -> None:
        """Dispatch one step on ``compiled`` without waiting for it: the
        prefetched inputs into the shape's static inputs, its graph's replay
        (its capture at the shape's first step, counted as a ``warm``
        capture for the tuner's warm), the outputs into the set's pinned
        output buffers, and the set's event after them."""
        with torch.inference_mode():
            bufs.take(compiled.run(bufs.key, self._forward, bufs.device,
                                   out=bufs.out, event=bufs.event, wait=bufs.ready,
                                   warm=warm))
        with self._lock:
            self.device_steps += 1
            self.packed_steps += int(self.packed)
            if traffic:
                self._dispatch_counts[bufs.key] = self._dispatch_counts.get(bufs.key, 0) + 1
            self._sync_capture_metrics()

    def _fetch(self, bufs: HostSet, n: int, traffic: bool = True) -> dict[str, np.ndarray]:
        """Wait for the set's copy-out; the first ``n`` rows of every output
        (garbled while a chaos ``sdc`` fault is armed)."""
        out = self.core.corrupt_outputs(bufs.outputs(n))
        if traffic:
            with self._lock:
                self.rows += n
            self.m_rows.inc(n)
        return out

    def _step(self, compiled: CompiledStep, bufs: HostSet, n: int,
              probe: bool = False, traffic: bool = True) -> dict[str, np.ndarray]:
        """One blocking step of a prefetched set: chaos (not on a ``probe``),
        dispatch, fetch. Runs on an executor or watchdog thread (or the
        caller's, for ``infer_sync``). ``compiled`` was read when the step
        began: a step abandoned at its deadline finishes on the
        ``CompiledStep`` it began on, never on the one a rebuild put in its
        place."""
        if not probe:
            self.core.apply_chaos()
        self._enqueue(compiled, bufs, traffic=traffic)
        return self._fetch(bufs, n, traffic)

    def dispatch_counts(self) -> dict[tuple, int]:
        """Traffic steps per padded shape key (warmup excluded)."""
        with self._lock:
            return dict(self._dispatch_counts)

    def duty_cycle(self) -> float:
        """The device queue's busy share since the first ``infer`` dispatch,
        on the host clock (1.0 = never idle)."""
        return self._duty.share()

    def _bucket_rows(self, bufs: HostSet) -> int:
        return dict(bufs.key)["input_ids" if self.packed else next(iter(self.spec))][0]

    def _note_oom(self, bucket_rows: int) -> bool:
        """A step ran out of device memory on a ``bucket_rows`` bucket: cap
        the batch grid below it for good, announce the cap to the
        coalescers and mark the runner DEGRADED. True when a smaller bucket
        exists (the caller splits and retries); False at the smallest
        bucket, which marks the runner UNHEALTHY."""
        with self._lock:
            self.ooms += 1
            capped = self.buckets.capped(bucket_rows)
            if capped is not None and capped.max_batch() < self.buckets.max_batch():
                self.buckets = capped
        self.m_oom.inc()
        self.m_bucket_cap.set(self.bucket_cap)
        if capped is None:
            self.health.mark_unhealthy(f"device OOM at the smallest bucket ({bucket_rows} rows)")
            return False
        cap = self.bucket_cap
        bucket_cap_bus().announce(cap)
        self.health.mark_degraded(f"device OOM: batch buckets capped at {cap}")
        logger.warning("[%s] device OOM on a %d-row bucket: batch grid capped at %d",
                       self.family.name, bucket_rows, cap)
        return True

    def _after_failure(self, e: Exception, bucket_rows: int) -> bool:
        """A step that raised: True when it ran out of memory on a padded
        bucket with a smaller one below (retry on the capped grid). A packed
        layout cannot be split here: the grid is capped and the error
        raised, so the redelivered batch is packed on the capped grid."""
        return is_oom_error(e) and self._note_oom(bucket_rows) and not self.packed

    def infer_sync(self, inputs: dict[str, np.ndarray], *, probe: bool = False,
                   traffic: bool = True,
                   policy: Optional[BucketPolicy] = None) -> dict[str, np.ndarray]:
        """Blocking inference: pad -> device -> unpad. Batches larger than the
        biggest bucket are chunked and the outputs re-concatenated (packed
        layouts are never chunked: their row and example dims differ). With
        ``step_deadline`` the step runs on a watchdog thread; a device OOM
        caps the grid and retries the batch split onto it. ``probe``: a
        verification step (a golden probe, a swap's probe), which the
        one-shot chaos faults pass over, so that an armed fault lands on
        traffic. ``traffic=False`` (warmup's steps, the tuner's probe) moves
        no traffic count: rows, padding, dispatch counts, duty cycle.
        ``policy``: the grid to pad on (a packed window's, the grid it was
        carved for), held for the step; None: the live grid."""
        probing = self.core.heal_gate_sync()
        held = self.hold_grid(policy)
        try:
            return self._infer_sync_admitted(inputs, probe, traffic, held)
        except Exception as e:
            if probing:
                self.core.end_failed_probe(e)
            raise
        finally:
            if self.let_go(held):
                self.sweep()

    def _infer_sync_admitted(self, inputs: dict[str, np.ndarray], probe: bool,
                             traffic: bool, policy: BucketPolicy) -> dict[str, np.ndarray]:
        n_total = next(iter(inputs.values())).shape[0]
        mb = policy.max_batch()
        if n_total > mb and not self.packed:
            chunks = [self._infer_sync_admitted({k: v[i: i + mb] for k, v in inputs.items()},
                                                probe, traffic, policy)
                      for i in range(0, n_total, mb)]
            return {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
        bufs, n = self._prep(inputs, traffic, policy)
        compiled = self._compiled
        deadline = self.core.deadline_for(bufs.key not in compiled)
        try:
            self._to_device(bufs)
            step = partial(self._step, compiled, bufs, n, probe, traffic)
            t0 = time.perf_counter()
            out = (step() if deadline is None else self.core.run_deadlined_sync(
                step, deadline, on_zombie=partial(self._staging.release, bufs)))
            if traffic:
                self.m_infer.observe(time.perf_counter() - t0)
        except StepDeadlineExceeded:
            raise  # the zombie holds the set until it ends
        except Exception as e:
            self._staging.release(bufs)
            if self._after_failure(e, self._bucket_rows(bufs)):
                # split onto the capped grid, which is the live one
                return self._infer_sync_admitted(inputs, probe, traffic, self.buckets)
            raise
        self._staging.release(bufs)
        self.health.mark_success()
        return out

    def _ensure_sems(self) -> None:
        """(Re)bind the in-flight, prefetch and depth semaphores to the
        running loop: a runner may outlive one loop (tests, tools) and
        serve the next."""
        loop = asyncio.get_running_loop()
        if self._sem_loop is not loop:
            self._inflight_sem = asyncio.Semaphore(self.max_in_flight)
            self._prefetch_sem = asyncio.Semaphore(self.max_in_flight + 1)
            self._depth_sem = asyncio.Semaphore(self.dispatch_depth)
            self._sem_loop = loop

    async def infer(self, inputs: dict[str, np.ndarray], *, probe: bool = False,
                    traffic: bool = True,
                    policy: Optional[BucketPolicy] = None) -> dict[str, np.ndarray]:
        """Pipelined inference: the heal gate, host prep off the loop, the
        prefetch before the in-flight permit, at most ``max_in_flight``
        steps dispatching at once (and at ``dispatch_depth`` > 1 at most that
        many dispatched and not yet fetched), each under its deadline.
        ``probe``, ``traffic`` and ``policy`` as for ``infer_sync``."""
        probing = await self.core.heal_gate()
        held = self.hold_grid(policy)
        try:
            return await self._infer_admitted(inputs, probe, traffic, held)
        except Exception as e:
            if probing:
                self.core.end_failed_probe(e)
            raise
        finally:
            if self.let_go(held):
                await asyncio.get_running_loop().run_in_executor(None, self.sweep)

    async def _infer_admitted(self, inputs: dict[str, np.ndarray], probe: bool,
                              traffic: bool, policy: BucketPolicy) -> dict[str, np.ndarray]:
        loop = asyncio.get_running_loop()
        n_total = next(iter(inputs.values())).shape[0]
        mb = policy.max_batch()
        if n_total > mb and not self.packed:
            chunks = await asyncio.gather(*[
                self._infer_admitted({k: v[i: i + mb] for k, v in inputs.items()}, probe,
                                     traffic, policy)
                for i in range(0, n_total, mb)])
            return {k: np.concatenate([c[k] for c in chunks]) for k in chunks[0]}
        t_prep0 = time.perf_counter()
        bufs, n = await loop.run_in_executor(None, self._prep, inputs, traffic, policy)
        record_stage("infeed_prep", time.perf_counter() - t_prep0)
        self._ensure_sems()
        compiled = self._compiled
        first = bufs.key not in compiled
        deadline = self.core.deadline_for(first)
        release = partial(self._staging.release, bufs)
        retry = False
        try:
            async with self._prefetch_sem:
                await loop.run_in_executor(None, self._to_device, bufs)
                t_sem = time.perf_counter()
                # a key's first step captures inside the dispatch: it takes
                # the watched path, whose deadline covers the capture
                if self.dispatch_depth > 1 and not first:
                    out = await self._step_split(loop, compiled, bufs, n, deadline, probe,
                                                 traffic, t_sem)
                else:
                    async with self._inflight_sem:
                        t0 = self._note_dispatch(t_sem)
                        self._duty_dispatch(traffic)
                        try:
                            step = partial(self._step, compiled, bufs, n, probe, traffic)
                            out = await (loop.run_in_executor(None, step) if deadline is None
                                         else self.core.run_deadlined(step, deadline,
                                                                      on_zombie=release))
                        finally:
                            self._duty_complete(traffic)
                        self._note_step(t0, first, bufs, traffic)
        except StepDeadlineExceeded:
            release = None  # the zombie holds the set until it ends
            raise
        except Exception as e:
            retry = self._after_failure(e, self._bucket_rows(bufs))
            if not retry:
                raise
        finally:
            if release is not None:
                release()
        if retry:  # split onto the capped grid, which is the live one
            return await self._infer_admitted(inputs, probe, traffic, self.buckets)
        self.health.mark_success()
        return out

    @staticmethod
    def _note_dispatch(t_sem: float) -> float:
        """The step holds its in-flight permit: a wait for it above 0.5 ms
        is device queueing, its own stage. Returns the dispatch time."""
        t0 = time.perf_counter()
        if t0 - t_sem > 0.0005:
            record_stage("device_dispatch_wait", t0 - t_sem)
        return t0

    def _note_step(self, t0: float, first: bool, bufs: HostSet, traffic: bool) -> None:
        """A step ended: its host-clock time from dispatch to fetch, as the
        latency histogram (traffic only) and the ``device_step`` stage (a
        key's first step, which captures, as ``device_step_first``)."""
        dt = time.perf_counter() - t0
        if traffic:
            self.m_infer.observe(dt)
        record_stage("device_step_first" if first else "device_step", dt,
                     attrs={"bucket_rows": self._bucket_rows(bufs)})

    def _duty_dispatch(self, traffic: bool) -> None:
        if traffic:
            self._duty.dispatch(time.perf_counter())

    def _duty_complete(self, traffic: bool) -> None:
        if traffic:
            self._duty.complete(time.perf_counter())

    async def _step_split(self, loop, compiled: CompiledStep, bufs: HostSet, n: int,
                          deadline: Optional[float], probe: bool,
                          traffic: bool, t_sem: float) -> dict[str, np.ndarray]:
        """``dispatch_depth`` > 1: the in-flight permit covers the dispatch
        only; the depth permit, held from before the enqueue until the
        outputs are fetched, bounds the dispatched-not-fetched steps (the
        device queue's backpressure, and the bound the staging pool is
        sized against). Chaos and the deadline watch the fetch, whose
        budget runs from the step's own enqueue."""
        async with self._depth_sem:
            async with self._inflight_sem:
                t0 = self._note_dispatch(t_sem)
                self._duty_dispatch(traffic)
                try:
                    await loop.run_in_executor(None, self._enqueue, compiled, bufs, traffic)
                except BaseException:
                    self._duty_complete(traffic)
                    raise
                dispatched_at = time.monotonic()

            def fetch():
                if not probe:
                    self.core.apply_chaos()
                return self._fetch(bufs, n, traffic)

            try:
                if deadline is None:
                    out = await loop.run_in_executor(None, fetch)
                else:
                    out = await self.core.run_deadlined(
                        fetch, self.core.deadline_remaining(deadline, dispatched_at),
                        on_zombie=partial(self._staging.release, bufs))
            finally:
                self._duty_complete(traffic)
        self._note_step(t0, False, bufs, traffic)
        return out

    def warmup(self) -> int:
        """One step at every shape of ``grid_shapes``, so every graph is
        captured (and the first-use costs -- library loads, kernel builds,
        allocator growth -- land) before traffic does. Returns the number of
        steps."""
        shapes = self.grid_shapes(self.buckets)
        for shape in shapes:
            self.infer_sync({name: np.zeros(s, dtype=self.spec[name][0])
                             for name, s in shape.items()}, traffic=False)
        logger.info("[%s] warmed %d bucket shapes (%d captured)", self.family.name,
                    len(shapes), self.captures)
        return len(shapes)

    # -- rebuild after a deadline miss --------------------------------------

    def _rebuild_after_incident(self) -> None:
        """The core's rebuild (the probe's heal gate, after a deadline
        miss): graphs replayed across a device hang are not trusted. A new
        ``CompiledStep`` (fresh lock, static buffers and graph pool) takes
        the old one's place, which is left to the zombie step and dropped
        when it returns: cleared in place, a late zombie would write into
        buffers the next step reads. Every key the old one held that the
        grid still holds (an OOM cap drops some) is captured again before
        the probe step, under the first-step deadline."""
        with self._lock:
            old = self._compiled
            self._compiled = CompiledStep(self.device, eager=old.eager)
            self._retired_captures += old.captures
            self._retired_warm += old.warm_captures
            self._sync_capture_metrics()
        t0 = time.perf_counter()
        grid = {shape_key(s) for s in self.grid_shapes(self.buckets)}
        # not old.keys(): a zombie first step (capture, kernel build) may
        # hold the old lock for as long as it runs; a copy of the dict is
        # atomic under the GIL, and a key the zombie adds after it is not
        # needed
        keys = [k for k in list(old._entries) if k in grid]
        del old
        recapture = partial(self._capture_keys, self._compiled, keys)
        deadline = self.core.deadline_for(True)
        if deadline is None:
            recapture()
        else:
            self.core.run_deadlined_sync(recapture, deadline * max(1, len(keys)))
        self.last_rebuild_ms = (time.perf_counter() - t0) * 1e3
        logger.warning("[%s] rebuilt the compiled step after a deadline miss: %d keys "
                       "captured again", self.family.name, len(keys))

    def _capture_keys(self, compiled: CompiledStep, keys: list, warm: bool = False) -> None:
        """One step of zeros at each shape key on ``compiled`` (warmup's
        inputs), which captures its graph; not traffic. ``warm``: the
        tuner's warm captures, counted apart."""
        for key in keys:
            bufs = self._staging_set(dict(key))
            try:
                for arr in bufs.arrays.values():
                    arr.fill(0)
                self._to_device(bufs)
                self._enqueue(compiled, bufs, traffic=False, warm=warm)
                bufs.wait()
            finally:
                self._staging.release(bufs)

    # -- the shape tuner's retune surface (tpu/tuner.py) ----------------------

    def _new_keys(self, policy: BucketPolicy) -> list:
        """The shape keys of ``policy``'s grid without a graph yet."""
        return [k for k in (shape_key(s) for s in self.grid_shapes(policy))
                if k not in self._compiled]

    def count_new_shapes(self, policy: BucketPolicy) -> int:
        """How many keys ``policy`` would still have to capture: the tuner's
        cost gate reads it before a flip."""
        return len(self._new_keys(policy))

    def _warm_key(self, compiled: CompiledStep, key: tuple) -> None:
        """Capture one key as a warm capture. An OOM inside it leaves as
        that OOM, after capping the grid below the key's row bucket and
        announcing the cap, as a traffic step's OOM does."""
        try:
            self._capture_keys(compiled, [key], warm=True)
        except Exception as e:
            if is_oom_error(e):
                self._note_oom(dict(key)["input_ids" if self.packed else next(iter(self.spec))][0])
            raise

    def _claim(self, policy: BucketPolicy) -> None:
        """A grid about to be warmed: its keys leave the stale set, so a
        pending release does not drop what the warm relies on."""
        keys = {shape_key(s) for s in self.grid_shapes(policy)}
        with self._lock:
            self._stale -= keys

    def warm_shapes(self, policy: BucketPolicy) -> int:
        """Capture every key of ``policy`` without a graph, blocking and
        without a deadline (tests, tools; the tuner's cycle runs
        ``warm_shapes_live``). Returns the keys captured."""
        self._claim(policy)
        keys = self._new_keys(policy)
        for key in keys:
            self._warm_key(self._compiled, key)
        return len(keys)

    async def warm_shapes_live(self, policy: BucketPolicy) -> int:
        """``warm_shapes`` while serving: each capture holds an in-flight
        permit (no more steps dispatch at once than at any other time) and
        runs under the first-step deadline on a watchdog thread, so a
        wedged capture is abandoned -- the runner goes UNHEALTHY and heals
        through its rebuild, which recaptures the incumbent grid's keys
        only -- instead of holding the tuner forever."""
        self._ensure_sems()
        self._claim(policy)
        loop = asyncio.get_running_loop()
        count = 0
        for key in self._new_keys(policy):
            async with self._inflight_sem:
                compiled = self._compiled
                if key in compiled:  # a traffic step captured it meanwhile
                    continue
                warm = partial(self._warm_key, compiled, key)
                deadline = self.core.deadline_for(True)
                if deadline is None:
                    await loop.run_in_executor(None, warm)
                else:
                    await self.core.run_deadlined(warm, deadline)
            count += 1
        return count

    def retarget_buckets(self, policy: BucketPolicy) -> BucketPolicy:
        """Flip the serving grid atomically; returns the prior policy (the
        rollback token). Steps already padded keep their shapes: both grids'
        graphs are held, so the transition captures nothing."""
        with self._lock:
            old, self.buckets = self.buckets, policy
        self.m_bucket_cap.set(policy.max_batch())
        return old

    def hold_grid(self, policy: Optional[BucketPolicy] = None) -> BucketPolicy:
        """Hold ``policy`` (None: the live grid) for a step, or a carve whose
        windows are padded on it, until ``let_go``: ``release_graphs`` keeps
        a held grid's graphs. Returns the grid held."""
        with self._lock:
            policy = policy if policy is not None else self.buckets
            self._held[policy] = self._held.get(policy, 0) + 1
        return policy

    def let_go(self, policy: BucketPolicy) -> bool:
        """End one hold of ``hold_grid``. True when it was the grid's last
        and a release is pending: the caller then runs ``sweep`` (off the
        event loop: it waits for the device)."""
        with self._lock:
            self._held[policy] -= 1
            if self._held[policy]:
                return False
            del self._held[policy]
            return bool(self._stale)

    def release_graphs(self, keep: Optional[Sequence[BucketPolicy]] = None) -> int:
        """Drop the graphs of every key in no grid that may still serve: the
        live grid, ``keep`` (None: the grids the last call kept; the tuner
        keeps the rollback grid of its last commit) and the grids held by
        steps in flight, whose keys go once their last holder lets go.
        Returns the graphs dropped now."""
        with self._lock:
            if keep is not None:
                self._kept = tuple(keep)
            grids = {self.buckets, *self._kept}
        live = {shape_key(s) for g in grids for s in self.grid_shapes(g)}
        stale = set(self._compiled.keys()) - live
        with self._lock:
            self._stale = stale
        return self.sweep()

    def sweep(self) -> int:
        """Drop the stale keys that no live, kept or held grid needs."""
        with self._lock:
            grids = {self.buckets, *self._kept, *self._held}
            stale = set(self._stale)
        drop = stale - {shape_key(s) for g in grids for s in self.grid_shapes(g)}
        if not drop:
            return 0
        with self._lock:
            self._stale -= drop
        n = self._compiled.release(drop)
        with self._lock:
            self.released_graphs += n
        return n

    def release(self) -> None:
        """Free the runner's device state for good: every graph with its
        pool and static buffers, the staging sets and the weights. The
        engine releases a crashed stream's runners before it builds the
        stream again, so a restart does not keep a second model on the card;
        the runner serves nothing after."""
        self._compiled.clear()
        self._staging = StagingPool(max_per_key=self._staging._max, min_required=1)
        self.params = {}

    # -- swap and integrity surfaces (tpu/swap.py, tpu/integrity.py) ---------

    def place_params(self, host_params: dict) -> dict:
        """A converted host tree on the runner's device in fresh tensors of
        the same strides (a swap's candidate; the canary runs on it)."""
        return tree_map(lambda t: t.to(self.device, copy=True), host_params)

    def adopt_params(self, placed: dict, retain: bool = True) -> Optional[dict]:
        """Serve ``placed`` from the next step on: its values are copied into
        the live tensors, whose addresses the graphs hold (no capture runs
        again), behind every step already enqueued. Returns the prior tree
        as a copy, the rollback token (``retain``). The digest baseline
        described the prior tree: the integrity monitor takes a new one at
        its next pass."""
        old = self._compiled.copy_params_(self.params, placed, retain=retain)
        self.param_digests = None
        return old

    def swap_units(self) -> list[tuple[str, "ModelRunner"]]:
        """A single runner is one flippable unit."""
        return [("runner", self)]

    def inject_step_fault(self, kind: str, duration_s: float = 0.0) -> None:
        """Arm a chaos fault (the fault plugin's processor wrapper): ``hang``,
        ``oom`` and ``sdc`` live in the core; ``bitflip`` corrupts the
        largest float leaf of the live tree in place, the HBM corruption the
        integrity plane exists to catch."""
        if kind == "bitflip":
            self._bitflip_params()
            return
        self.core.inject_step_fault(kind, duration_s)

    def _bitflip_params(self) -> None:
        """Garble the largest float leaf of ``params`` in place (the JAX
        runner's ``x * -1000 + 3.7``). The digest baseline is left as it is:
        the drift is silent until the integrity monitor finds it."""
        from arkflow_tpu_torch.tpu.integrity import flatten

        floats = [(path, t) for path, t in flatten(self.params).items() if t.is_floating_point()]
        if not floats:
            raise ConfigError("bitflip: model has no float param leaf to corrupt")
        best_path, best = max(floats, key=lambda item: item[1].numel())
        garbled = (best.float() * -1000.0 + 3.7).to(best.dtype)
        self._compiled.copy_params_({"leaf": best}, {"leaf": garbled})
        logger.warning("[%s] chaos: bitflip corrupted param leaf %s", self.family.name,
                       best_path)

    def digest_params(self) -> dict[str, str]:
        """Per-leaf digests of the live tree (blocking: every leaf is copied
        to the host)."""
        from arkflow_tpu_torch.tpu.integrity import tree_digests

        return tree_digests(self.params)

    def rebaseline_digests(self) -> dict[str, str]:
        """Take the digest baseline from the live tree, at a known-good
        moment (a committed swap, a verified repair)."""
        self.param_digests = self.digest_params()
        return self.param_digests

    async def verify_params_live(self) -> list[str]:
        """Digest the live tree while serving, on an executor thread holding
        an in-flight permit, under the first-step deadline. Returns the
        drifted leaves; the first pass after boot or an adopt takes the
        baseline instead."""
        from arkflow_tpu_torch.tpu.integrity import diff_digests

        self._ensure_sems()
        async with self._inflight_sem:
            deadline = self.core.deadline_for(True)
            if deadline is None:
                digests = await asyncio.get_running_loop().run_in_executor(
                    None, self.digest_params)
            else:
                digests = await self.core.run_deadlined(self.digest_params, deadline)
        if self.param_digests is None:
            self.param_digests = digests
            return []
        return diff_digests(self.param_digests, digests)

    def health_report(self) -> dict:
        """JSON-able snapshot for the engine's ``/health``."""
        rep = self.core.health_report()
        rep.update(model=self.family.name, bucket_cap=self.bucket_cap, ooms=self.ooms,
                   captures=self.captures, warm_captures=self.warm_captures,
                   released_graphs=self.released_graphs, last_rebuild_ms=self.last_rebuild_ms,
                   padding={"padded_rows": self.padded_rows,
                            "executed_rows": self.executed_rows,
                            "true_tokens": self.true_tokens,
                            "token_capacity": self.token_capacity})
        return rep
