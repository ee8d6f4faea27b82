"""``gpu_inference`` processor: streaming model inference on the GPU.

Counterpart of ``arkflow_tpu/plugins/processor/tpu_inference.py`` on its
single-device paths: extract the inputs the model family's ``input_spec``
asks for, bucket and pad the batch (or pack it), run the model on the
device, and attach the outputs as columns. Token models (``("seq",)``
inputs) tokenize ``text_field`` with a HuggingFace fast tokenizer when
``tokenizer`` names one whose files are on this machine, with the hashing
tokenizer otherwise; tensor models (``vit_embedder``, ``lstm_ae``) read
``tensor_field`` (``tpu/extract.py``: raw bytes of a binary column, images
scaled by 1/255, or an N-D numeric column), padded over the batch
dimension only. Config (the keys of ``tpu_inference`` the port carries,
plus ``device``):

    type: gpu_inference
    model: bert_classifier
    model_config: {num_labels: 2}
    text_field: __value__          # payload column to tokenize
    tokenizer: bert-base-uncased   # optional, local files only (hashing
                                   # fallback otherwise)
    tensor_field: window           # tensor models: the input column (default
                                   # the input's own name)
    max_seq: 256
    batch_buckets: [16, 64]        # default pow2 grid up to max_batch
    seq_buckets: [64, 128, 256]    # default pow2 grid up to max_seq
    max_batch: 256
    outputs: [label, score]        # default: all rank-1 outputs; rank-2
                                   # outputs (embeddings) attach as 2-D
                                   # columns, the port's fixed-size lists
    warmup: true                   # capture every bucket's CUDA graph at
                                   # connect (one step per bucket)
    seed: 0                        # weights drawn from torch.Generator(seed)
    serving_dtype: bfloat16        # float32 | bfloat16 | float16 | int8 (W8A8:
                                   # int8 dense layers, models/quantize.py;
                                   # with packing too)
    max_in_flight: 2               # device steps in flight
    dispatch_depth: 2              # 2 = release the in-flight permit once a
                                   # step is enqueued: its output fetch runs
                                   # outside it (default 1)
    device: cuda                   # default cuda; cpu for tests
    packing: true                  # token packing (tpu/packing.py): pack the
                                   # batch's texts into dense rows once, carve
                                   # the layout into row windows on the grid
    example_scale: 4               # packed only: the example-dim grid extends
                                   # this far past the row grid (default 4
                                   # with packing)
    checkpoint: /path/to/ckpt      # restore at build (tpu/checkpoint.py,
                                   # torch-native), then the serving dtype
    step_deadline: 1s              # per-step watchdog: a step past it is
                                   # abandoned, the runner goes UNHEALTHY
                                   # and the batch nacks for redelivery
    step_deadline_first: 60s       # a key's first step (capture; without
                                   # warmup a kernel build); default 10x
    health:                        # recovery-probe schedule (tpu/health.py)
      probe_backoff: 100ms
      probe_backoff_cap: 30s
      dead_after: 8
    swap:                          # hot swap (tpu/swap.py; POST /admin/swap
      canary: {rows: 4}            # works without this block)
    integrity:                     # golden probes and param digests
      probe_interval: 10s          # (tpu/integrity.py); opt-in
      digest_every: 3
      golden: {rows: 2, seed: 42}
      repair: true
    tuner:                         # traffic-adaptive shapes (tpu/tuner.py):
      interval: 30s                # observe true token lengths, propose
      min_improvement: 0.02        # quantile-aligned seq edges, a token
      target_fill: 0.97            # budget, a deadline and example_scale,
      max_compiles: 64             # capture every new key while serving,
                                   # then flip behind a probe that rolls
                                   # back; POST /admin/tune forces a cycle
    response_cache:                # exact-match dedup in front of the device
      capacity: 1024               # (runtime/respcache.py): LRU + TTL on
      ttl: 30s                     # batch_fingerprint, concurrent duplicates
                                   # collapsed onto one step

The processor exposes ``runner``, ``swapper``, ``integrity``, ``tuner`` and
``cache`` (the engine's ``/health``, ``POST /admin/swap`` and ``POST
/admin/tune`` and the fault plugin reach them); ``connect`` starts the
integrity monitor and the tuner's loop, ``close`` stops them. A committed
swap, a committed tuner flip and an integrity quarantine each bump the
cache's epoch, so a later duplicate recomputes on the weights and grid
that serve. Every other ``tpu_inference`` key (mesh, pp_microbatch_rows,
pp_profile, pp_layer_costs, device_pool) raises "not yet ported".
"""

from __future__ import annotations

import asyncio
import time
from typing import Optional

import numpy as np

from arkflow_tpu_torch.batch import DEFAULT_BINARY_VALUE_FIELD, MessageBatch, batch_fingerprint
from arkflow_tpu_torch.components import Processor, Resource, register_processor
from arkflow_tpu_torch.errors import ArkError, ConfigError, ProcessError
from arkflow_tpu_torch.obs import global_registry
from arkflow_tpu_torch.obs.trace import record_stage
from arkflow_tpu_torch.runtime.respcache import build_response_cache, parse_response_cache_config
from arkflow_tpu_torch.tpu.bucketing import BucketPolicy
from arkflow_tpu_torch.tpu.integrity import build_integrity_monitor, parse_integrity_config
from arkflow_tpu_torch.tpu.packing import carve_row_windows, pack_tokens
from arkflow_tpu_torch.tpu.runner import ModelRunner, check_serving_dtype
from arkflow_tpu_torch.tpu.serving_core import parse_core_config
from arkflow_tpu_torch.tpu.swap import build_batch_swapper, parse_swap_config
from arkflow_tpu_torch.tpu.extract import extract_tensor
from arkflow_tpu_torch.tpu.tokenizer import build_tokenizer
from arkflow_tpu_torch.tpu.tuner import build_shape_tuner, parse_tuner_config

KEYS = ("model", "model_config", "text_field", "tokenizer", "tensor_field", "max_seq",
        "batch_buckets",
        "seq_buckets", "max_batch", "outputs", "warmup", "seed", "serving_dtype",
        "max_in_flight", "dispatch_depth", "device", "packing", "example_scale",
        "checkpoint", "step_deadline", "step_deadline_first", "health", "swap",
        "integrity", "tuner", "response_cache")


class GpuInferenceProcessor(Processor):
    def __init__(self, runner: ModelRunner, *, text_field: str, tokenizer, max_seq: int,
                 outputs: Optional[list[str]], warmup: bool = False, swapper=None,
                 integrity=None, tensor_field: Optional[str] = None, tuner=None,
                 response_cache=None):
        self.runner = runner
        #: the exact-match response cache (runtime/respcache.py), None
        #: without the block: every batch pays a device step
        self.cache = response_cache
        #: the shape tuner (tpu/tuner.py), None without the block: it
        #: observes every tokenized batch's true lengths
        self.tuner = tuner
        #: the hot-swap manager (tpu/swap.py): POST /admin/swap and the fault
        #: plugin's swap_corrupt/swap_crash reach it here
        self.swapper = swapper
        #: the integrity monitor (tpu/integrity.py), None without the block
        self.integrity = integrity
        self.text_field = text_field
        self.tensor_field = tensor_field
        self.tokenizer = tokenizer
        self.max_seq = max_seq
        self.outputs = outputs
        self._warmed = not warmup
        #: host extraction and tokenization per batch, the other half of the
        #: host infeed prep (the runner's histogram covers pad and stage)
        self.m_extract = global_registry().histogram(
            "arkflow_tpu_extract_seconds",
            "host-side Arrow->tensor extraction + tokenization per batch",
            {"model": runner.family.name})

    def attach_overload_controller(self, controller) -> None:
        """The stream's hook (``runtime/overload.attach_overload``): the
        cache's tenant-hit labels cap as the controller's do, and the tuner
        reports the controller's signals."""
        if self.cache is not None:
            self.cache.set_tenant_policy(controller.cfg.tenants)
        if self.tuner is not None:
            self.tuner.attach_overload_controller(controller)

    # -- input extraction --------------------------------------------------

    def _tokenize(self, batch: MessageBatch) -> tuple[np.ndarray, np.ndarray]:
        """Tokenize the text column (binary or string; a null row is empty
        text) off its buffer view."""
        try:
            values, offsets = batch.payload_view(self.text_field)
        except ArkError as e:
            raise ProcessError(f"gpu_inference: {e}") from e
        return self.tokenizer.encode_batch_view(values, offsets, self.max_seq)

    def _extract(self, batch: MessageBatch) -> dict[str, np.ndarray]:
        """Token models: tokenize, and cut the ids to the seq bucket of the
        longest row. Tensor models: each input from ``tensor_field`` (or the
        column of its own name)."""
        spec = self.runner.spec
        if "input_ids" in spec and any(t == ("seq",) for _, t in spec.values()):
            ids, mask = self._tokenize(batch)
            lengths = mask.sum(axis=1)
            if self.tuner is not None:
                self.tuner.observe(lengths)
            used = int(lengths.max()) if mask.size else 1
            sb = self.runner.buckets.seq_bucket(used)
            inputs = {"input_ids": ids[:, :sb]}
            if "attention_mask" in spec:
                inputs["attention_mask"] = mask[:, :sb]
            return inputs
        return {name: extract_tensor(batch, self.tensor_field or name, name, dtype, trailing,
                                     who="gpu_inference")
                for name, (dtype, trailing) in spec.items()}

    def _pack(self, batch: MessageBatch,
              policy: BucketPolicy) -> list[tuple[dict[str, np.ndarray], np.ndarray]]:
        """Tokenize, first-fit-pack every text into rows of the batch's seq
        bucket, and carve the layout into row windows on ``policy``."""
        ids, mask = self._tokenize(batch)
        if self.tuner is not None:  # an executor thread: the sketch locks
            self.tuner.observe(mask.sum(axis=1))
        return pack_windows(ids, mask, policy)

    # -- output attachment -------------------------------------------------

    def _attach(self, batch: MessageBatch, outputs: dict[str, np.ndarray]) -> MessageBatch:
        names = self.outputs or [k for k, v in outputs.items() if np.asarray(v).ndim == 1]
        out = batch
        for name in names:
            if name not in outputs:
                raise ProcessError(
                    f"gpu_inference: model produced {sorted(outputs)}, no output {name!r}")
            v = np.asarray(outputs[name])
            if v.ndim not in (1, 2):
                raise ProcessError(f"gpu_inference: cannot attach rank-{v.ndim} output {name!r}")
            out = out.with_column(name, v)
        return out

    # -- Processor ---------------------------------------------------------

    async def connect(self) -> None:
        """Run one step per bucket before the input starts producing, then
        start the tuner's loop and the integrity monitor."""
        if not self._warmed:
            self._warmed = True
            await asyncio.get_running_loop().run_in_executor(None, self.runner.warmup)
        if self.tuner is not None:
            self.tuner.start()
        if self.integrity is not None:
            self.integrity.start()

    async def close(self) -> None:
        if self.tuner is not None:
            await self.tuner.stop()
        if self.integrity is not None:
            await self.integrity.stop()

    def release(self) -> None:
        """Free the runner's device state (``ModelRunner.release``): the
        engine's restart loop calls it on a crashed stream."""
        self.runner.release()

    async def process(self, batch: MessageBatch) -> list[MessageBatch]:
        if batch.num_rows == 0:
            return []
        if not self._warmed:  # direct use without a stream (tests, tools)
            await self.connect()
        if self.cache is not None:
            # redeliveries and byte-identical retries share the fingerprint
            # (the ingest stamp and ext metadata are left out of it)
            outputs = await self.cache.get_or_compute(
                batch_fingerprint(batch), lambda: self._infer(batch), tenant=batch.tenant())
        else:
            outputs = await self._infer(batch)
        return [self._attach(batch, outputs)]

    async def _infer(self, batch: MessageBatch) -> dict[str, np.ndarray]:
        """One inference without the cache: extract, then the device
        step(s)."""
        if self.runner.packed:
            return await self._infer_packed(batch)
        t0 = time.perf_counter()
        inputs = await asyncio.get_running_loop().run_in_executor(
            None, self._timed, self._extract, batch)
        # the same stage name as the runner's pad and stage: the trace
        # breakdown shows one infeed cost, the two sites summed
        record_stage("infeed_prep", time.perf_counter() - t0)
        return await self.runner.infer(inputs)

    def _timed(self, fn, *args):
        """``fn(*args)`` observed on ``arkflow_tpu_extract_seconds`` (on the
        executor thread that runs it)."""
        with self.m_extract.time():
            return fn(*args)

    async def _infer_packed(self, batch: MessageBatch) -> dict[str, np.ndarray]:
        """Token-packed inference: tokenize, pack and carve on an executor
        thread, serve the windows concurrently (the runner's in-flight bound
        pipelines them), and scatter each window's per-example outputs back
        into row order. The windows are padded on the grid they were carved
        for, held until the last is served: a tuner flip in between (a
        smaller ``example_scale``) would not fit them."""
        loop = asyncio.get_running_loop()
        policy = self.runner.hold_grid()
        try:
            t0 = time.perf_counter()
            windows = await loop.run_in_executor(None, self._timed, self._pack, batch, policy)
            record_stage("infeed_prep", time.perf_counter() - t0)
            outs = await asyncio.gather(*[self.runner.infer(inputs, policy=policy)
                                          for inputs, _ in windows])
        finally:
            if self.runner.let_go(policy):
                await loop.run_in_executor(None, self.runner.sweep)
        return scatter_windows(windows, outs, batch.num_rows)


def pack_windows(ids: np.ndarray, mask: np.ndarray,
                 buckets: BucketPolicy) -> list[tuple[dict[str, np.ndarray], np.ndarray]]:
    """Pack tokenized rows at the seq bucket of the longest and carve the
    layout into row windows that fill the grid (``carve_row_windows``)."""
    lengths = mask.sum(axis=1).astype(np.int64)
    sb = buckets.seq_bucket(int(lengths.max()) if len(lengths) else 1)
    pk = pack_tokens(ids, lengths, sb)
    return carve_row_windows(pk, buckets.max_batch(), buckets.max_examples(),
                             buckets.batch_buckets)


def scatter_windows(windows, outs: list[dict[str, np.ndarray]], n: int) -> dict[str, np.ndarray]:
    """Each window's [E_w, ...] outputs back into the original row order
    (a window's examples are in row order, not input order)."""
    merged: dict[str, np.ndarray] = {}
    for key in outs[0]:
        first = np.asarray(outs[0][key])
        out = np.empty((n, *first.shape[1:]), first.dtype)
        for (_, idx), chunk in zip(windows, outs):
            out[idx] = chunk[key]
        merged[key] = out
    return merged


def _dispatch_depth(config: dict) -> int:
    """``dispatch_depth`` as the JAX processor reads it: an int, 1 when
    unset; below 1 raises."""
    raw = config.get("dispatch_depth")
    if raw is None:
        return 1
    try:
        depth = int(raw)
    except (TypeError, ValueError):
        raise ConfigError(f"gpu_inference.dispatch_depth must be an int, got {raw!r}") from None
    if depth < 1:
        raise ConfigError(f"dispatch_depth must be >= 1, got {depth}")
    return depth


def _check(config: dict) -> None:
    check_serving_dtype(config.get("serving_dtype"))
    _dispatch_depth(config)
    packing = config.get("packing", False)
    if not isinstance(packing, bool):
        raise ConfigError(f"gpu_inference.packing must be a bool, got {packing!r}")
    core = parse_core_config(config)
    for key in ("step_deadline_s", "step_deadline_first_s"):
        if core[key] is not None and core[key] <= 0:
            raise ConfigError(f"{key[:-2]} must be positive, got {core[key]}")
    parse_swap_config(config.get("swap"), who="gpu_inference")
    parse_integrity_config(config.get("integrity"), who="gpu_inference")
    if config.get("response_cache") is not None:
        parse_response_cache_config(config["response_cache"])


@register_processor("gpu_inference", keys=KEYS, check=_check)
def _build(config: dict, resource: Resource) -> GpuInferenceProcessor:
    model = config.get("model")
    if not model:
        raise ConfigError("gpu_inference requires 'model'")
    max_seq = int(config.get("max_seq", 128))
    packing = config.get("packing", False)
    # packed serving: a full row bucket of short texts carries several
    # examples per row, so the example grid defaults to 4x the row grid, or
    # token-budget emissions would be capped by example count, not tokens
    buckets = BucketPolicy.from_config(config, max_seq=max_seq,
                                       max_batch=int(config.get("max_batch", 256)),
                                       default_example_scale=4 if packing else 1)
    runner = ModelRunner(
        model, config.get("model_config"),
        buckets=buckets,
        seed=int(config.get("seed", 0)),
        device=config.get("device"),
        serving_dtype=config.get("serving_dtype"),
        max_in_flight=int(config.get("max_in_flight", 2)),
        dispatch_depth=_dispatch_depth(config),
        packed=packing,
        checkpoint=config.get("checkpoint"),
        **parse_core_config(config),
    )
    cache = build_response_cache(config.get("response_cache"), name=str(model))
    swapper = build_batch_swapper(
        runner, model=str(model), serving_dtype=config.get("serving_dtype"),
        swap_cfg=parse_swap_config(config.get("swap"), who="gpu_inference"),
        checkpoint=config.get("checkpoint"))
    integrity = build_integrity_monitor(
        runner, model=str(model),
        cfg=parse_integrity_config(config.get("integrity"), who="gpu_inference"))
    # probing quiesces across a swap, and a commit rebuilds the reference
    swapper.integrity = integrity
    tuner = build_shape_tuner(
        runner, model=str(model), packed=packing,
        cfg=parse_tuner_config(config.get("tuner"), who="gpu_inference"), cache=cache)
    if cache is not None:
        # answers computed by the old weights, or by a quarantined runner,
        # must not serve a later duplicate
        swapper.add_commit_hook(cache.bump_epoch)
        if integrity is not None:
            integrity.add_quarantine_hook(cache.bump_epoch)
    return GpuInferenceProcessor(
        runner,
        text_field=config.get("text_field", DEFAULT_BINARY_VALUE_FIELD),
        tokenizer=build_tokenizer(config.get("tokenizer"),
                                  vocab_size=getattr(runner.cfg, "vocab_size", 30522)),
        max_seq=max_seq,
        outputs=config.get("outputs"),
        warmup=bool(config.get("warmup", False)),
        swapper=swapper,
        integrity=integrity,
        tensor_field=config.get("tensor_field"),
        tuner=tuner,
        response_cache=cache,
    )
