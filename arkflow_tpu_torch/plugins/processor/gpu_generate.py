"""``gpu_generate`` processor: LLM generation over the stream on the GPU.

Counterpart of ``arkflow_tpu/plugins/processor/tpu_generate.py`` in its
continuous mode: the payload column is tokenized (``HashTokenizer``, ids
truncated to ``max_input``), every row becomes one request on a
continuous-batching ``GenerationServer`` (paged KV, lockstep decode slots
shared by all the stream's workers), and the generated ids, rendered as
text, attach as a binary column. Config (the keys of ``tpu_generate`` the
port carries, plus ``device``):

    type: gpu_generate
    model: decoder_lm
    model_config: {vocab_size: 128256, dim: 4096, ...}   # llama3_8b() widths
    text_field: __value__
    max_input: 512
    max_new_tokens: 128
    eos_id: 2
    output_field: generated
    seq_buckets: [32, 64, 128, 256, 512]   # one-shot prefill buckets
    serving: continuous      # required: batch needs the contiguous cache
    slots: 16
    page_size: 16
    prefill_chunk: 128       # admit longer prompts in chunks between decode steps
    decode_kernel: auto      # auto (paged on CUDA, gather on the CPU) | gather | paged
    kernel_parity_check: true  # init-time golden check of the paged kernel (raises)
    dispatch_depth: 2        # 2 dispatches decode N+1 before N is fetched
                             # (the decode, chunk and prefill steps are CUDA
                             # graphs, captured at connect)
    seed: 0                  # weights drawn from torch.Generator(seed) on the device
    temperature: 0.0         # greedy only (sampling is not ported)
    top_k: 0
    device: cuda             # default cuda; cpu for tests
    checkpoint: /path/to/ckpt  # restore at build (tpu/checkpoint.py, torch-native)
    step_deadline: 1s        # per-step watchdog (tpu/serving_core.py): a hung
                             # step fails the requests in flight (their batches
                             # nack for redelivery), the server goes UNHEALTHY,
                             # the probe rebuilds its graphs over new KV pools
    step_deadline_first: 60s # a key's first step (its capture); default 10x
    health: {probe_backoff: 100ms, probe_backoff_cap: 30s, dead_after: 8}
    swap:                    # hot swap (tpu/swap.py): drain the slot grid, copy
      canary: {rows: 4}      # the weights in place, zero the KV pools;
      drain_timeout: 30s     # POST /admin/swap works without this block
    integrity:               # golden forwards of the live tree and param
      probe_interval: 10s    # digests (tpu/integrity.py); a mismatch
      digest_every: 3        # quarantines (CORRUPT) and repairs through
      golden: {rows: 1, seq: 8}  # swap_params; opt-in
      repair: true

The processor exposes ``server`` (also as ``runner``, the name the engine's
``/health`` and the fault plugin reach it by), ``params`` (the server's live
tree), ``host_params`` (a host copy of the known-good tree, the repair
source, kept when ``swap`` or ``integrity`` is configured), ``swapper`` and
``integrity``; ``connect`` captures the graphs and starts the integrity
monitor, ``close`` stops it. Every other ``tpu_generate`` key (tokenizer,
batch_buckets, max_batch, mesh, speculative_tokens, prefix_cache_pages,
kernel_interpret) raises "not yet ported".
"""

from __future__ import annotations

import asyncio
from typing import Optional

import numpy as np
import torch

from arkflow_tpu_torch.batch import DEFAULT_BINARY_VALUE_FIELD, BinaryColumn, MessageBatch
from arkflow_tpu_torch.components import Processor, Resource, register_processor
from arkflow_tpu_torch.errors import ConfigError, ProcessError, not_ported
from arkflow_tpu_torch.models import get_model
from arkflow_tpu_torch.tpu.bucketing import BucketPolicy
from arkflow_tpu_torch.tpu.compiled_step import tree_map
from arkflow_tpu_torch.tpu.integrity import (build_generate_integrity_monitor,
                                             parse_integrity_config)
from arkflow_tpu_torch.tpu.runner import resolve_device
from arkflow_tpu_torch.tpu.serving import GenerationServer
from arkflow_tpu_torch.tpu.serving_core import parse_core_config
from arkflow_tpu_torch.tpu.swap import build_generate_swapper, parse_swap_config
from arkflow_tpu_torch.tpu.tokenizer import HashTokenizer

KEYS = ("model", "model_config", "text_field", "max_input", "max_new_tokens", "eos_id",
        "output_field", "seq_buckets", "serving", "slots", "page_size", "prefill_chunk",
        "decode_kernel", "kernel_parity_check", "dispatch_depth", "seed", "temperature",
        "top_k", "device", "checkpoint", "step_deadline", "step_deadline_first", "health",
        "swap", "integrity")


class GpuGenerateProcessor(Processor):
    def __init__(self, server: GenerationServer, *, family, text_field: str,
                 tokenizer: HashTokenizer, max_input: int, max_new_tokens: int,
                 output_field: str, host_params: Optional[dict] = None):
        self.server = server
        #: the device runner, under the name the JAX processor exposes it by
        self.runner = server
        self.family = family
        self.cfg = server.cfg
        #: the server's live tree (swaps and repairs copy into it in place)
        self.params = server.params
        #: host copy of the known-good tree: the integrity repair's source
        self.host_params = host_params
        #: the hot-swap manager and the integrity monitor, set by the builder
        self.swapper = None
        self.integrity = None
        self.text_field = text_field
        self.tokenizer = tokenizer
        self.max_input = max_input
        self.max_new_tokens = max_new_tokens
        self.output_field = output_field
        #: tokens generated by this processor
        self.tokens = 0

    async def connect(self) -> None:
        """Capture the decode, chunk and one-shot prefill graphs (after the
        server's parity gate, which ran at build) before the input starts
        producing, then start the integrity monitor."""
        await asyncio.get_running_loop().run_in_executor(None, self.server.warmup)
        if self.integrity is not None:
            self.integrity.start()

    def place_params(self, host_params: dict) -> dict:
        """A host tree on the server's device in fresh tensors (a swap's
        candidate, a repair's source)."""
        return tree_map(lambda t: t.to(self.server.device, copy=True), host_params)

    async def process(self, batch: MessageBatch) -> list[MessageBatch]:
        if batch.num_rows == 0:
            return []
        col = batch.column(self.text_field)
        if not isinstance(col, BinaryColumn):
            raise ProcessError(f"gpu_generate: column {self.text_field!r} is not a binary column")
        ids, mask = self.tokenizer.encode_batch_view(col.values, col.offsets, self.max_input)
        lengths = mask.sum(axis=1)
        outs = await asyncio.gather(*[
            self.server.generate(ids[i, :lengths[i]].tolist(), max_new_tokens=self.max_new_tokens)
            for i in range(ids.shape[0])])
        counts = np.fromiter((len(o) for o in outs), np.int64, count=len(outs))
        offsets = np.zeros(len(outs) + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        flat = np.fromiter((t for o in outs for t in o), np.int64, count=int(offsets[-1]))
        self.tokens += int(offsets[-1])
        return [batch.with_column(self.output_field,
                                  self.tokenizer.decode_column(flat, offsets))]

    async def close(self) -> None:
        if self.integrity is not None:
            await self.integrity.stop()
        await self.server.close()


def _check(config: dict) -> None:
    serving = config.get("serving", "batch")
    if serving == "batch":
        raise not_ported("gpu_generate serving: batch (it needs the contiguous KV cache)")
    if serving != "continuous":
        raise ConfigError(f"gpu_generate serving must be batch|continuous, got {serving!r}")
    if float(config.get("temperature", 0.0) or 0.0) > 0 or int(config.get("top_k", 0) or 0) > 0:
        raise not_ported("gpu_generate temperature > 0 / top_k (sampling)")
    depth = config.get("dispatch_depth", 1)
    if isinstance(depth, bool) or not isinstance(depth, int) or depth < 1:
        raise ConfigError(f"gpu_generate.dispatch_depth must be a positive int, got {depth!r}")
    if depth > 2:
        raise ConfigError("gpu_generate.dispatch_depth caps at 2: lockstep decode can only lag "
                          "host bookkeeping by one in-flight step")
    kernel = config.get("decode_kernel", "auto")
    if kernel not in ("auto", "gather", "paged"):
        raise ConfigError(f"gpu_generate.decode_kernel must be auto|gather|paged, got {kernel!r}")
    # the model's shape keys, unported ones included, raise at --validate too
    get_model(config.get("model", "decoder_lm")).make_config(**(config.get("model_config") or {}))
    core = parse_core_config(config)
    for key in ("step_deadline_s", "step_deadline_first_s"):
        if core[key] is not None and core[key] <= 0:
            raise ConfigError(f"{key[:-2]} must be positive, got {core[key]}")
    parse_swap_config(config.get("swap"), who="gpu_generate")
    parse_integrity_config(config.get("integrity"), who="gpu_generate")


@register_processor("gpu_generate", keys=KEYS, check=_check)
def _build(config: dict, resource: Resource) -> GpuGenerateProcessor:
    model = config.get("model", "decoder_lm")
    family = get_model(model)
    if "generate" not in family.extras:
        raise ConfigError(f"model {model!r} does not support incremental decoding")
    cfg = family.make_config(**(config.get("model_config") or {}))
    device = resolve_device(config.get("device"))
    max_input = int(config.get("max_input", 256))
    max_new = int(config.get("max_new_tokens", 64))
    seed = int(config.get("seed", 0))
    buckets = BucketPolicy.from_config(config, max_seq=max_input)
    ckpt = config.get("checkpoint")
    keep_host = config.get("swap") is not None or config.get("integrity") is not None
    if ckpt:
        from arkflow_tpu_torch.tpu.checkpoint import restore

        # restored into the model tree's layout (meta tensors: nothing drawn)
        host = restore(ckpt, family.init(torch.Generator(), cfg, device="meta"))
        params = tree_map(lambda t: t.to(device, copy=True), host)
    else:
        # draw the weights on the device: a host float32 draw of an 8 B model
        # would take 32 GB of host memory
        params = family.init(torch.Generator(device=device).manual_seed(seed), cfg)
        host = tree_map(lambda t: t.to("cpu", copy=True), params) if keep_host else None
    server = GenerationServer(
        params, cfg, slots=int(config.get("slots", 8)),
        page_size=int(config.get("page_size", 16)), max_seq=max_input + max_new,
        eos_id=int(config.get("eos_id", 2)), prompt_buckets=list(buckets.seq_buckets),
        prefill_chunk=int(config.get("prefill_chunk", 0)),
        decode_kernel=str(config.get("decode_kernel", "auto")),
        kernel_parity_check=bool(config.get("kernel_parity_check", True)),
        dispatch_depth=int(config.get("dispatch_depth", 1)), name=str(model),
        **parse_core_config(config))
    proc = GpuGenerateProcessor(
        server, family=family, text_field=config.get("text_field", DEFAULT_BINARY_VALUE_FIELD),
        tokenizer=HashTokenizer(cfg.vocab_size), max_input=max_input,
        max_new_tokens=max_new, output_field=str(config.get("output_field", "generated")),
        host_params=host if keep_host else None)
    proc.swapper = build_generate_swapper(
        proc, model=str(model), swap_cfg=parse_swap_config(config.get("swap"), who="gpu_generate"),
        checkpoint=ckpt)
    proc.integrity = build_generate_integrity_monitor(
        proc, model=str(model),
        cfg=parse_integrity_config(config.get("integrity"), who="gpu_generate"))
    # probing quiesces across a swap, and a commit rebuilds the reference
    proc.swapper.integrity = proc.integrity
    return proc
