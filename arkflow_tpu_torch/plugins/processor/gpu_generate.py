"""``gpu_generate`` processor: LLM generation over the stream on the GPU.

Counterpart of ``arkflow_tpu/plugins/processor/tpu_generate.py``. The
payload column is tokenized (ids truncated to ``max_input``) with a
HuggingFace fast tokenizer when ``tokenizer`` names one whose files are on
this machine, with the hashing tokenizer otherwise, and the generated ids,
decoded to text, attach as a binary column: the hashing tokenizer renders
them as decimals in one vectorized pass (``decode_column``), a real one
decodes row by row. Two serving modes, as in JAX:

- ``serving: batch`` (the default): a batch is cut to the seq bucket of
  its longest true length, padded to its batch bucket (padding rows of
  length 1, which start done) and generated whole over the contiguous KV
  cache (``tpu/batch_generate.py``: one prefill and one decode CUDA graph
  per (batch bucket, seq bucket), captured at connect). One sampling key
  is split per batch on the event loop, from ``seed + 1``;
- ``serving: continuous``: every row becomes one request on a
  continuous-batching ``GenerationServer`` (paged KV, lockstep decode
  slots shared by all the stream's workers).

Config (the keys of ``tpu_generate`` the port carries, plus ``device``):

    type: gpu_generate
    model: decoder_lm
    model_config: {vocab_size: 128256, dim: 4096, ...}   # llama3_8b() widths
    text_field: __value__
    tokenizer: meta-llama/Meta-Llama-3-8B  # optional, local files only
    max_input: 512
    max_new_tokens: 128
    eos_id: 2
    output_field: generated
    seq_buckets: [32, 64, 128, 256, 512]   # prompt buckets (both modes)
    batch_buckets: [4, 16]   # batch mode: row buckets (default pow2 8..max_batch)
    max_batch: 16
    serving: batch           # batch | continuous
    slots: 16                # continuous mode from here on
    page_size: 16
    prefill_chunk: 128       # admit longer prompts in chunks between decode steps
    speculative_tokens: 3    # greedy: 2-gram drafts verified in one K3 chunk call
    prefix_cache_pages: 64   # LRU prefix cache of finished prompts' full pages
    decode_kernel: auto      # auto (paged on CUDA, gather on the CPU) | gather | paged
    kernel_parity_check: true  # init-time golden check of the paged kernel (raises)
    dispatch_depth: 2        # 2 dispatches decode N+1 before N is fetched
                             # (greedy only; the decode, chunk, verify and
                             # prefill steps are CUDA graphs, captured at connect)
    seed: 0                  # weights drawn from torch.Generator(seed) on the device;
                             # sampling keys from seed + 1
    temperature: 0.0         # > 0 samples (both modes)
    top_k: 0
    device: cuda             # default cuda; cpu for tests
    checkpoint: /path/to/ckpt  # restore at build (tpu/checkpoint.py, torch-native)
    step_deadline: 1s        # continuous mode (parsed, and unused, in batch
                             # mode, as in JAX): a hung step fails the requests
                             # in flight (their batches nack for redelivery),
                             # the server goes UNHEALTHY, the probe rebuilds its
                             # graphs over new KV pools
    step_deadline_first: 60s # a key's first step (its capture); default 10x
    health: {probe_backoff: 100ms, probe_backoff_cap: 30s, dead_after: 8}
    swap:                    # hot swap (tpu/swap.py): continuous mode drains the
      canary: {rows: 4}      # slot grid, copies the weights in place, zeroes
      drain_timeout: 30s     # the KV pools and flushes the prefix cache; batch
                             # mode copies between generations
    integrity:               # continuous mode only: golden forwards of the
      probe_interval: 10s    # live tree and param digests (tpu/integrity.py);
      digest_every: 3        # a mismatch quarantines (CORRUPT) and repairs
      golden: {rows: 1, seq: 8}  # through swap_params; opt-in
      repair: true

The processor exposes ``server`` (continuous; also as ``runner``, the name
the engine's ``/health`` and the fault plugin reach it by; None in batch
mode, which has no resident runner, as in JAX), ``generator`` (batch),
``params`` (the live tree), ``host_params`` (a host copy of the known-good
tree, kept when ``swap`` or ``integrity`` is configured), ``swapper`` and
``integrity``; ``connect`` captures the graphs and starts the integrity
monitor, ``close`` stops it. ``mesh`` and ``kernel_interpret`` raise "not
yet ported".
"""

from __future__ import annotations

import asyncio
from typing import Optional

import numpy as np
import torch

from arkflow_tpu_torch.batch import DEFAULT_BINARY_VALUE_FIELD, BinaryColumn, MessageBatch
from arkflow_tpu_torch.components import Processor, Resource, register_processor
from arkflow_tpu_torch.errors import ArkError, ConfigError, ProcessError
from arkflow_tpu_torch.models import get_model
from arkflow_tpu_torch.models.decoder import make_key, split_key
from arkflow_tpu_torch.obs import global_registry
from arkflow_tpu_torch.tpu.batch_generate import BatchGenerator
from arkflow_tpu_torch.tpu.bucketing import BucketPolicy
from arkflow_tpu_torch.tpu.compiled_step import tree_map
from arkflow_tpu_torch.tpu.integrity import (build_generate_integrity_monitor,
                                             parse_integrity_config)
from arkflow_tpu_torch.tpu.runner import resolve_device
from arkflow_tpu_torch.tpu.serving import GenerationServer
from arkflow_tpu_torch.tpu.serving_core import parse_core_config
from arkflow_tpu_torch.tpu.swap import build_generate_swapper, parse_swap_config
from arkflow_tpu_torch.tpu.tokenizer import build_tokenizer

KEYS = ("model", "model_config", "text_field", "tokenizer", "max_input", "max_new_tokens", "eos_id",
        "output_field", "seq_buckets", "batch_buckets", "max_batch", "serving", "slots",
        "page_size", "prefill_chunk", "speculative_tokens", "prefix_cache_pages",
        "decode_kernel", "kernel_parity_check", "dispatch_depth", "seed", "temperature",
        "top_k", "device", "checkpoint", "step_deadline", "step_deadline_first", "health",
        "swap", "integrity")


class GpuGenerateProcessor(Processor):
    def __init__(self, server: Optional[GenerationServer], *, family, cfg, params: dict,
                 text_field: str, tokenizer, max_input: int,
                 max_new_tokens: int, output_field: str, buckets: BucketPolicy,
                 generator: Optional[BatchGenerator] = None, seed: int = 0,
                 host_params: Optional[dict] = None):
        self.server = server
        #: the device runner, under the name the JAX processor exposes it by
        #: (continuous mode only, as in JAX)
        self.runner = server
        #: the batch mode's generator
        self.generator = generator
        self.family = family
        self.cfg = cfg
        #: the live tree (swaps and repairs copy into it in place)
        self.params = params
        self.device = params["embed"]["table"].device
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
        self.buckets = buckets
        #: the batch mode's sampling key (JAX ``_rng``: ``PRNGKey(seed + 1)``)
        self._key = make_key(seed + 1)
        #: tokens generated by this processor (and the JAX processor's
        #: ``arkflow_generated_tokens_total``)
        self.tokens = 0
        self.m_tokens = global_registry().counter(
            "arkflow_generated_tokens_total", "tokens generated", {"model": family.name})

    async def connect(self) -> None:
        """Capture the graphs before the input starts producing (continuous:
        decode, chunk, verify and the one-shot prefills, after the server's
        parity gate, which ran at build; batch: prefill and decode of every
        (batch bucket, seq bucket)), then start the integrity monitor."""
        loop = asyncio.get_running_loop()
        if self.server is not None:
            await loop.run_in_executor(None, self.server.warmup)
        else:
            shapes = [(b, min(t, self.max_input)) for b in self.buckets.batch_buckets
                      for t in self.buckets.seq_buckets]
            await loop.run_in_executor(None, self.generator.warmup, shapes)
        if self.integrity is not None:
            self.integrity.start()

    def place_params(self, host_params: dict) -> dict:
        """A host tree on the device in fresh tensors (a swap's candidate, a
        repair's source)."""
        return tree_map(lambda t: t.to(self.device, copy=True), host_params)

    async def process(self, batch: MessageBatch) -> list[MessageBatch]:
        if batch.num_rows == 0:
            return []
        try:  # a binary or string column; a null row is empty text
            values, offsets = batch.payload_view(self.text_field)
        except ArkError as e:
            raise ProcessError(f"gpu_generate: {e}") from e
        ids, mask = self.tokenizer.encode_batch_view(values, offsets, self.max_input)
        lengths = mask.sum(axis=1).astype(np.int32)
        if self.server is None:
            flat, offsets = await self._process_batch(ids, lengths)
        else:
            outs = await asyncio.gather(*[
                self.server.generate(ids[i, :lengths[i]].tolist(),
                                     max_new_tokens=self.max_new_tokens)
                for i in range(ids.shape[0])])
            counts = np.fromiter((len(o) for o in outs), np.int64, count=len(outs))
            offsets = np.zeros(len(outs) + 1, np.int64)
            np.cumsum(counts, out=offsets[1:])
            flat = np.fromiter((t for o in outs for t in o), np.int64, count=int(offsets[-1]))
        self.tokens += int(offsets[-1])
        self.m_tokens.inc(int(offsets[-1]))
        return [batch.with_column(self.output_field, self._detok_column(flat, offsets))]

    def _detok_column(self, flat: np.ndarray, offsets: np.ndarray) -> BinaryColumn:
        """Ragged ids (flat + offsets) -> a binary column of UTF-8 text: the
        hashing tokenizer's vectorized ``decode_column``, or a real
        tokenizer's ``decode`` row by row."""
        decode_column = getattr(self.tokenizer, "decode_column", None)
        if decode_column is not None:
            return decode_column(flat, offsets)
        return BinaryColumn.from_pylist(
            [self.tokenizer.decode(flat[offsets[i]:offsets[i + 1]].tolist()).encode()
             for i in range(len(offsets) - 1)])

    async def _process_batch(self, ids: np.ndarray,
                             lengths: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Batch mode: cut to the seq bucket of the longest true length, pad
        to the batch bucket (padding rows of length 1), generate, and the
        real rows' tokens as flat values and offsets."""
        sb = self.buckets.seq_bucket(int(lengths.max()) if lengths.size else 1)
        ids = ids[:, :sb]
        lengths = np.minimum(lengths, sb)
        n = ids.shape[0]
        bb = self.buckets.batch_bucket(n)
        if n > bb:
            raise ValueError(f"batch {n} exceeds bucket {bb}")
        ids = np.concatenate([ids, np.zeros((bb - n, ids.shape[1]), np.int32)])
        lengths = np.concatenate([lengths, np.ones(bb - n, np.int32)])
        # split on the event loop: concurrent worker batches never share a key
        self._key, sub = split_key(self._key)
        tokens, counts, _ = await asyncio.get_running_loop().run_in_executor(
            None, self.generator.generate, ids, lengths, n, sub)
        counts = counts.astype(np.int64)
        flat = tokens[np.arange(tokens.shape[1])[None, :] < counts[:, None]]
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        return flat, offsets

    async def close(self) -> None:
        if self.integrity is not None:
            await self.integrity.stop()
        if self.server is not None:
            await self.server.close()

    def release(self) -> None:
        """Free the server's or the generator's device state
        (``GenerationServer.release``, ``BatchGenerator.release``) and drop
        this processor's hold on the tree: the engine's restart loop calls
        it on a crashed stream."""
        (self.server or self.generator).release()
        self.params = {}
        self.host_params = None
        self.swapper = None


def _check(config: dict) -> None:
    serving = config.get("serving", "batch")
    if serving not in ("batch", "continuous"):
        raise ConfigError(f"gpu_generate serving must be batch|continuous, got {serving!r}")
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
    # parsed in both modes (a malformed duration or health block raises);
    # only the continuous server's core holds the deadlines positive, as in JAX
    core = parse_core_config(config)
    for key in ("step_deadline_s", "step_deadline_first_s"):
        if serving == "continuous" and core[key] is not None and core[key] <= 0:
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
    buckets = BucketPolicy.from_config(config, max_batch=int(config.get("max_batch", 16)),
                                       max_seq=max_input)
    temperature = float(config.get("temperature", 0.0))
    top_k = int(config.get("top_k", 0))
    eos_id = int(config.get("eos_id", 2))
    continuous = config.get("serving", "batch") == "continuous"
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
    # parsed in both modes; only the continuous server takes them, as in JAX
    core = parse_core_config(config)
    server = generator = None
    if continuous:
        server = GenerationServer(
            params, cfg, slots=int(config.get("slots", 8)),
            page_size=int(config.get("page_size", 16)), max_seq=max_input + max_new,
            eos_id=eos_id, prompt_buckets=list(buckets.seq_buckets),
            temperature=temperature, top_k=top_k, seed=seed + 1,
            prefill_chunk=int(config.get("prefill_chunk", 0)),
            speculative_tokens=int(config.get("speculative_tokens", 0)),
            prefix_cache_pages=int(config.get("prefix_cache_pages", 0)),
            decode_kernel=str(config.get("decode_kernel", "auto")),
            kernel_parity_check=bool(config.get("kernel_parity_check", True)),
            dispatch_depth=int(config.get("dispatch_depth", 1)), name=str(model), **core)
    else:
        generator = BatchGenerator(params, cfg, max_new_tokens=max_new, eos_id=eos_id,
                                   temperature=temperature, top_k=top_k)
    proc = GpuGenerateProcessor(
        server, family=family, cfg=cfg, params=params,
        text_field=config.get("text_field", DEFAULT_BINARY_VALUE_FIELD),
        tokenizer=build_tokenizer(config.get("tokenizer"), vocab_size=cfg.vocab_size),
        max_input=max_input,
        max_new_tokens=max_new, output_field=str(config.get("output_field", "generated")),
        buckets=buckets, generator=generator, seed=seed,
        host_params=host if keep_host else None)
    proc.swapper = build_generate_swapper(
        proc, model=str(model), swap_cfg=parse_swap_config(config.get("swap"), who="gpu_generate"),
        checkpoint=ckpt)
    proc.integrity = build_generate_integrity_monitor(
        proc, model=str(model),
        cfg=parse_integrity_config(config.get("integrity"), who="gpu_generate"))
    if proc.integrity is not None:
        # probing quiesces across a swap, and a commit rebuilds the reference
        proc.swapper.integrity = proc.integrity
    return proc
