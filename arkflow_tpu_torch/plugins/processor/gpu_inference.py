"""``gpu_inference`` processor: streaming model inference on the GPU.

Counterpart of ``arkflow_tpu/plugins/processor/tpu_inference.py`` on its
unpacked path: tokenize the payload column, bucket and pad the batch, run the
model on the device, and attach the outputs as columns. Config (the keys of
``tpu_inference`` the port carries, plus ``device``):

    type: gpu_inference
    model: bert_classifier
    model_config: {num_labels: 2}
    text_field: __value__          # payload column to tokenize
    max_seq: 256
    batch_buckets: [16, 64]        # default pow2 grid up to max_batch
    seq_buckets: [64, 128, 256]    # default pow2 grid up to max_seq
    max_batch: 256
    outputs: [label, score]        # default: all rank-1 outputs
    warmup: true                   # one step per bucket at connect
    seed: 0                        # weights drawn from torch.Generator(seed)
    serving_dtype: bfloat16        # float32 | bfloat16 | float16
    max_in_flight: 2               # device steps in flight
    device: cuda                   # default cuda; cpu for tests

Every other ``tpu_inference`` key (tokenizer, tensor_field, mesh,
device_pool, packing, response_cache, swap, tuner, integrity, checkpoint,
dispatch_depth, step deadlines, health, ...) raises "not yet ported".
"""

from __future__ import annotations

import asyncio
from typing import Optional

import numpy as np

from arkflow_tpu_torch.batch import DEFAULT_BINARY_VALUE_FIELD, BinaryColumn, MessageBatch
from arkflow_tpu_torch.components import Processor, Resource, register_processor
from arkflow_tpu_torch.errors import ConfigError, ProcessError, not_ported
from arkflow_tpu_torch.tpu.bucketing import BucketPolicy
from arkflow_tpu_torch.tpu.runner import ModelRunner, check_serving_dtype
from arkflow_tpu_torch.tpu.tokenizer import HashTokenizer

KEYS = ("model", "model_config", "text_field", "max_seq", "batch_buckets",
        "seq_buckets", "max_batch", "outputs", "warmup", "seed", "serving_dtype",
        "max_in_flight", "device")


class GpuInferenceProcessor(Processor):
    def __init__(self, runner: ModelRunner, *, text_field: str, tokenizer, max_seq: int,
                 outputs: Optional[list[str]], warmup: bool = False):
        self.runner = runner
        self.text_field = text_field
        self.tokenizer = tokenizer
        self.max_seq = max_seq
        self.outputs = outputs
        self._warmed = not warmup

    # -- input extraction --------------------------------------------------

    def _extract(self, batch: MessageBatch) -> dict[str, np.ndarray]:
        """Tokenize the payload column off its buffer view, and cut the ids
        to the seq bucket of the longest row."""
        col = batch.column(self.text_field)
        if not isinstance(col, BinaryColumn):
            raise ProcessError(f"gpu_inference: column {self.text_field!r} is not a binary column")
        ids, mask = self.tokenizer.encode_batch_view(col.values, col.offsets, self.max_seq)
        used = int(mask.sum(axis=1).max()) if mask.size else 1
        sb = self.runner.buckets.seq_bucket(used)
        return {"input_ids": ids[:, :sb], "attention_mask": mask[:, :sb]}

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
        """Run one step per bucket before the input starts producing."""
        if not self._warmed:
            self._warmed = True
            await asyncio.get_running_loop().run_in_executor(None, self.runner.warmup)

    async def process(self, batch: MessageBatch) -> list[MessageBatch]:
        if batch.num_rows == 0:
            return []
        if not self._warmed:  # direct use without a stream (tests, tools)
            await self.connect()
        inputs = await asyncio.get_running_loop().run_in_executor(None, self._extract, batch)
        outputs = await self.runner.infer(inputs)
        return [self._attach(batch, outputs)]


def _check(config: dict) -> None:
    check_serving_dtype(config.get("serving_dtype"))


@register_processor("gpu_inference", keys=KEYS, check=_check)
def _build(config: dict, resource: Resource) -> GpuInferenceProcessor:
    model = config.get("model")
    if not model:
        raise ConfigError("gpu_inference requires 'model'")
    max_seq = int(config.get("max_seq", 128))
    buckets = BucketPolicy.from_config(config, max_seq=max_seq,
                                       max_batch=int(config.get("max_batch", 256)))
    runner = ModelRunner(
        model, config.get("model_config"),
        buckets=buckets,
        seed=int(config.get("seed", 0)),
        device=config.get("device"),
        serving_dtype=config.get("serving_dtype"),
        max_in_flight=int(config.get("max_in_flight", 2)),
    )
    if "input_ids" not in runner.spec:
        raise not_ported(f"gpu_inference for the tensor inputs of model {model!r}")
    return GpuInferenceProcessor(
        runner,
        text_field=config.get("text_field", DEFAULT_BINARY_VALUE_FIELD),
        tokenizer=HashTokenizer(getattr(runner.cfg, "vocab_size", 30522)),
        max_seq=max_seq,
        outputs=config.get("outputs"),
        warmup=bool(config.get("warmup", False)),
    )
