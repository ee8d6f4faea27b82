"""ArkFlow on PyTorch and CUDA: the port of ``arkflow_tpu`` to an NVIDIA H100.

The JAX package ``arkflow_tpu`` stays the reference; this package mirrors its
module paths and imports nothing from it (and nothing of JAX). Ported so far,
both shapes of the flagship stream:

    generate -> gpu_inference(bert_classifier, bf16) -> drop | stdout
    generate -> memory buffer (token budget) -> gpu_inference(packing) -> drop

Layer map:

- ``arkflow_tpu_torch.batch``       data plane (numpy columns, Arrow binary layout)
- ``arkflow_tpu_torch.components``  component traits + registries
- ``arkflow_tpu_torch.runtime``     stream runtime / pipeline / engine / CLI
- ``arkflow_tpu_torch.config``      typed config (JSON/TOML, YAML when available)
- ``arkflow_tpu_torch.plugins``     generate input, memory buffer, drop/stdout outputs,
                                    gpu_inference
- ``arkflow_tpu_torch.tpu``         bucketing and coalescing, tokenizer, packing,
                                    model runner
- ``arkflow_tpu_torch.models``      model families (bert_classifier)
- ``arkflow_tpu_torch.ops``         hand-written CUDA kernels (``csrc/``) + plain versions
- ``arkflow_tpu_torch.convert``     param trees from the JAX package's layout
"""

__version__ = "0.1.0"
