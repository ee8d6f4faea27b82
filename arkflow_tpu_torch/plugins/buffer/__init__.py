import arkflow_tpu_torch.plugins.buffer.memory  # noqa: F401
