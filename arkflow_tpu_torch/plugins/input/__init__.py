import arkflow_tpu_torch.plugins.input.generate  # noqa: F401
