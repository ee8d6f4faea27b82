import arkflow_tpu_torch.plugins.buffer.memory  # noqa: F401
import arkflow_tpu_torch.plugins.buffer.window  # noqa: F401
