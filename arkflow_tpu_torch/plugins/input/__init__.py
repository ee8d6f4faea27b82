import arkflow_tpu_torch.plugins.input.generate  # noqa: F401
import arkflow_tpu_torch.plugins.input.memory  # noqa: F401
