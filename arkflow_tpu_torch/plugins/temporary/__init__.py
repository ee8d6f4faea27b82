import arkflow_tpu_torch.plugins.temporary.memory  # noqa: F401
import arkflow_tpu_torch.plugins.temporary.redis  # noqa: F401
