import arkflow_tpu_torch.plugins.input.generate  # noqa: F401
import arkflow_tpu_torch.plugins.input.http  # noqa: F401
import arkflow_tpu_torch.plugins.input.kafka  # noqa: F401
import arkflow_tpu_torch.plugins.input.memory  # noqa: F401
import arkflow_tpu_torch.plugins.input.mqtt  # noqa: F401
