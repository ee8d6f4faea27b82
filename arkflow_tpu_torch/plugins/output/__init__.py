import arkflow_tpu_torch.plugins.output.drop  # noqa: F401
import arkflow_tpu_torch.plugins.output.stdout  # noqa: F401
