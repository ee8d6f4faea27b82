import arkflow_tpu_torch.plugins.output.drop  # noqa: F401
import arkflow_tpu_torch.plugins.output.http  # noqa: F401
import arkflow_tpu_torch.plugins.output.influxdb  # noqa: F401
import arkflow_tpu_torch.plugins.output.kafka  # noqa: F401
import arkflow_tpu_torch.plugins.output.mqtt  # noqa: F401
import arkflow_tpu_torch.plugins.output.nats  # noqa: F401
import arkflow_tpu_torch.plugins.output.redis  # noqa: F401
import arkflow_tpu_torch.plugins.output.stdout  # noqa: F401
