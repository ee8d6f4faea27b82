import arkflow_tpu_torch.plugins.processor.batch_proc  # noqa: F401
import arkflow_tpu_torch.plugins.processor.gpu_generate  # noqa: F401
import arkflow_tpu_torch.plugins.processor.gpu_inference  # noqa: F401
import arkflow_tpu_torch.plugins.processor.json_proc  # noqa: F401
import arkflow_tpu_torch.plugins.processor.protobuf_proc  # noqa: F401
import arkflow_tpu_torch.plugins.processor.remap  # noqa: F401
import arkflow_tpu_torch.plugins.processor.sql  # noqa: F401
