"""Concrete components of the port. Importing this package registers every
builder."""

import arkflow_tpu_torch.plugins.buffer  # noqa: F401
import arkflow_tpu_torch.plugins.codec  # noqa: F401
import arkflow_tpu_torch.plugins.input  # noqa: F401
import arkflow_tpu_torch.plugins.output  # noqa: F401
import arkflow_tpu_torch.plugins.processor  # noqa: F401
import arkflow_tpu_torch.plugins.fault  # noqa: F401
import arkflow_tpu_torch.plugins.temporary  # noqa: F401
