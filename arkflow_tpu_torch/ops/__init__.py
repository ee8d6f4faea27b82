"""Hand-written CUDA kernels of the port, each beside its plain version."""

from arkflow_tpu_torch.ops.flash_attention import (  # noqa: F401
    flash_attention,
    flash_attention_reference,
)
from arkflow_tpu_torch.ops.ragged_attention import (  # noqa: F401
    paged_attention_reference,
    paged_flash_attention,
    ragged_attention_reference,
    ragged_flash_attention,
)
from arkflow_tpu_torch.ops.segment_attention import (  # noqa: F401
    segment_attention_reference,
    segment_flash_attention,
)
