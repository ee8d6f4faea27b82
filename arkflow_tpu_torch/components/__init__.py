from arkflow_tpu_torch.components.base import (  # noqa: F401
    Ack,
    Input,
    NoopAck,
    Output,
    Processor,
    Resource,
)
from arkflow_tpu_torch.components.registry import (  # noqa: F401
    build_component,
    check_component,
    ensure_plugins_loaded,
    register_input,
    register_output,
    register_processor,
    registered_types,
)
