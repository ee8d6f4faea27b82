from arkflow_tpu_torch.components.base import (  # noqa: F401
    Ack,
    Buffer,
    FnAck,
    Input,
    NoopAck,
    Output,
    Processor,
    Resource,
    VecAck,
    split_ack,
)
from arkflow_tpu_torch.components.registry import (  # noqa: F401
    build_component,
    check_component,
    ensure_plugins_loaded,
    register_buffer,
    register_input,
    register_output,
    register_processor,
    registered_types,
)
