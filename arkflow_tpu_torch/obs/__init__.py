from arkflow_tpu_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    global_registry,
)
from arkflow_tpu_torch.obs.trace import (  # noqa: F401
    Span,
    TraceContext,
    Tracer,
    TracingConfig,
    activate,
    global_tracer,
    record_stage,
    stage_span,
)
