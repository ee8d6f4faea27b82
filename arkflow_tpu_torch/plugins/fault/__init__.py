"""Fault injection for chaos runs (``type: fault``): deterministic schedules
and the input, output and processor wrappers."""

import arkflow_tpu_torch.plugins.fault.wrappers  # noqa: F401
