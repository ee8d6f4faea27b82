"""Model registry: name -> ModelFamily (init/apply/signature metadata).

Counterpart of ``arkflow_tpu/models/registry.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from arkflow_tpu_torch.errors import ConfigError


@dataclass
class ModelFamily:
    """A streaming-servable model family.

    - ``make_config(**overrides)``: build the family's config dataclass.
    - ``init(gen, cfg)``: params tree from a ``torch.Generator``, on the CPU.
    - ``apply(params, cfg, **inputs)``: forward; returns a dict of outputs.
    - ``input_spec(cfg)``: dict input_name -> ("int32"|"float32", trailing
      shape) describing per-example features (leading batch dim implied); the
      runner uses it for bucketing/padding.
    """

    name: str
    make_config: Callable[..., Any]
    init: Callable[..., Any]
    apply: Callable[..., dict]
    input_spec: Callable[[Any], dict]
    extras: dict = field(default_factory=dict)


_REGISTRY: dict[str, ModelFamily] = {}


def register_model(family: ModelFamily) -> ModelFamily:
    if family.name in _REGISTRY:
        raise ConfigError(f"model family {family.name!r} already registered")
    _REGISTRY[family.name] = family
    return family


def get_model(name: str) -> ModelFamily:
    fam = _REGISTRY.get(name)
    if fam is None:
        raise ConfigError(f"unknown model family {name!r} (available: {sorted(_REGISTRY)})")
    return fam


def list_models() -> list[str]:
    return sorted(_REGISTRY)
