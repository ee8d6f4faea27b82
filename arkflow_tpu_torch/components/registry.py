"""Builder registries: ``type``-tagged component construction.

Counterpart of ``arkflow_tpu/components/registry.py``. A builder is a
callable ``(config: dict, resource: Resource) -> component``, registered with
a decorator so plugin modules self-register on import. Each registration
also names the config keys the port carries for that type: any other key
raises ``ConfigError(... not yet ported ...)`` at ``--validate`` and at build,
so no key the JAX package reads is ever silently ignored. A builder may add
a ``check(config)`` that validates values at the same two points.

    @register_input("generate", keys=("payload", "batch_size"))
    def _build(config, resource): return GenerateInput(...)
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Mapping, Optional

from arkflow_tpu_torch.components.base import Resource
from arkflow_tpu_torch.errors import ConfigError, not_ported

Builder = Callable[[dict, Resource], Any]

Check = Callable[[dict], None]

_REGISTRIES: dict[str, dict[str, tuple[Builder, frozenset, Optional[Check]]]] = {
    "input": {},
    "output": {},
    "processor": {},
    "buffer": {},
    "codec": {},
    "temporary": {},
}


def _register(family: str, type_name: str, keys: Iterable[str],
              check: Optional[Check] = None) -> Callable[[Builder], Builder]:
    def deco(builder: Builder) -> Builder:
        reg = _REGISTRIES[family]
        if type_name in reg:
            raise ConfigError(f"{family} builder {type_name!r} already registered")
        reg[type_name] = (builder, frozenset(keys), check)
        return builder

    return deco


def register_input(type_name: str, keys: Iterable[str] = (),
                   check: Optional[Check] = None):
    return _register("input", type_name, keys, check)


def register_output(type_name: str, keys: Iterable[str] = (),
                    check: Optional[Check] = None):
    return _register("output", type_name, keys, check)


def register_processor(type_name: str, keys: Iterable[str] = (),
                       check: Optional[Check] = None):
    return _register("processor", type_name, keys, check)


def register_buffer(type_name: str, keys: Iterable[str] = (),
                    check: Optional[Check] = None):
    return _register("buffer", type_name, keys, check)


def register_codec(type_name: str, keys: Iterable[str] = (),
                   check: Optional[Check] = None):
    return _register("codec", type_name, keys, check)


def register_temporary(type_name: str, keys: Iterable[str] = (),
                       check: Optional[Check] = None):
    return _register("temporary", type_name, keys, check)


def registered_types(family: str) -> list[str]:
    return sorted(_REGISTRIES[family])


def _resolve(family: str, config: Mapping[str, Any]) -> tuple[Builder, dict]:
    """Look up the builder of a ``{"type": ..., **payload}`` config and check
    its keys and values; returns the builder and the payload."""
    if family not in _REGISTRIES:
        raise ConfigError(f"unknown component family {family!r}")
    if not isinstance(config, Mapping):
        raise ConfigError(f"{family} config must be a mapping, got {type(config).__name__}")
    cfg = dict(config)
    type_name = cfg.pop("type", None)
    if not type_name:
        raise ConfigError(f"{family} config missing 'type' tag: {config!r}")
    entry = _REGISTRIES[family].get(type_name)
    if entry is None:
        known = ", ".join(registered_types(family)) or "<none>"
        raise ConfigError(f"unknown {family} type {type_name!r} (registered: {known})")
    builder, keys, check = entry
    for key in cfg:
        if key not in keys:
            raise not_ported(f"{family} {type_name!r} key {key!r}")
    if check is not None:
        check(cfg)
    return builder, cfg


def check_component(family: str, config: Mapping[str, Any]) -> None:
    """Validate a component config (type tag, keys, values) without building it."""
    _resolve(family, config)


def build_component(family: str, config: Mapping[str, Any], resource: Resource) -> Any:
    """Instantiate a component from its ``{"type": ..., **payload}`` config."""
    builder, cfg = _resolve(family, config)
    return builder(cfg, resource)


def ensure_plugins_loaded() -> None:
    """Import the plugin tree so all builders self-register."""
    import arkflow_tpu_torch.plugins  # noqa: F401
