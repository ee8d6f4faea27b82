"""Engine configuration: one file, format by extension.

Counterpart of ``arkflow_tpu/config.py`` for the keys the port carries.
JSON and TOML parse with the standard library; YAML only when the ``yaml``
module imports (otherwise a ``ConfigError`` names the missing module).
Component configs stay raw ``{"type": ..., **payload}`` mappings for the
builder registry, which checks their keys. Every key the JAX package reads
and the port does not carry yet raises ``ConfigError(... not yet ported ...)``.
"""

from __future__ import annotations

import json
import os
import tomllib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Mapping, Optional

from arkflow_tpu_torch.errors import ConfigError, not_ported

_ENGINE_KEYS = ("streams", "logging", "health_check")
_STREAM_KEYS = ("input", "buffer", "pipeline", "output", "name")
_PIPELINE_KEYS = ("thread_num", "processors")


def _check_keys(m: Mapping[str, Any], allowed: tuple[str, ...], where: str) -> None:
    for key in m:
        if key not in allowed:
            raise not_ported(f"{where}.{key}")


def _validate_token_coalesce(buffer_cfg: Any, processors: list[dict]) -> None:
    """Cross-component check of the packed path: a buffer carving
    token-budget emissions only makes sense feeding a ``gpu_inference``
    processor with ``packing: true`` (token-sized emissions fill a (rows,
    seq) shape only after ``pack_tokens``; an unpacked runner would pad
    their row counts straight back). The component builders cannot see across
    sections, so this runs at parse time."""
    packing_vals = []
    for p in processors:
        if not isinstance(p, Mapping) or p.get("type") != "gpu_inference":
            continue
        packing = p.get("packing", False)
        if not isinstance(packing, bool):
            raise ConfigError(f"gpu_inference.packing must be a bool, got {packing!r}")
        packing_vals.append(packing)
    if not isinstance(buffer_cfg, Mapping):
        return
    coalesce = buffer_cfg.get("coalesce")
    if not isinstance(coalesce, Mapping):
        return
    token_budget = coalesce.get("token_budget")
    if token_budget is None:
        return
    if isinstance(token_budget, bool) or not isinstance(token_budget, int) or token_budget < 1:
        raise ConfigError(
            f"buffer.coalesce.token_budget must be a positive int, got {token_budget!r}")
    if packing_vals and not any(packing_vals):
        raise ConfigError(
            "buffer.coalesce.token_budget requires 'packing: true' on the stream's "
            "gpu_inference processor (token-budget emissions only fill the (rows, "
            "seq) shape after pack_tokens; set packing: true or drop token_budget)")


@dataclass
class PipelineConfig:
    thread_num: int = 0  # 0 -> cpu count
    processors: list[dict] = field(default_factory=list)

    @classmethod
    def from_mapping(cls, m: Mapping[str, Any]) -> "PipelineConfig":
        if not isinstance(m, Mapping):
            raise ConfigError("pipeline config must be a mapping")
        _check_keys(m, _PIPELINE_KEYS, "pipeline")
        threads = m.get("thread_num", 0)
        if isinstance(threads, bool) or not isinstance(threads, int) or threads < 0:
            raise ConfigError(f"pipeline.thread_num must be a non-negative int, got {threads!r}")
        procs = m.get("processors", [])
        if not isinstance(procs, list):
            raise ConfigError("pipeline.processors must be a list")
        return cls(thread_num=threads, processors=[dict(p) for p in procs])

    def effective_threads(self) -> int:
        return self.thread_num if self.thread_num > 0 else (os.cpu_count() or 1)


@dataclass
class StreamConfig:
    input: dict
    pipeline: PipelineConfig
    output: dict
    buffer: Optional[dict] = None
    name: Optional[str] = None

    @classmethod
    def from_mapping(cls, m: Mapping[str, Any]) -> "StreamConfig":
        if not isinstance(m, Mapping):
            raise ConfigError("stream config must be a mapping")
        _check_keys(m, _STREAM_KEYS, "stream")
        for req in ("input", "output"):
            if req not in m:
                raise ConfigError(f"stream config missing required section {req!r}")
        pipeline = PipelineConfig.from_mapping(m.get("pipeline", {}))
        _validate_token_coalesce(m.get("buffer"), pipeline.processors)
        return cls(input=dict(m["input"]), pipeline=pipeline, output=dict(m["output"]),
                   buffer=dict(m["buffer"]) if m.get("buffer") else None,
                   name=m.get("name"))


@dataclass
class LoggingConfig:
    level: str = "info"
    file_path: Optional[str] = None
    format: str = "plain"  # plain | json

    @classmethod
    def from_mapping(cls, m: Mapping[str, Any]) -> "LoggingConfig":
        c = cls()
        c.level = str(m.get("level", c.level)).lower()
        c.file_path = m.get("file_path") or m.get("file")
        c.format = str(m.get("format", c.format)).lower()
        if c.format not in ("plain", "json"):
            raise ConfigError(f"logging.format must be plain|json, got {c.format!r}")
        return c


@dataclass
class EngineConfig:
    streams: list[StreamConfig]
    logging: LoggingConfig = field(default_factory=LoggingConfig)

    @classmethod
    def from_mapping(cls, m: Mapping[str, Any]) -> "EngineConfig":
        if not isinstance(m, Mapping):
            raise ConfigError("engine config must be a mapping")
        _check_keys(m, _ENGINE_KEYS, "engine")
        health = m.get("health_check") or {}
        if not isinstance(health, Mapping) or health.get("enabled", False) is not False:
            # the port has no health/metrics server yet
            raise not_ported("health_check.enabled: true")
        raw_streams = m.get("streams")
        if not raw_streams or not isinstance(raw_streams, list):
            raise ConfigError("engine config requires a non-empty 'streams' list")
        return cls(streams=[StreamConfig.from_mapping(s) for s in raw_streams],
                   logging=LoggingConfig.from_mapping(m.get("logging", {}) or {}))

    def validate_components(self) -> list[str]:
        """Check every component's type tag and keys against the registries.
        Returns human-readable problems; empty = OK."""
        from arkflow_tpu_torch.components.registry import check_component, ensure_plugins_loaded

        ensure_plugins_loaded()
        problems: list[str] = []
        for i, s in enumerate(self.streams):
            for family, c in (("input", s.input), ("output", s.output),
                              *((("buffer", s.buffer),) if s.buffer else ()),
                              *(("processor", p) for p in s.pipeline.processors)):
                try:
                    check_component(family, c)
                except ConfigError as e:
                    problems.append(f"stream[{i}]: {e}")
        return problems

    @classmethod
    def from_file(cls, path: str | Path) -> "EngineConfig":
        p = Path(path)
        if not p.exists():
            raise ConfigError(f"config file not found: {p}")
        suffix = p.suffix.lower()
        text = p.read_text()
        if suffix == ".json":
            try:
                data = json.loads(text)
            except json.JSONDecodeError as e:
                raise ConfigError(f"failed to parse {p}: {e}") from e
        elif suffix == ".toml":
            try:
                data = tomllib.loads(text)
            except tomllib.TOMLDecodeError as e:
                raise ConfigError(f"failed to parse {p}: {e}") from e
        elif suffix in (".yaml", ".yml"):
            try:
                import yaml
            except ImportError as e:
                raise ConfigError(
                    f"{p}: YAML configs need the 'yaml' module, which does not "
                    "import here; use a .json or .toml config") from e
            try:
                data = yaml.safe_load(text)
            except yaml.YAMLError as e:
                raise ConfigError(f"failed to parse {p}: {e}") from e
        else:
            raise ConfigError(f"unsupported config extension {suffix!r} (use .json/.toml/.yaml)")
        return cls.from_mapping(data or {})
