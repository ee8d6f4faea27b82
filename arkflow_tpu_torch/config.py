"""Engine configuration: one file, format by extension.

Counterpart of ``arkflow_tpu/config.py`` for the keys the port carries.
JSON and TOML parse with the standard library; YAML only when the ``yaml``
module imports (otherwise a ``ConfigError`` names the missing module).
Component configs stay raw ``{"type": ..., **payload}`` mappings for the
builder registry, which checks their keys. The delivery keys the stream
consumes are taken out of them first, as the JAX package takes them:
``input.reconnect`` (the reconnect schedule after a ``Disconnection``) and
``retry`` / ``circuit_breaker`` on ``output`` and ``error_output``. The
control plane parses as JAX's does: the pipeline's ``queue_size``,
``deadline_ms``, ``priority`` and ``overload`` (``runtime/overload.py``),
the stream's ``restart`` policy, and ``gpu_inference.response_cache``
(``runtime/respcache.py``) through ``type: fault`` wrappers. The stream's
``temporary`` list names the lookup tables the ``sql`` processor's
bindings read; ``--validate`` checks each against the ``temporary``
registry. Every key the JAX package reads and the port does not carry yet
(the pipeline's ``process_pool`` and ``ingest_shards``) raises
``ConfigError(... not yet ported ...)``.
"""

from __future__ import annotations

import json
import os
import tomllib
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Mapping, Optional

from arkflow_tpu_torch.errors import ConfigError, not_ported

#: ``description`` is free text for the reader; the engine ignores it
_ENGINE_KEYS = ("streams", "logging", "health_check", "tracing", "description")
_HEALTH_KEYS = ("enabled", "host", "port", "path", "profiling_dir")
_STREAM_KEYS = ("input", "buffer", "pipeline", "output", "error_output", "name",
                "restart", "temporary")
_PIPELINE_KEYS = ("thread_num", "processors", "max_delivery_attempts", "queue_size",
                  "deadline_ms", "priority", "overload")


def _check_keys(m: Mapping[str, Any], allowed: tuple[str, ...], where: str) -> None:
    for key in m:
        if key not in allowed:
            raise not_ported(f"{where}.{key}")


def _unwrap_fault(p: Any) -> Any:
    """A processor config seen through ``type: fault`` wrappers' ``inner``."""
    while isinstance(p, Mapping) and p.get("type") == "fault" \
            and isinstance(p.get("inner"), Mapping):
        p = p["inner"]
    return p


def _validate_token_coalesce(buffer_cfg: Any, processors: list[dict]) -> None:
    """Cross-component check of the packed path: a buffer carving
    token-budget emissions only makes sense feeding a ``gpu_inference``
    processor with ``packing: true`` (token-sized emissions fill a (rows,
    seq) shape only after ``pack_tokens``; an unpacked runner would pad
    their row counts straight back). The component builders cannot see across
    sections, so this runs at parse time."""
    packing_vals = []
    for p in map(_unwrap_fault, processors):
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


def _validate_response_cache(processors: list[dict]) -> None:
    """Parse every ``gpu_inference`` processor's ``response_cache`` at parse
    time (``--validate``), through ``type: fault`` wrappers, without
    minting a cache or its metric series."""
    from arkflow_tpu_torch.runtime.respcache import parse_response_cache_config

    for p in map(_unwrap_fault, processors):
        if isinstance(p, Mapping) and p.get("type") == "gpu_inference" \
                and p.get("response_cache") is not None:
            parse_response_cache_config(p["response_cache"])


def _restart_config(m: Any) -> Optional[dict]:
    """The stream's ``restart`` policy, as the JAX package parses it:
    ``{max_retries: 3, backoff: 5s, reset_after: 5m}`` by default; None or
    false keeps a crashed stream ended."""
    if m is None or m is False:
        return None  # `restart: {}` means "defaults", not "disabled"
    if not isinstance(m, Mapping):
        raise ConfigError("stream 'restart' must be a mapping")
    from arkflow_tpu_torch.utils.duration import parse_duration

    try:
        out = {
            "max_retries": int(m.get("max_retries", 3)),
            "backoff_s": parse_duration(str(m.get("backoff", "5s"))),
            # a run at least this long restores the whole retry budget
            "reset_after_s": parse_duration(str(m.get("reset_after", "5m"))),
        }
    except (TypeError, ValueError) as e:
        raise ConfigError(f"stream 'restart' values invalid: {e}") from e
    if out["max_retries"] < 0 or out["backoff_s"] < 0 or out["reset_after_s"] < 0:
        raise ConfigError("stream restart values must be non-negative")
    return out


def _validate_tuner(processors: list[dict]) -> None:
    """Parse every ``gpu_inference`` processor's ``tuner`` block at parse
    time (``--validate``), through ``type: fault`` wrappers' ``inner``
    chains, as the JAX package's ``_validate_tuner`` does: a bad knob fails
    before any stream is built. The port has no mesh, so JAX's pp refusal
    has nothing to refuse."""
    from arkflow_tpu_torch.tpu.tuner import parse_tuner_config

    for p in map(_unwrap_fault, processors):
        if isinstance(p, Mapping) and p.get("type") == "gpu_inference" \
                and p.get("tuner") is not None:
            parse_tuner_config(p["tuner"], who="gpu_inference")


@dataclass
class PipelineConfig:
    thread_num: int = 0  # 0 -> cpu count
    processors: list[dict] = field(default_factory=list)
    #: deliveries of a failing batch before it is given up on (acked and
    #: counted); below it a batch from a redelivering source is nacked
    max_delivery_attempts: int = 1
    #: worker-queue depth; 0 keeps ``thread_num * 4``
    queue_size: int = 0
    #: per-batch latency budget in ms from the ingest stamp (an absolute
    #: ``__meta_ext_deadline_ms`` overrides it); turns admission on
    deadline_ms: Optional[float] = None
    #: default admission band of a batch without ``__meta_ext_priority``
    priority: int = 0
    #: the parsed ``overload`` block (``OverloadConfig``), None when
    #: overload control is off
    overload: Optional[Any] = None

    @classmethod
    def from_mapping(cls, m: Mapping[str, Any]) -> "PipelineConfig":
        from arkflow_tpu_torch.runtime.overload import OverloadConfig

        if not isinstance(m, Mapping):
            raise ConfigError("pipeline config must be a mapping")
        _check_keys(m, _PIPELINE_KEYS, "pipeline")
        threads = m.get("thread_num", 0)
        if isinstance(threads, bool) or not isinstance(threads, int) or threads < 0:
            raise ConfigError(f"pipeline.thread_num must be a non-negative int, got {threads!r}")
        procs = m.get("processors", [])
        if not isinstance(procs, list):
            raise ConfigError("pipeline.processors must be a list")
        attempts = m.get("max_delivery_attempts", 1)
        if isinstance(attempts, bool) or not isinstance(attempts, int) or attempts < 1:
            raise ConfigError(
                f"pipeline.max_delivery_attempts must be an int >= 1, got {attempts!r}")
        qsize = m.get("queue_size", 0)
        if not isinstance(qsize, int) or isinstance(qsize, bool) or qsize < 0:
            raise ConfigError(
                f"pipeline.queue_size must be a non-negative int, got {qsize!r}")
        deadline = m.get("deadline_ms")
        if deadline is not None:
            if isinstance(deadline, bool) or not isinstance(deadline, (int, float)) \
                    or deadline <= 0:
                raise ConfigError(
                    f"pipeline.deadline_ms must be a positive number, got {deadline!r}")
            deadline = float(deadline)
        priority = m.get("priority", 0)
        if not isinstance(priority, int) or isinstance(priority, bool):
            raise ConfigError(f"pipeline.priority must be an int, got {priority!r}")
        overload = OverloadConfig.from_config(
            m.get("overload"), deadline_ms=deadline, priority=priority)
        return cls(thread_num=threads, processors=[dict(p) for p in procs],
                   max_delivery_attempts=attempts, queue_size=qsize,
                   deadline_ms=deadline, priority=priority, overload=overload)

    def effective_threads(self) -> int:
        return self.thread_num if self.thread_num > 0 else (os.cpu_count() or 1)

    def effective_queue_size(self) -> int:
        """The worker-queue depth: ``queue_size``, or ``thread_num * 4``."""
        return self.queue_size if self.queue_size > 0 else self.effective_threads() * 4


def _sink_delivery(cfg: dict, where: str) -> tuple[Any, Any]:
    """Take ``retry`` and ``circuit_breaker`` out of an output config and
    parse them as the JAX package does (an empty ``retry`` keeps the
    defaults, a missing or false ``circuit_breaker`` disables it)."""
    from arkflow_tpu_torch.utils.circuit_breaker import CircuitBreakerConfig
    from arkflow_tpu_torch.utils.retry import RetryConfig

    if not isinstance(cfg.get("retry", {}) or {}, Mapping):
        raise ConfigError(f"{where}.retry must be a mapping")
    retry = cfg.pop("retry", None)
    breaker = CircuitBreakerConfig.from_config(cfg.pop("circuit_breaker", None))
    return (RetryConfig.from_config(retry) if retry else None), breaker


@dataclass
class TemporaryConfig:
    name: str
    config: dict

    @classmethod
    def from_mapping(cls, m: Mapping[str, Any]) -> "TemporaryConfig":
        m = dict(m)
        name = m.pop("name", None)
        if not name:
            raise ConfigError("temporary config requires a 'name'")
        return cls(name=name, config=m)


@dataclass
class StreamConfig:
    input: dict
    pipeline: PipelineConfig
    output: dict
    #: where a batch goes once its delivery attempts are spent, tagged with
    #: ``__meta_ext_error`` and ``__meta_ext_delivery_attempts``; None acks
    #: and counts it in ``Stream.dropped_batches``
    error_output: Optional[dict] = None
    buffer: Optional[dict] = None
    #: the stream's lookup tables, built before its input and processors
    temporary: list[TemporaryConfig] = field(default_factory=list)
    name: Optional[str] = None
    #: retry schedule of ``output.write`` (``output.retry``); None: the
    #: ``RetryConfig`` defaults
    output_retry: Optional[Any] = None
    #: circuit breaker over ``output.write`` (``output.circuit_breaker``);
    #: None: no breaker
    output_circuit_breaker: Optional[Any] = None
    error_output_retry: Optional[Any] = None
    error_output_circuit_breaker: Optional[Any] = None
    #: the reconnect schedule after an input ``Disconnection``
    #: (``input.reconnect``); None: 100 ms doubling to the stream's cap
    input_reconnect: Optional[Any] = None
    #: the crash policy ``{max_retries, backoff_s, reset_after_s}``: the
    #: engine rebuilds a crashed stream from this config and runs it again;
    #: None: a crashed stream ends
    restart: Optional[dict] = None

    @classmethod
    def from_mapping(cls, m: Mapping[str, Any]) -> "StreamConfig":
        from arkflow_tpu_torch.utils.retry import RetryConfig

        if not isinstance(m, Mapping):
            raise ConfigError("stream config must be a mapping")
        _check_keys(m, _STREAM_KEYS, "stream")
        for req in ("input", "output"):
            if req not in m:
                raise ConfigError(f"stream config missing required section {req!r}")
        pipeline = PipelineConfig.from_mapping(m.get("pipeline", {}))
        _validate_token_coalesce(m.get("buffer"), pipeline.processors)
        _validate_response_cache(pipeline.processors)
        _validate_tuner(pipeline.processors)
        temps = [TemporaryConfig.from_mapping(t) for t in m.get("temporary", [])]
        input_cfg = dict(m["input"])
        reconnect = input_cfg.pop("reconnect", None)
        if reconnect is not None and not isinstance(reconnect, Mapping):
            raise ConfigError("input.reconnect must be a mapping")
        output_cfg = dict(m["output"])
        out_retry, out_breaker = _sink_delivery(output_cfg, "output")
        err_cfg = dict(m["error_output"]) if m.get("error_output") else None
        err_retry = err_breaker = None
        if err_cfg is not None:
            err_retry, err_breaker = _sink_delivery(err_cfg, "error_output")
        return cls(input=input_cfg, pipeline=pipeline, output=output_cfg,
                   error_output=err_cfg,
                   buffer=dict(m["buffer"]) if m.get("buffer") else None,
                   temporary=temps, name=m.get("name"),
                   output_retry=out_retry, output_circuit_breaker=out_breaker,
                   error_output_retry=err_retry, error_output_circuit_breaker=err_breaker,
                   input_reconnect=RetryConfig.from_config(reconnect) if reconnect else None,
                   restart=_restart_config(m.get("restart")))


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
class HealthCheckConfig:
    """The engine's health server (``runtime/engine.py``). Off unless
    ``enabled: true``: the JAX package starts it by default, the port only
    when asked."""

    enabled: bool = False
    host: str = "0.0.0.0"
    port: int = 8080
    path: str = "/health"
    #: directory for ``POST /debug/profile`` captures; the route exists
    #: only when it is set (a capture adds device overhead and writes disk)
    profiling_dir: Optional[str] = None

    @classmethod
    def from_mapping(cls, m: Any) -> "HealthCheckConfig":
        if not isinstance(m, Mapping):
            raise ConfigError(f"health_check must be a mapping, got {m!r}")
        _check_keys(m, _HEALTH_KEYS, "health_check")
        c = cls()
        c.enabled = bool(m.get("enabled", c.enabled))
        c.host = str(m.get("host", c.host))
        try:
            c.port = int(m.get("port", c.port))
        except (TypeError, ValueError):
            raise ConfigError(f"health_check.port must be an int, got {m.get('port')!r}") from None
        c.path = str(m.get("path", c.path))
        if not c.path.startswith("/"):
            raise ConfigError(f"health_check.path must start with '/', got {c.path!r}")
        c.profiling_dir = m.get("profiling_dir")
        return c


@dataclass
class EngineConfig:
    streams: list[StreamConfig]
    logging: LoggingConfig = field(default_factory=LoggingConfig)
    health_check: HealthCheckConfig = field(default_factory=HealthCheckConfig)
    #: the ``tracing`` block (``obs/trace.py`` ``TracingConfig``): head
    #: sampling and the bounds of the trace store; the engine applies it to
    #: the process-global tracer at start
    tracing: Optional[Any] = None

    @classmethod
    def from_mapping(cls, m: Mapping[str, Any]) -> "EngineConfig":
        from arkflow_tpu_torch.obs.trace import TracingConfig

        if not isinstance(m, Mapping):
            raise ConfigError("engine config must be a mapping")
        _check_keys(m, _ENGINE_KEYS, "engine")
        health = HealthCheckConfig.from_mapping(m.get("health_check") or {})
        raw_streams = m.get("streams")
        if not raw_streams or not isinstance(raw_streams, list):
            raise ConfigError("engine config requires a non-empty 'streams' list")
        return cls(streams=[StreamConfig.from_mapping(s) for s in raw_streams],
                   logging=LoggingConfig.from_mapping(m.get("logging", {}) or {}),
                   health_check=health,
                   tracing=TracingConfig.from_mapping(m.get("tracing")))

    def validate_components(self) -> list[str]:
        """Check every component's type tag and keys against the registries.
        Returns human-readable problems; empty = OK."""
        from arkflow_tpu_torch.components.registry import check_component, ensure_plugins_loaded

        ensure_plugins_loaded()
        problems: list[str] = []
        for i, s in enumerate(self.streams):
            for family, c in (("input", s.input), ("output", s.output),
                              *((("output", s.error_output),) if s.error_output else ()),
                              *((("buffer", s.buffer),) if s.buffer else ()),
                              *(("processor", p) for p in s.pipeline.processors),
                              *(("temporary", t.config) for t in s.temporary)):
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
