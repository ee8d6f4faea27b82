"""CLI: ``python -m arkflow_tpu_torch --config stream.json [--validate]``.

Counterpart of the engine mode of ``arkflow_tpu/runtime/cli.py``: parse the
config, optionally only validate it, set up logging from its ``logging``
section and run the engine until its streams end.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import sys
import time
from typing import Optional, Sequence

from arkflow_tpu_torch.config import EngineConfig, LoggingConfig
from arkflow_tpu_torch.errors import ConfigError

_LEVELS = {
    "trace": logging.DEBUG,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        body = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(record.created)),
            "level": record.levelname.lower(),
            "target": record.name,
            "message": record.getMessage(),
        }
        if record.exc_info:
            body["exception"] = self.formatException(record.exc_info)
        return json.dumps(body)


def init_logging(cfg: LoggingConfig) -> None:
    root = logging.getLogger()
    root.setLevel(_LEVELS.get(cfg.level, logging.INFO))
    root.handlers.clear()
    handler: logging.Handler = (logging.FileHandler(cfg.file_path) if cfg.file_path
                                else logging.StreamHandler(sys.stderr))
    if cfg.format == "json":
        handler.setFormatter(_JsonFormatter())
    else:
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)-5s %(name)s: %(message)s", "%H:%M:%S"))
    root.addHandler(handler)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="arkflow-tpu-torch",
        description="streaming dataflow engine, PyTorch/CUDA port")
    parser.add_argument("-c", "--config", required=True, help="path to a JSON/TOML/YAML config")
    parser.add_argument("-v", "--validate", action="store_true",
                        help="validate the config and exit")
    args = parser.parse_args(argv)

    try:
        cfg = EngineConfig.from_file(args.config)
    except ConfigError as e:
        print(f"config error: {e}", file=sys.stderr)
        return 2

    if args.validate:
        problems = cfg.validate_components()
        if problems:
            print("\n".join(problems), file=sys.stderr)
            return 2
        print(f"config OK: {len(cfg.streams)} stream(s)")
        return 0

    init_logging(cfg.logging)
    from arkflow_tpu_torch.runtime.engine import Engine

    try:
        asyncio.run(Engine(cfg).run())
    except KeyboardInterrupt:
        pass
    except ConfigError as e:  # component build errors surface cleanly
        print(f"config error: {e}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
