"""Engine: builds and runs every stream of a config.

Counterpart of ``arkflow_tpu/runtime/engine.py`` without the health/metrics
server and without restart policies: build every stream, run them
concurrently, and let SIGINT/SIGTERM flip a cancellation event that drains
them. A crashed stream is logged without taking the engine down.
"""

from __future__ import annotations

import asyncio
import logging
import signal

from arkflow_tpu_torch.components.registry import ensure_plugins_loaded
from arkflow_tpu_torch.config import EngineConfig
from arkflow_tpu_torch.runtime.stream import Stream, build_stream

logger = logging.getLogger("arkflow_torch.engine")


class Engine:
    def __init__(self, config: EngineConfig):
        self.config = config
        self.cancel = asyncio.Event()
        self.streams: list[Stream] = []

    def _install_signal_handlers(self) -> None:
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                loop.add_signal_handler(sig, self.cancel.set)
            except (NotImplementedError, RuntimeError):  # non-main thread / platform
                pass

    def build(self) -> list[Stream]:
        """Build every stream of the config (``run`` does it when not done)."""
        ensure_plugins_loaded()
        self.streams = [build_stream(s, name=s.name or f"stream-{i}")
                        for i, s in enumerate(self.config.streams)]
        return self.streams

    async def run(self) -> None:
        if not self.streams:
            self.build()
        self._install_signal_handlers()

        async def run_one(stream: Stream) -> None:
            try:
                await stream.run(self.cancel)
                logger.info("[%s] finished", stream.name)
            except Exception:
                logger.exception("[%s] stream crashed", stream.name)

        await asyncio.gather(*(run_one(s) for s in self.streams))

    def shutdown(self) -> None:
        self.cancel.set()
