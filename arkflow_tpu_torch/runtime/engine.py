"""Engine: builds and runs every stream of a config, with its health server.

Counterpart of ``arkflow_tpu/runtime/engine.py``: build every stream (its
``error_output`` with it; ``--validate`` checks that output's type and keys
too), run them concurrently, and let SIGINT/SIGTERM flip a cancellation
event that drains them. A crashed stream is logged without taking the
engine down. With a ``restart`` policy (``{max_retries, backoff,
reset_after}``) the engine supervises it as JAX's does: after a crash it
waits ``backoff`` (cancel-aware), builds a fresh stream from the config
(a failed build is retried, each attempt spending budget) and runs it in
the crashed one's place in ``streams``; a run of at least ``reset_after``
restores the whole budget. Before the rebuild the crashed stream's
processors free their device state (``Stream.release``), so a restart
keeps one model on the card. A fault's one-shot state lives in its config
dict and so carries over to the rebuilt stream.

With ``health_check: {enabled: true, host, port, path}`` the engine serves
HTTP/1.1 on the standard library's ``asyncio.start_server`` through the
port's request reader (``utils/http1.py``; the card's machine has no
aiohttp, and the port imports none). A connection stays open for the next
request when the request sends ``Connection: keep-alive``, and closes after
the response otherwise; a malformed request or a body past 1 MiB answers
400:

- ``GET <path>`` (default ``/health``): the status, the stream count, the
  tracer's one-line ``tracing`` summary and per stream its ``restarts`` and
  ``restart_budget_remaining`` (None without a policy), its overload
  controller's report (``overload``), its response caches' reports
  (``response_caches``), its runners' health reports, its hot-swap
  managers', integrity monitors' and shape tuners' reports, under the JAX
  package's keys (``runners``, ``swap``, ``integrity``, ``tuner``; a ``type:
  fault`` wrapper exposes its inner processor's ``runner``, ``swapper`` and
  ``integrity``, and tuners and caches are found through ``_inner``);
- ``GET /readiness``: 503 before the streams are built, and while every
  runner of some stream is DEAD or CORRUPT; 200 otherwise;
- ``GET /liveness``: 200;
- ``POST /admin/swap {"checkpoint": path, "stream"?: name}``: a hot swap on
  every swappable processor of the targeted streams, in turn; 200 when
  every swap committed, 409 when one rolled back, 404 when there was none
  to run, 400 for a malformed body.
- ``POST /admin/tune {"stream"?: name}``: one forced shape-tuner cycle
  (``tpu/tuner.py``) on every tunable processor of the targeted streams;
  200 when every cycle ran (committed, rejected or skipped), 409 when a
  warm failed or a flip rolled back (the incumbent grid serving), 404 when
  there was none to run, 400 for a malformed body;
- ``GET /metrics``: the process-global registry's Prometheus exposition
  (``obs/metrics.py``), ``text/plain; charset=utf-8``;
- ``GET /trace?n=&min_seq=``: the tracer's summary, its per-stage
  breakdown and the ``n`` slowest retained traces (``obs/trace.py``) newer
  than commit ``min_seq``; 400 when either is not an int;
- ``POST /debug/profile?seconds=`` (only with ``health_check.profiling_dir``):
  a ``torch.profiler`` capture (CPU, and CUDA when a card is present) of
  ``seconds`` clamped to 0.1-60, written as a Chrome trace to
  ``<profiling_dir>/trace-<unix seconds>/trace.json``; answers ``{"trace_dir",
  "seconds"}``, 400 for a seconds value that is not a finite number, 409
  while a capture runs, 500 ``profile failed: ...`` when the capture or
  its export fails. The profiler is always stopped; it starts and stops on
  the loop's thread, and the export runs on an executor thread.

The engine applies its ``tracing`` block to the process-global tracer when
it starts, before any stream runs.
"""

from __future__ import annotations

import asyncio
import json
import logging
import math
import os
import signal
import time
from typing import Any, Optional
from urllib.parse import parse_qs

from arkflow_tpu_torch.components.registry import ensure_plugins_loaded
from arkflow_tpu_torch.config import EngineConfig
from arkflow_tpu_torch.errors import SwapError, TunerError
from arkflow_tpu_torch.obs import global_registry
from arkflow_tpu_torch.obs.trace import global_tracer
from arkflow_tpu_torch.runtime.stream import Stream, build_stream, processor_parts
from arkflow_tpu_torch.utils.http1 import HttpError, HttpServer, Request, Response

logger = logging.getLogger("arkflow_torch.engine")

#: request body bound of the health server
_MAX_BODY = 1 << 20


class Engine:
    def __init__(self, config: EngineConfig):
        self.config = config
        self.cancel = asyncio.Event()
        self.streams: list[Stream] = []
        self._ready = False
        self._server: Optional[HttpServer] = None
        #: the health server's bound port (``health_check.port: 0`` picks a
        #: free one), None while it is not serving
        self.health_port: Optional[int] = None
        #: one ``/debug/profile`` capture at a time
        self._profile_lock = asyncio.Lock()
        #: the config and name of each stream of ``streams``, in order: a
        #: restart builds the stream again from them
        self._built: list[tuple[Any, str]] = []
        #: per stream name: ``restarts`` and ``restart_budget_remaining``
        self._restart_stats: dict[str, dict] = {}
        #: milliseconds of each restart's rebuild, per stream name
        self.rebuild_ms: dict[str, list[float]] = {}

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
        self._built = [(s, s.name or f"stream-{i}") for i, s in enumerate(self.config.streams)]
        self.streams = [build_stream(cfg, name=name) for cfg, name in self._built]
        return self.streams

    async def run(self) -> None:
        if self.config.tracing is not None:
            # the streams hold the global tracer: configure it in place
            global_tracer().configure(self.config.tracing)
        if not self.streams:
            self.build()
        await self.start_health_server()
        self._install_signal_handlers()

        # streams set by hand, not built from the config, run without a policy
        built = (self._built if len(self._built) == len(self.streams)
                 else [(None, s.name) for s in self.streams])
        self._ready = True
        try:
            await asyncio.gather(*(self._supervise(stream, cfg, name)
                                   for stream, (cfg, name) in zip(list(self.streams), built)))
        finally:
            self._ready = False
            await self.stop_health_server()

    def shutdown(self) -> None:
        self.cancel.set()

    async def _backoff(self, seconds: float) -> bool:
        """Sleep ``seconds`` unless cancelled; True to go on."""
        cancel_wait = asyncio.ensure_future(self.cancel.wait())
        try:
            await asyncio.wait({cancel_wait}, timeout=seconds)
        finally:
            cancel_wait.cancel()
        return not self.cancel.is_set()

    async def _supervise(self, stream: Stream, cfg, name: str) -> None:
        """Run one stream; after a crash, restart it by its policy."""
        policy = cfg.restart if cfg is not None else None
        if policy:
            # a policy built without ``_restart_config`` may miss keys
            policy = {"max_retries": policy.get("max_retries", 3),
                      "backoff_s": policy.get("backoff_s", 5.0),
                      "reset_after_s": policy.get("reset_after_s", 300.0)}
        retries = 0
        stats = {"restarts": 0,
                 "restart_budget_remaining": policy["max_retries"] if policy else None}
        self._restart_stats[name] = stats
        while True:
            run_started = time.monotonic()
            try:
                await stream.run(self.cancel)
                logger.info("[%s] finished", stream.name)
                return
            except Exception:
                logger.exception("[%s] stream crashed", stream.name)
            if not policy or self.cancel.is_set():
                return
            if time.monotonic() - run_started >= policy["reset_after_s"]:
                retries = 0  # a long healthy run earns the budget back
            try:
                stream.release()
            except Exception:
                # a failed release must not end supervision: the rebuild
                # still runs, as after any crash
                logger.exception("[%s] release of the crashed stream failed", name)
            # each attempt spends budget and must yield a fresh instance:
            # the crashed one's components are closed
            while True:
                stats["restart_budget_remaining"] = max(0, policy["max_retries"] - retries)
                if retries >= policy["max_retries"]:
                    logger.error("[%s] restart budget exhausted (%d)", name,
                                 policy["max_retries"])
                    return
                retries += 1
                stats["restarts"] += 1
                stats["restart_budget_remaining"] = max(0, policy["max_retries"] - retries)
                logger.warning("[%s] restarting (%d/%d) in %.1fs", name, retries,
                               policy["max_retries"], policy["backoff_s"])
                if not await self._backoff(policy["backoff_s"]):
                    return
                t0 = time.perf_counter()
                try:
                    stream = build_stream(cfg, name=name)
                    break
                except Exception:
                    logger.exception("[%s] rebuild failed", name)
            self.rebuild_ms.setdefault(name, []).append((time.perf_counter() - t0) * 1000.0)
            # introspection and shutdown see the live instance
            for i, old in enumerate(self.streams):
                if old.name == name:
                    self.streams[i] = stream
                    break

    # -- introspection --------------------------------------------------------

    @staticmethod
    def _processors(stream: Stream) -> list:
        return list(getattr(stream.pipeline, "processors", None) or [])

    @classmethod
    def stream_runner_reports(cls, stream: Stream) -> list[dict]:
        """The health report of every device runner of a stream."""
        reports = []
        for proc in cls._processors(stream):
            report = getattr(getattr(proc, "runner", None), "health_report", None)
            if report is None:
                continue
            try:
                rep = report()
            except Exception:  # a sick runner must not break /health itself
                logger.exception("health_report failed for stream %s", stream.name)
                continue
            reports.extend(rep if isinstance(rep, list) else [rep])
        return reports

    @classmethod
    def stream_swappers(cls, stream: Stream) -> list:
        return [sw for sw in (getattr(p, "swapper", None) for p in cls._processors(stream))
                if sw is not None and hasattr(sw, "swap")]

    def stream_health(self) -> dict:
        """Per stream: its restart accounting, its overload controller's and
        response caches' reports, and its runners', swap managers',
        integrity monitors' and shape tuners' reports."""
        out: dict[str, dict] = {}
        for s in self.streams:
            info = dict(self._restart_stats.get(
                s.name, {"restarts": 0, "restart_budget_remaining": None}))
            ctrl = getattr(s, "overload", None)
            if ctrl is not None:
                try:
                    info["overload"] = ctrl.report()
                except Exception:  # introspection must not break /health
                    logger.exception("overload report failed for stream %s", s.name)
            caches = []
            for cache in processor_parts(s.pipeline, "cache", "report"):
                try:
                    caches.append(cache.report())
                except Exception:
                    logger.exception("cache report failed for stream %s", s.name)
            if caches:
                info["response_caches"] = caches
            runners = self.stream_runner_reports(s)
            if runners:
                info["runners"] = runners
            for key, objs in (("swap", self.stream_swappers(s)),
                              ("integrity", [m for m in (getattr(p, "integrity", None)
                                                         for p in self._processors(s))
                                             if m is not None]),
                              ("tuner", processor_parts(s.pipeline, "tuner", "run_cycle"))):
                reps = []
                for obj in objs:
                    try:
                        reps.append(obj.report())
                    except Exception:  # introspection must not break /health
                        logger.exception("%s report failed for stream %s", key, s.name)
                if reps:
                    info[key] = reps
            out[s.name] = info
        return out

    # -- the health server ----------------------------------------------------

    async def start_health_server(self) -> None:
        """Serve the health routes when ``health_check.enabled``."""
        hc = self.config.health_check
        if not hc.enabled or self._server is not None:
            return
        self._server = HttpServer(self._handle, max_body=_MAX_BODY, persistent_default=False)
        self.health_port = await self._server.start(hc.host, hc.port)
        logger.info("health server on %s:%d", hc.host, self.health_port)

    async def stop_health_server(self) -> None:
        if self._server is not None:
            await self._server.close()
            self._server = self.health_port = None

    async def _handle(self, req: Request) -> Response:
        try:
            payload = await req.read()
        except (HttpError, asyncio.IncompleteReadError, asyncio.LimitOverrunError):
            status, body, close = 400, {"error": "malformed request"}, True
        else:
            status, body = await self._route(req.method, req.target, payload)
            close = False
        if isinstance(body, str):  # the exposition, and the profile route's errors
            return Response(status, body.encode(), "text/plain; charset=utf-8", close=close)
        return Response(status, json.dumps(body).encode(), "application/json", close=close)

    async def _route(self, method: str, target: str, payload: bytes) -> tuple[int, Any]:
        hc = self.config.health_check
        path, _, raw_query = target.partition("?")
        query = {k: v[0] for k, v in parse_qs(raw_query, keep_blank_values=True).items()}
        if path == "/debug/profile":  # a route only with a profiling_dir
            if not hc.profiling_dir:
                return 404, {"error": f"no route {path}"}
            if method != "POST":
                return 405, {"error": "POST only"}
            return await self._profile(query)
        if path in ("/admin/swap", "/admin/tune"):
            if method != "POST":
                return 405, {"error": "POST only"}
            if path == "/admin/tune":
                return await self._admin_tune(payload)
            return await self._admin_swap(payload)
        if method != "GET":
            return 405, {"error": "GET only"}
        if path == hc.path:
            return 200, {"status": "ok" if not self.cancel.is_set() else "shutting_down",
                         "streams": len(self.streams),
                         "tracing": global_tracer().summary(),
                         "stream_health": self.stream_health()}
        if path == "/readiness":
            return self._readiness()
        if path == "/liveness":
            return 200, {"status": "alive"}
        if path == "/metrics":
            return 200, global_registry().exposition()
        if path == "/trace":
            return self._trace(query)
        return 404, {"error": f"no route {path}"}

    @staticmethod
    def _trace(query: dict) -> tuple[int, dict]:
        """The slowest ``n`` retained traces (default the tracer's
        ``slow_n``) and the per-stage breakdown over the traces committed
        after ``min_seq``, with the tracer's summary."""
        tracer = global_tracer()
        try:
            n = int(query.get("n", 0)) or None
            min_seq = int(query.get("min_seq", 0))
        except ValueError:
            return 400, {"error": "n/min_seq must be ints"}
        return 200, {"summary": tracer.summary(),
                     "stage_breakdown": tracer.stage_breakdown(min_seq),
                     "slowest": tracer.slowest(n, min_seq)}

    async def _profile(self, query: dict) -> tuple[int, Any]:
        """One ``torch.profiler`` capture of ``seconds`` under the
        configured ``profiling_dir``."""
        try:
            seconds = float(query.get("seconds", "5"))
        except ValueError:
            return 400, "seconds must be a number"
        if not math.isfinite(seconds):  # min and max do not clamp NaN
            return 400, "seconds must be finite"
        seconds = min(max(seconds, 0.1), 60.0)
        if self._profile_lock.locked():
            return 409, "a capture is already running"
        out_dir = f"{self.config.health_check.profiling_dir.rstrip('/')}/trace-{int(time.time())}"
        async with self._profile_lock:
            try:
                await capture_profile(out_dir, seconds)
            except Exception as e:
                return 500, f"profile failed: {e}"
        return 200, {"trace_dir": out_dir, "seconds": seconds}

    def _readiness(self) -> tuple[int, dict]:
        if not self._ready:
            return 503, {"status": "not_ready"}
        # a stream whose runners are all DEAD or CORRUPT cannot serve
        dead, runners = {}, {}
        for s in self.streams:
            reports = self.stream_runner_reports(s)
            if not reports:
                continue
            runners[s.name] = [r.get("state") for r in reports]
            if all(r.get("state") in ("dead", "corrupt") for r in reports):
                dead[s.name] = len(reports)
        if dead:
            return 503, {"status": "not_ready", "dead_runner_streams": dead, "runners": runners}
        return 200, {"status": "ready", **({"runners": runners} if runners else {})}

    async def _admin_swap(self, payload: bytes) -> tuple[int, dict]:
        try:
            body = json.loads(payload or b"null")
        except ValueError:
            return 400, {"error": "body must be JSON"}
        ckpt = body.get("checkpoint") if isinstance(body, dict) else None
        if not ckpt or not isinstance(ckpt, str):
            return 400, {"error": "a 'checkpoint' path is required"}
        target = body.get("stream")
        results: dict[str, list] = {}
        ok_all, found = True, False
        for s in self.streams:
            if target is not None and s.name != target:
                continue
            for sw in self.stream_swappers(s):
                found = True
                try:
                    rep = {"ok": True, **(await sw.swap(ckpt))}
                except SwapError as e:
                    ok_all, rep = False, {"ok": False, "error": str(e)}
                except Exception as e:  # an unexpected fault must still answer
                    ok_all, rep = False, {"ok": False, "error": f"{type(e).__name__}: {e}"}
                results.setdefault(s.name, []).append(rep)
        if not found:
            return 404, {"error": "no hot-swappable processors"
                         + (f" in stream {target!r}" if target else "")}
        return (200 if ok_all else 409), {"ok": ok_all, "results": results}

    async def _admin_tune(self, payload: bytes) -> tuple[int, dict]:
        """One forced tuner cycle per tunable processor of the targeted
        streams, with the JAX engine's statuses and bodies. The hysteresis
        margin still applies: a stable workload answers "rejected"."""
        target = None
        if payload:
            try:
                body = json.loads(payload)
            except ValueError:
                return 400, {"error": "body must be JSON"}
            if body is not None and not isinstance(body, dict):
                return 400, {"error": "body must be an object"}
            target = (body or {}).get("stream")
        results: dict[str, list] = {}
        ok_all, found = True, False
        for s in self.streams:
            if target is not None and s.name != target:
                continue
            for tuner in s.tuners():
                found = True
                try:
                    rep = {"ok": True, **(await tuner.run_cycle(force=True))}
                except TunerError as e:
                    ok_all, rep = False, {"ok": False, "error": str(e)}
                except Exception as e:  # an unexpected fault must still answer
                    ok_all, rep = False, {"ok": False, "error": f"{type(e).__name__}: {e}"}
                results.setdefault(s.name, []).append(rep)
        if not found:
            return 404, {"error": "no shape-tunable processors"
                         + (f" in stream {target!r}" if target else "")}
        return (200 if ok_all else 409), {"ok": ok_all, "results": results}


#: the file a ``/debug/profile`` capture writes inside its ``trace_dir``
PROFILE_FILE = "trace.json"


async def capture_profile(out_dir: str, seconds: float) -> str:
    """Profile the process for ``seconds`` with ``torch.profiler`` (CPU
    activity, and CUDA when a card is present) and write the Chrome trace
    to ``<out_dir>/trace.json``; returns its path. The profiler starts and
    stops on the event loop's thread (Kineto binds its client to the thread
    that set it up; its CUDA side records every kernel and copy of the
    process, whichever thread launched it); the export, which serialises
    every event, runs on an executor thread. The profiler is stopped
    whatever happens, and a capture that wrote no trace raises.

    CUPTI is not torn down after the capture (``TEARDOWN_CUPTI`` is left as
    the process has it): a teardown while other threads replay CUDA graphs
    can hang the process. The cost is CUPTI's callbacks staying installed,
    so every later eager kernel launch of the process takes a little longer
    (see ``PERF.md``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = os.path.join(out_dir, PROFILE_FILE)
    prof = profile(activities=activities)
    prof.start()
    try:
        await asyncio.sleep(seconds)
    finally:
        prof.stop()  # never leave the profiler on

    def export() -> None:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(path)

    await asyncio.get_running_loop().run_in_executor(None, export)
    if not os.path.isfile(path) or os.path.getsize(path) == 0:
        raise RuntimeError(f"no trace written to {path}")
    return path
