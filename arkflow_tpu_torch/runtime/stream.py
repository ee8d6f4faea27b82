"""Stream runtime: input -> [buffer] -> N processor workers -> ordered output.

Counterpart of ``arkflow_tpu/runtime/stream.py``:

- Bounded queues of ``pipeline.queue_size`` (default ``thread_num * 4``)
  between stages.
- Workers stamp a sequence number at dequeue; the output task restores
  the input order with a reorder map before writing.
- Backpressure: workers pause while more than ``MAX_PENDING`` batches wait
  in the reorder window.
- Acks fire only after every produced batch was written (at-least-once).
  A chain that returns nothing acks at once.
- With a buffer, the input writes into it and a buffer task moves its
  emissions into the worker queue; an emission's ack covers its sources.
- ``EndOfInput`` drains the stream and shuts it down. ``Disconnection``
  puts the input into a reconnect-forever loop on ``input.reconnect``'s
  capped exponential schedule (default 100 ms doubling to
  ``RECONNECT_DELAY_S``).
- The delivery path: a processing error counts a delivery attempt of the
  batch (keyed by ``batch_fingerprint``, the function the coalescer's
  suspect table uses too). Below ``max_delivery_attempts`` a batch whose
  ack is ``redeliverable`` (its source delivers a nacked batch again in
  this session) is nacked, so a transient failure heals on redelivery.
  Otherwise it is quarantined: written to ``error_output`` tagged
  ``__meta_ext_error`` and ``__meta_ext_delivery_attempts``, then acked;
  an ``error_output`` that keeps failing counts a quarantine drop and the
  batch is acked all the same. With no ``error_output`` the error is
  logged, the batch acked and counted in ``dropped_batches``.
- Every write to ``output`` or ``error_output`` retries with backoff
  (``retry``), each attempt gated by the output's circuit breaker
  (``circuit_breaker``) when one is configured. A write that still fails
  counts a delivery attempt: at the budget, or from a source that cannot
  redeliver, the batch is quarantined when there is an ``error_output``;
  otherwise it is nacked. A batch's attempts clear only after every write
  of it succeeded.
- Metrics (``obs/metrics.py``, labelled ``stream: <name>``, the JAX
  stream's names): rows and batches in and out, process and write errors,
  ``arkflow_process_seconds``, ``arkflow_e2e_seconds`` (per batch: read to
  its last write, from the ``__meta_ingest_time`` the stream stamps at
  read), read, queue-wait and write latency, backpressure seconds, output
  retries, quarantines, quarantine drops, ack failures, pending batches,
  and each breaker's ``arkflow_circuit_state`` / ``arkflow_circuit_trips_total``
  (``output: main|error``). The plain attributes stay beside them:
  ``errors``, ``write_errors``, ``output_retries``, ``quarantined_batches``,
  ``quarantine_drops``, ``ack_failures``; ``reconnects`` and
  ``reconnect_failures`` count the input's reconnect probes that healed and
  that failed.
- Traces (``obs/trace.py``, the process-global tracer): a batch read roots
  a trace (or re-enters its own: a context on the batch, or the trace of a
  failed delivery with the same fingerprint) and records ``input_decode``;
  a buffer emission records ``buffer_wait``, or for a merged emission a new
  trace with ``coalesce_wait`` linking its sources, which finish
  ``coalesced``; a worker records ``queue_wait`` and runs the pipeline in
  the ``process`` span with the trace's scope active, so the processor's
  and runner's stages nest under it; the output records ``output_write``
  and finishes the trace ``ok`` with its end-to-end seconds, or ``error``
  on a failed delivery (forced into the store).
- Overload admission (``runtime/overload.py``), when ``pipeline.overload``
  is on (``deadline_ms`` turns it on): every batch passes the controller's
  ``admit`` before the worker queue, at the input's enqueue and at the
  buffer task's. A shed batch goes to ``error_output`` tagged
  ``__meta_ext_error: overloaded`` and ``__meta_ext_shed_reason`` and is
  acked; without ``error_output`` a redeliverable one is nacked (the
  respin paced by the controller's capacity wait) and any other acked. Its
  trace finishes ``shed`` (``deadline`` for a deadline shed). At dequeue the
  worker counts the wait into the AIMD window, sheds a batch whose budget
  ran out in the queue (``deadline``), and times the pipeline into the
  controller's step estimate. The remaining budget reads the batch's
  wall-clock ingest stamp; queue waits and step times are the loop's clock.
  A pull input that opts in (``pause_on_overload``) pauses its reads while
  the controller sheds with a full window; the controller is handed to the
  input, the buffer and each processor (``attach_overload``: the HTTP
  input's 429s, the buffer's tenant lanes, the response cache's labels).
  With ``overload.tenants`` the worker queue is a weighted
  deficit-round-robin ``FairQueue``, whose control lane (the ``_Done``
  sentinels) is served only after every tenant lane is empty; traces then
  name the wait ``fair_queue_wait``. A processing error carrying
  ``shed_reason`` takes the shed path and counts that reason. Delivered
  batches observe ``arkflow_tenant_e2e_seconds`` by tenant.
- Ordered close: input -> buffer -> pipeline -> error_output -> output.
- Each processor's shape tuner (``tpu/tuner.py``; found through ``type:
  fault`` wrappers' ``_inner``) is bound to the stream's own buffer at
  ``run``, so a committed flip retargets exactly this stream's coalescer.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass
from typing import Optional

from arkflow_tpu_torch.batch import (DEFAULT_BINARY_VALUE_FIELD, META_INGEST_TIME, MessageBatch,
                                     VarlenColumn, batch_fingerprint)
from arkflow_tpu_torch.components.base import Ack, Buffer, Input, Output, Resource
from arkflow_tpu_torch.components.registry import build_component
from arkflow_tpu_torch.config import StreamConfig
from arkflow_tpu_torch.errors import ArkError, Disconnection, EndOfInput
from arkflow_tpu_torch.obs import global_registry
from arkflow_tpu_torch.obs.trace import TraceContext, activate, global_tracer, stage_span
from arkflow_tpu_torch.runtime.overload import (FairQueue, OverloadConfig, OverloadController,
                                                attach_overload, input_pauses_on_overload)
from arkflow_tpu_torch.runtime.pipeline import Pipeline
from arkflow_tpu_torch.utils.circuit_breaker import CircuitBreaker, CircuitBreakerConfig
from arkflow_tpu_torch.utils.retry import RetryConfig, retry_with_backoff

logger = logging.getLogger("arkflow_torch.stream")

MAX_PENDING = 1024
#: cap of the default reconnect backoff after a ``Disconnection``
RECONNECT_DELAY_S = 5.0
#: failing batches whose delivery attempts are tracked at once (the oldest
#: entry is dropped beyond it)
MAX_TRACKED_ATTEMPTS = 8192


@dataclass
class _WorkItem:
    batch: MessageBatch
    ack: Ack
    #: loop-clock time it entered the worker queue
    enqueued_at: float = 0.0
    #: the batch's ``TraceContext``, parsed once; None: untraced
    trace: Optional[TraceContext] = None
    #: the capped tenant label, set at admission when tenants are
    #: accounted; None puts a ``FairQueue`` item on the control lane, so
    #: admission stamps it before the put
    tenant: Optional[str] = None


def processor_parts(pipeline, attr: str, has: str) -> list:
    """Per processor of ``pipeline``, the first ``attr`` along its
    ``_inner`` chain (a ``type: fault`` wrapper's inner processor, as the
    JAX stream and engine walk them) that has ``has``."""
    found = []
    for proc in getattr(pipeline, "processors", None) or []:
        node, seen = proc, set()
        while node is not None and id(node) not in seen:
            seen.add(id(node))
            part = getattr(node, attr, None)
            if part is not None and hasattr(part, has):
                found.append(part)
                break
            node = getattr(node, "_inner", None)
    return found


class _Done:
    """Queue sentinel: upstream stage finished."""


_DONE = _Done()


class Stream:
    def __init__(self, input_: Input, pipeline: Pipeline, output: Output,
                 thread_num: int = 1, name: str = "stream",
                 buffer: Optional[Buffer] = None, max_delivery_attempts: int = 1,
                 error_output: Optional[Output] = None,
                 output_retry: Optional[RetryConfig] = None,
                 output_breaker: Optional[CircuitBreakerConfig] = None,
                 error_output_retry: Optional[RetryConfig] = None,
                 error_output_breaker: Optional[CircuitBreakerConfig] = None,
                 reconnect_retry: Optional[RetryConfig] = None,
                 queue_size: int = 0, overload: Optional[OverloadConfig] = None):
        self.input = input_
        self.buffer = buffer
        self.pipeline = pipeline
        self.output = output
        self.error_output = error_output
        self.thread_num = max(1, thread_num)
        self.name = name
        self.queue_size = queue_size if queue_size > 0 else self.thread_num * 4
        #: the overload controller; None admits everything
        self.overload: Optional[OverloadController] = (
            OverloadController(overload, name=name, workers=self.thread_num,
                               max_window=self.queue_size)
            if overload is not None and overload.enabled else None)
        #: resolved at ``run`` from the input's wrapper chain
        self._pause_source = False
        self.max_delivery_attempts = max(1, max_delivery_attempts)
        self.output_retry = output_retry or RetryConfig()
        self.error_output_retry = error_output_retry or self.output_retry
        #: None: the default schedule, read at each disconnect
        self.reconnect_retry = reconnect_retry
        reg = global_registry()
        labels = {"stream": name}
        self.m_rows_in = reg.counter("arkflow_rows_in_total", "rows read from input", labels)
        self.m_rows_out = reg.counter("arkflow_rows_out_total", "rows written to output", labels)
        self.m_batches_in = reg.counter("arkflow_batches_in_total", "batches read from input",
                                        labels)
        self.m_batches_out = reg.counter("arkflow_batches_out_total", "batches written", labels)
        self.m_errors = reg.counter("arkflow_process_errors_total", "processor errors", labels)
        self.m_write_errors = reg.counter("arkflow_write_errors_total", "output write errors",
                                          labels)
        self.m_proc_latency = reg.histogram("arkflow_process_seconds", "pipeline latency", labels)
        self.m_e2e_latency = reg.histogram("arkflow_e2e_seconds", "read-to-written latency",
                                           labels)
        self.m_pending = reg.gauge("arkflow_pending_batches", "in-flight batches", labels)
        self.m_read_latency = reg.histogram(
            "arkflow_input_read_seconds", "time blocked in input.read()", labels)
        self.m_queue_wait = reg.histogram(
            "arkflow_queue_wait_seconds", "work-item wait between input and worker", labels)
        self.m_write_latency = reg.histogram(
            "arkflow_output_write_seconds", "output.write() latency per batch", labels)
        self.m_backpressure_s = reg.counter(
            "arkflow_backpressure_seconds_total",
            "worker seconds stalled on the reorder window", labels)
        self.m_out_retries = reg.counter(
            "arkflow_output_retries_total", "output write retry attempts", labels)
        self.m_quarantined = reg.counter(
            "arkflow_quarantined_batches_total",
            "batches quarantined to error_output after exhausting delivery attempts", labels)
        self.m_quarantine_drops = reg.counter(
            "arkflow_quarantine_drops_total",
            "batches dropped because the error_output write itself kept failing", labels)
        self.m_ack_failures = reg.counter(
            "arkflow_ack_failures_total", "ack callbacks that raised", labels)
        self._out_breaker = (CircuitBreaker(output_breaker,
                                            **self._breaker_metrics(reg, labels, "main"))
                             if output_breaker else None)
        self._err_breaker = (CircuitBreaker(error_output_breaker,
                                            **self._breaker_metrics(reg, labels, "error"))
                             if error_output_breaker else None)
        #: the process-global tracer; the engine applies the ``tracing``
        #: block to it before the streams run
        self.tracer = global_tracer()
        self.rows_out = 0
        #: processing errors (failed deliveries of a batch through the chain)
        self.errors = 0
        #: deliveries whose output write failed after its retries
        self.write_errors = 0
        #: write attempts retried (on ``output`` and ``error_output``)
        self.output_retries = 0
        #: batches written to ``error_output`` after their last attempt
        self.quarantined_batches = 0
        #: batches acked because the ``error_output`` write kept failing
        self.quarantine_drops = 0
        #: acks that raised (a duplicate delivery may follow)
        self.ack_failures = 0
        #: reconnect probes after a ``Disconnection`` that healed / failed
        self.reconnects = 0
        self.reconnect_failures = 0
        #: failed batches acked after their last attempt with no error_output
        self.dropped_batches = 0
        #: delivery attempts per failing batch fingerprint; cleared on success
        self._attempts: dict[bytes, int] = {}
        #: trace identity of failing batches, keyed like ``_attempts``: a
        #: redelivery without the trace column re-enters the same trace
        self._trace_ids: dict[bytes, tuple[str, bool]] = {}
        #: seconds from the first read to the last write (warmup excluded)
        self.traffic_seconds = 0.0
        self._seq_assigned = 0
        self._seq_emitted = 0
        self._drained = asyncio.Event()

    @staticmethod
    def _breaker_metrics(reg, labels: dict, output: str) -> dict:
        return {"gauge": reg.gauge(
                    "arkflow_circuit_state",
                    "output circuit breaker state (0 closed, 1 open, 2 half-open)",
                    {**labels, "output": output}),
                "trip_counter": reg.counter(
                    "arkflow_circuit_trips_total", "circuit breaker open transitions",
                    {**labels, "output": output})}

    def tuners(self) -> list:
        """The shape tuner of every processor that has one."""
        return processor_parts(self.pipeline, "tuner", "run_cycle")

    def release(self) -> None:
        """Free what the processors hold on the device (each processor's
        ``release``): the engine calls it on a crashed stream before it
        builds the stream again."""
        for release in processor_parts(self.pipeline, "release", "__call__"):
            release()

    async def run(self, cancel: asyncio.Event) -> None:
        """Run until the input ends or ``cancel`` is set; drains before returning."""
        if self.buffer is not None and hasattr(self.buffer, "retarget_shapes"):
            for tuner in self.tuners():
                tuner.bind_listener(self.buffer)
        try:
            # processors first: model warmup finishes before the input produces
            await self.pipeline.connect()
            await self.input.connect()
            await self.output.connect()
            if self.error_output is not None:
                await self.error_output.connect()
            # the HTTP input's 429s, the buffer's lane cap and the cache's
            # tenant labels all follow the controller
            attach_overload(self.input, self.overload)
            attach_overload(self.buffer, self.overload)
            for proc in getattr(self.pipeline, "processors", None) or []:
                attach_overload(proc, self.overload)
            self._pause_source = (self.overload is not None
                                  and input_pauses_on_overload(self.input))
            t0 = time.perf_counter()
            if self.overload is not None and self.overload.cfg.tenants is not None:
                # tenants: the worker queue serves them by weight
                input_q = FairQueue(self.overload, self.queue_size)
            else:
                input_q = asyncio.Queue(maxsize=self.queue_size)
            output_q: asyncio.Queue = asyncio.Queue(maxsize=self.queue_size)
            tasks = [asyncio.create_task(self._do_input(input_q, cancel),
                                         name=f"{self.name}-input")]
            if self.buffer is not None:
                tasks.append(asyncio.create_task(self._do_buffer(input_q),
                                                 name=f"{self.name}-buffer"))
            tasks += [asyncio.create_task(self._do_processor(input_q, output_q),
                                          name=f"{self.name}-proc-{i}")
                      for i in range(self.thread_num)]
            out_task = asyncio.create_task(self._do_output(output_q), name=f"{self.name}-output")
            try:
                await asyncio.gather(*tasks)
                await out_task  # every worker sent its sentinel; output drains
                self.traffic_seconds = time.perf_counter() - t0
            except BaseException:
                for t in [*tasks, out_task]:
                    t.cancel()
                await asyncio.gather(*tasks, out_task, return_exceptions=True)
                raise
        finally:
            await self._close_all()

    async def _close_all(self) -> None:
        for stage, closer in (("input", self.input.close),
                              *((("buffer", self.buffer.close),) if self.buffer else ()),
                              ("pipeline", self.pipeline.close),
                              *((("error_output", self.error_output.close),)
                                if self.error_output else ()),
                              ("output", self.output.close)):
            try:
                await closer()
            except Exception:
                logger.exception("[%s] error during close of %s", self.name, stage)

    # -- stages ------------------------------------------------------------

    async def _do_input(self, input_q: asyncio.Queue, cancel: asyncio.Event) -> None:
        cancel_wait = asyncio.ensure_future(cancel.wait())
        loop = asyncio.get_running_loop()
        try:
            while not cancel.is_set():
                if self._pause_source and self.overload.should_pause():
                    # a pull source keeps its backlog on the broker
                    t_pause = loop.time()
                    while self.overload.should_pause() and not cancel.is_set():
                        await self.overload.wait_capacity(0.25)
                    self.overload.m_paused_s.inc(loop.time() - t_pause)
                    if cancel.is_set():
                        break
                t_read = loop.time()
                read_f = asyncio.ensure_future(self.input.read())
                done, _ = await asyncio.wait({read_f, cancel_wait},
                                             return_when=asyncio.FIRST_COMPLETED)
                read_dt = loop.time() - t_read
                if read_f in done:  # a cancel while idle is no read latency
                    self.m_read_latency.observe(read_dt)
                if read_f not in done:
                    read_f.cancel()
                    await asyncio.gather(read_f, return_exceptions=True)
                    break
                try:
                    batch, ack = read_f.result()
                except EndOfInput:
                    logger.info("[%s] input exhausted (EOF)", self.name)
                    break
                except Disconnection as e:
                    await self._reconnect(e, cancel)
                    continue
                except ArkError as e:
                    logger.error("[%s] input read error: %s", self.name, e)
                    await asyncio.sleep(0.1)
                    continue
                ctx = None
                if self.tracer.enabled:
                    # a context on the batch, or the trace of a failed
                    # delivery of the same batch, is a redelivery: its spans
                    # join that trace. A first delivery roots a new one.
                    ctx = batch.trace_context()
                    redelivered = ctx is not None
                    if ctx is None:
                        ctx = self._redelivered_trace(batch)
                        redelivered = ctx is not None
                        if ctx is None:
                            ctx = self.tracer.begin()
                        batch = batch.with_trace(ctx)
                    self.tracer.record(
                        ctx, "input_decode", read_dt,
                        attrs=({"redelivered": True} if redelivered else None))
                # the stream's own ingest stamp, over an input's: e2e runs
                # from here
                item = _WorkItem(batch.with_ingest_time(), ack, loop.time(), trace=ctx)
                self.m_batches_in.inc()
                self.m_rows_in.inc(batch.num_rows)
                if self.buffer is not None:
                    # admission happens at the buffer task's enqueue
                    await self.buffer.write(item.batch, item.ack)
                elif await self._admit_or_shed(item):
                    await input_q.put(item)
        finally:
            cancel_wait.cancel()
            if self.buffer is not None:
                await self.buffer.close()  # the buffer drains, then its reader ends
            else:
                for _ in range(self.thread_num):
                    await input_q.put(_DONE)

    async def _reconnect(self, err: Exception, cancel: asyncio.Event) -> None:
        """Reconnect the input until a probe heals or the stream is
        cancelled, sleeping the schedule's delay before each probe."""
        schedule = self.reconnect_retry or RetryConfig(
            max_delay_ms=max(1, int(RECONNECT_DELAY_S * 1000)))
        attempt = 0
        logger.warning("[%s] input disconnected (%s); reconnecting in %.2fs",
                       self.name, err, schedule.delay_s(0))
        while not cancel.is_set():
            try:
                await asyncio.sleep(schedule.delay_s(attempt))
                await self.input.connect()
                self.reconnects += 1
                return
            except Exception as e:
                attempt += 1
                self.reconnect_failures += 1
                logger.warning("[%s] reconnect failed (attempt %d): %s; backing off",
                               self.name, attempt, e)

    async def _do_buffer(self, input_q: asyncio.Queue) -> None:
        """Move the buffer's emissions into the worker queue."""
        loop_time = asyncio.get_running_loop().time
        while True:
            item = await self.buffer.read()
            if item is None:
                for _ in range(self.thread_num):
                    await input_q.put(_DONE)
                return
            batch, ack = item
            ctx = None
            if self.tracer.enabled:
                batch, ctx = self._trace_emission(batch)
            work = _WorkItem(batch, ack, loop_time(), trace=ctx)
            if await self._admit_or_shed(work):
                await input_q.put(work)

    def _trace_emission(self, batch: MessageBatch):
        """A buffer emission's trace. A merged emission (rows of several
        source traces) starts a new trace whose ``coalesce_wait`` span links
        every source, and each source finishes ``coalesced`` pointing at it;
        an emission of one trace keeps it and records ``buffer_wait``. The
        wait is the buffer's own ``last_emission_wait_s`` when it keeps one,
        else the age of row 0's ingest stamp."""
        wait_s = getattr(self.buffer, "last_emission_wait_s", None)
        if wait_s is None:
            ingest = batch.get_meta(META_INGEST_TIME)
            wait_s = (max(0.0, time.time() - float(ingest) / 1000.0)
                      if ingest is not None else 0.0)
        contexts = batch.source_trace_contexts()
        if len(contexts) <= 1:
            ctx = contexts[0] if contexts else self.tracer.begin()
            self.tracer.record(ctx, "buffer_wait", wait_s)
            return batch, ctx
        sources = [c.trace_id for c in contexts]
        ctx = self.tracer.begin()
        self.tracer.record(ctx, "coalesce_wait", wait_s, attrs={"links": sources})
        for src in contexts:
            self.tracer.finish(src, "coalesced", attrs={"merged_into": ctx.trace_id})
        return batch.with_trace(ctx), ctx

    async def _do_processor(self, input_q, output_q: asyncio.Queue) -> None:
        loop_time = asyncio.get_running_loop().time
        tracer = self.tracer
        overload = self.overload
        # the same measurement, named apart when the queue schedules tenants
        queue_stage = "fair_queue_wait" if isinstance(input_q, FairQueue) else "queue_wait"
        while True:
            # backpressure: wait (bounded) while the reorder window is full
            if (self._seq_assigned - self._seq_emitted) > MAX_PENDING:
                t_bp = loop_time()
                while (self._seq_assigned - self._seq_emitted) > MAX_PENDING:
                    self._drained.clear()
                    try:
                        await asyncio.wait_for(self._drained.wait(), 1.0)
                    except asyncio.TimeoutError:
                        pass
                self.m_backpressure_s.inc(loop_time() - t_bp)
            item = await input_q.get()
            if isinstance(item, _Done):
                await output_q.put(_DONE)
                return
            now = loop_time()
            wait = now - item.enqueued_at
            self.m_queue_wait.observe(wait)
            trace = item.trace
            if trace is not None:
                tracer.record(trace, queue_stage, wait)
            if overload is not None:
                overload.on_dequeue(wait, now, tenant=item.tenant)
                remaining = item.batch.remaining_deadline_ms(overload.cfg.deadline_ms)
                if remaining is not None and remaining <= 0:
                    # stale in the queue: shedding beats finishing it, and
                    # this check bounds delivered latency
                    await self._shed_item(item, overload.expire(item.tenant))
                    continue
            seq = self._seq_assigned
            self._seq_assigned += 1
            self.m_pending.set(self._seq_assigned - self._seq_emitted)
            t0 = loop_time()
            try:
                if trace is not None:
                    # the processor's and runner's stages nest under process
                    with activate(tracer, trace):
                        with stage_span("process"):
                            results = await self.pipeline.process(item.batch)
                else:
                    results = await self.pipeline.process(item.batch)
                err = None
            except Exception as e:  # processor failure -> error path
                results, err = [], e
            dt = loop_time() - t0
            self.m_proc_latency.observe(dt)
            if overload is not None:
                overload.observe_step(dt)
            await output_q.put((seq, item, results, err))

    async def _do_output(self, output_q: asyncio.Queue) -> None:
        """Reorder by sequence number and write; ack only on full success."""
        reorder: dict[int, tuple] = {}
        next_seq = 0
        done_workers = 0
        while True:
            msg = await output_q.get()
            if isinstance(msg, _Done):
                done_workers += 1
                if done_workers >= self.thread_num:
                    for seq in sorted(reorder):  # a gap at shutdown: redeliver
                        await self._safe_nack(reorder.pop(seq)[0].ack)
                    return
                continue
            seq, item, results, err = msg
            reorder[seq] = (item, results, err)
            while next_seq in reorder:
                item, results, err = reorder.pop(next_seq)
                next_seq += 1
                self._seq_emitted = next_seq
                if (self._seq_assigned - self._seq_emitted) <= MAX_PENDING:
                    self._drained.set()
                await self._emit(item, results, err)

    # -- overload admission (runtime/overload.py) ------------------------------

    async def _admit_or_shed(self, item: _WorkItem) -> bool:
        """The admission gate before the worker queue: True to enqueue,
        False when the controller shed the batch (already routed, nacked or
        acked)."""
        ctrl = self.overload
        if ctrl is None:
            return True
        remaining = item.batch.remaining_deadline_ms(ctrl.cfg.deadline_ms)
        tokens = 0.0
        if ctrl.cfg.tenants is not None:
            # the capped label, once: every later touch reuses it
            item.tenant = ctrl.tenant_label(item.batch.tenant())
            if ctrl.meters_tokens():
                tokens = self._estimate_tokens(item.batch, ctrl.cfg.tenants)
        reason = ctrl.admit(item.batch.priority_band(ctrl.cfg.priority), remaining,
                            tenant=item.tenant, rows=float(item.batch.num_rows),
                            tokens=tokens)
        if reason is None:
            ctrl.on_enqueue(item.tenant)
            return True
        await self._shed_item(item, reason)
        return False

    @staticmethod
    def _estimate_tokens(batch: MessageBatch, policy) -> float:
        """The batch's estimated tokens for a tokens/s quota: the coalescer's
        estimator over the policy's ``token_field`` (a binary or a string
        column) with its ``token_bytes``. A batch without such a column
        meters one token a row."""
        from arkflow_tpu_torch.tpu.extract import payload_token_estimates

        try:
            col = batch.column(policy.token_field or DEFAULT_BINARY_VALUE_FIELD)
            if not isinstance(col, VarlenColumn):
                raise TypeError(f"not a binary or string column: {type(col).__name__}")
            return float(payload_token_estimates(col, token_bytes=policy.token_bytes).sum())
        except Exception:
            return float(batch.num_rows)

    async def _shed_item(self, item: _WorkItem, reason: str) -> None:
        """Dispose of a shed batch without silent loss: to ``error_output``
        tagged ``overloaded`` (and acked), else nacked when its source
        redelivers, else acked and logged. An absolute deadline that has
        passed only gets staler on redelivery, so it is acked, not nacked."""
        # shed traces are forced into the store
        self.tracer.finish(item.trace, "deadline" if reason == "deadline" else "shed",
                           attrs={"reason": reason})
        if self.error_output is not None:
            await self._error_route_or_drop(
                item.batch, {"error": "overloaded", "shed_reason": reason},
                f"[{self.name}] shed write",
                "[%s] error_output rejected a shed batch (%s); dropping WITH ack",
                self.name, reason)
            # terminal: a later identical payload starts a fresh budget
            self._clear_attempts(item.batch)
            await self._safe_ack(item.ack)
            return
        expired_abs = (item.batch.deadline_unix_ms() is not None
                       and (item.batch.remaining_deadline_ms() or 0.0) <= 0)
        if getattr(item.ack, "redeliverable", False) and not expired_abs:
            await self._safe_nack(item.ack)
            # an in-process source redelivers at once: pace the respin
            if self.overload is not None:
                await self.overload.wait_capacity(0.05)
            else:
                await asyncio.sleep(0.05)
            return
        logger.warning("[%s] shed batch (%s) with no error_output and %s; dropping WITH ack",
                       self.name, reason,
                       "an expired absolute deadline" if expired_abs else "no redelivery")
        self._clear_attempts(item.batch)
        await self._safe_ack(item.ack)

    # -- the delivery path ---------------------------------------------------

    async def _safe_ack(self, ack: Ack) -> None:
        """An ack confirms work already written: one that raises must not
        stop the output stage (the source redelivers; at-least-once)."""
        try:
            await ack.ack()
        except Exception as e:
            self.ack_failures += 1
            self.m_ack_failures.inc()
            logger.warning("[%s] ack failed (duplicate delivery possible): %s", self.name, e)

    async def _safe_nack(self, ack: Ack) -> None:
        try:
            await ack.nack()
        except Exception as e:
            logger.warning("[%s] nack failed: %s", self.name, e)

    def _count_retry(self) -> None:
        self.output_retries += 1
        self.m_out_retries.inc()

    async def _write_guarded(self, output: Output, breaker: Optional[CircuitBreaker],
                             retry_cfg: RetryConfig, batch: MessageBatch, what: str) -> None:
        """One delivery: write attempts with backoff, each gated by the
        output's circuit breaker when there is one."""

        async def attempt() -> None:
            if breaker is not None:
                await breaker.acquire()
            try:
                await output.write(batch)
            except Exception:
                if breaker is not None:
                    breaker.record_failure()
                raise
            if breaker is not None:
                breaker.record_success()

        await retry_with_backoff(attempt, retry_cfg, what=what, on_retry=self._count_retry)

    async def _error_route_or_drop(self, batch: MessageBatch, meta: dict,
                                   what: str, fail_log: str, *fail_args) -> bool:
        """Tag a batch and write it to ``error_output`` (with its retry and
        breaker). On a write that keeps failing, count a quarantine drop
        and log. The caller acks either way: a batch that can go nowhere
        must not wedge the stream on eternal redelivery."""
        tagged = batch.with_ext_metadata(meta)
        try:
            await self._write_guarded(self.error_output, self._err_breaker,
                                      self.error_output_retry, tagged, what)
            return True
        except Exception:
            self.quarantine_drops += 1
            self.m_quarantine_drops.inc()
            logger.exception(fail_log, *fail_args)
            return False

    async def _quarantine(self, item: _WorkItem, reason: str, attempts: int) -> None:
        """Route a poisoned batch to ``error_output`` with its attempt count,
        then ack it."""
        if await self._error_route_or_drop(
                item.batch, {"error": reason, "delivery_attempts": str(attempts)},
                f"[{self.name}] error_output write",
                "[%s] error_output write kept failing; DROPPING batch after %d "
                "delivery attempt(s) (reason: %s)", self.name, attempts, reason):
            self.quarantined_batches += 1
            self.m_quarantined.inc()
        self._clear_attempts(item.batch)
        await self._safe_ack(item.ack)

    async def _emit(self, item: _WorkItem, results: list[MessageBatch],
                    err: Optional[Exception]) -> None:
        if err is not None:
            reason = getattr(err, "shed_reason", None)
            if reason is not None:
                # a shed raised inside the chain: not a processing failure,
                # so it burns no delivery attempt and keeps the identity
                # offered == delivered + shed
                if self.overload is not None:
                    c = self.overload.m_shed.get(reason)
                    if c is not None:
                        c.inc()
                await self._shed_item(item, reason)
                return
            self.errors += 1
            self.m_errors.inc()
            attempts = self._bump_attempts(item.batch, trace=item.trace)
            # every failed attempt commits its trace (forced); the
            # redelivery re-enters the same trace id at read
            self.tracer.finish(item.trace, "error",
                               attrs={"error": str(err)[:200], "attempt": attempts})
            if attempts < self.max_delivery_attempts and getattr(
                    item.ack, "redeliverable", False):
                logger.warning("[%s] processing failed (delivery %d/%d); nacked for "
                               "redelivery: %s", self.name, attempts,
                               self.max_delivery_attempts, err)
                await self._safe_nack(item.ack)
                return
            if self.error_output is not None:
                await self._quarantine(item, str(err), attempts)
                return
            logger.error("[%s] processing error after %d delivery attempt(s) (no "
                         "error_output); batch dropped: %s", self.name, attempts, err,
                         exc_info=err)
            self.dropped_batches += 1
            self._clear_attempts(item.batch)
            await self._safe_ack(item.ack)
            return
        if not results:  # the chain dropped the batch: ack it
            self.tracer.finish(item.trace, "ok", attrs={"results": 0})
            await self._safe_ack(item.ack)
            return
        loop = asyncio.get_running_loop()
        try:
            t_write0 = loop.time()
            for b in results:
                t_w = loop.time()
                await self._write_guarded(self.output, self._out_breaker,
                                          self.output_retry, b, f"[{self.name}] output write")
                self.m_write_latency.observe(loop.time() - t_w)
                self.m_batches_out.inc()
                self.m_rows_out.inc(b.num_rows)
                self.rows_out += b.num_rows
            self.tracer.record(item.trace, "output_write", loop.time() - t_write0,
                               attrs=({"batches": len(results)} if len(results) > 1 else None))
        except Exception as e:
            self.write_errors += 1
            self.m_write_errors.inc()
            attempts = self._bump_attempts(item.batch, trace=item.trace)
            self.tracer.finish(item.trace, "error",
                               attrs={"error": f"output write failed: {e}"[:200],
                                      "attempt": attempts})
            if self.error_output is not None and (
                    attempts >= self.max_delivery_attempts
                    or not getattr(item.ack, "redeliverable", False)):
                logger.error("[%s] output write failed after %d delivery attempt(s); "
                             "quarantining: %s", self.name, attempts, e)
                await self._quarantine(item, f"output write failed: {e}", attempts)
            else:
                logger.error("[%s] output write failed (delivery %d/%d); not acking: %s",
                             self.name, attempts, self.max_delivery_attempts, e)
                await self._safe_nack(item.ack)
            return
        self._clear_attempts(item.batch)
        ingest = item.batch.get_meta(META_INGEST_TIME)
        e2e = None
        if ingest is not None:  # per batch, not per row, as in JAX
            e2e = max(0.0, time.time() - ingest / 1000.0)
            self.m_e2e_latency.observe(e2e)
            if self.overload is not None and item.tenant is not None:
                self.overload.observe_tenant_latency(item.tenant, e2e)
        self.tracer.finish(item.trace, "ok", e2e_s=e2e)
        await self._safe_ack(item.ack)

    def _bump_attempts(self, batch: MessageBatch,
                       trace: Optional[TraceContext] = None) -> int:
        key = batch_fingerprint(batch)
        n = self._attempts.get(key, 0) + 1
        if key not in self._attempts and len(self._attempts) >= MAX_TRACKED_ATTEMPTS:
            evicted = next(iter(self._attempts))
            self._attempts.pop(evicted)
            self._trace_ids.pop(evicted, None)
        self._attempts[key] = n
        if trace is not None:
            self._trace_ids[key] = (trace.trace_id, trace.sampled)
        return n

    def _clear_attempts(self, batch: MessageBatch) -> None:
        """Forget a batch's failed attempts; hashes only while some are
        tracked, so the healthy path never pays for it."""
        if self._attempts:
            key = batch_fingerprint(batch)
            self._attempts.pop(key, None)
            self._trace_ids.pop(key, None)

    def _redelivered_trace(self, batch: MessageBatch) -> Optional[TraceContext]:
        """The trace of a failed delivery of this batch, or None; hashes
        only while failures are tracked."""
        if not self._trace_ids:
            return None
        hit = self._trace_ids.get(batch_fingerprint(batch))
        return None if hit is None else TraceContext(trace_id=hit[0], sampled=hit[1])


def build_stream(cfg: StreamConfig, name: Optional[str] = None) -> Stream:
    """Construct a Stream from config via the builder registries."""
    resource = Resource()
    input_ = build_component("input", cfg.input, resource)
    pipeline = Pipeline([build_component("processor", p, resource)
                         for p in cfg.pipeline.processors])
    output = build_component("output", cfg.output, resource)
    error_output = (build_component("output", cfg.error_output, resource)
                    if cfg.error_output else None)
    buffer = build_component("buffer", cfg.buffer, resource) if cfg.buffer else None
    return Stream(input_, pipeline, output,
                  thread_num=cfg.pipeline.effective_threads(),
                  name=name or cfg.name or "stream", buffer=buffer,
                  max_delivery_attempts=cfg.pipeline.max_delivery_attempts,
                  error_output=error_output,
                  output_retry=cfg.output_retry, output_breaker=cfg.output_circuit_breaker,
                  error_output_retry=cfg.error_output_retry,
                  error_output_breaker=cfg.error_output_circuit_breaker,
                  reconnect_retry=cfg.input_reconnect,
                  queue_size=cfg.pipeline.effective_queue_size(),
                  overload=cfg.pipeline.overload)
