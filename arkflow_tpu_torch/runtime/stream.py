"""Stream runtime: input -> [buffer] -> N processor workers -> ordered output.

Counterpart of ``arkflow_tpu/runtime/stream.py`` without overload admission
and tracing:

- Bounded queues of ``thread_num * 4`` between stages.
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
- The counters are plain attributes named after the JAX package's metrics:
  ``errors`` (``arkflow_process_errors_total``), ``write_errors``,
  ``output_retries``, ``quarantined_batches``, ``quarantine_drops``,
  ``ack_failures``; ``reconnects`` and ``reconnect_failures`` count the
  input's reconnect probes that healed and that failed.
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

from arkflow_tpu_torch.batch import MessageBatch, batch_fingerprint
from arkflow_tpu_torch.components.base import Ack, Buffer, Input, Output, Resource
from arkflow_tpu_torch.components.registry import build_component
from arkflow_tpu_torch.config import StreamConfig
from arkflow_tpu_torch.errors import ArkError, Disconnection, EndOfInput
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
                 reconnect_retry: Optional[RetryConfig] = None):
        self.input = input_
        self.buffer = buffer
        self.pipeline = pipeline
        self.output = output
        self.error_output = error_output
        self.thread_num = max(1, thread_num)
        self.name = name
        self.queue_size = self.thread_num * 4
        self.max_delivery_attempts = max(1, max_delivery_attempts)
        self.output_retry = output_retry or RetryConfig()
        self.error_output_retry = error_output_retry or self.output_retry
        #: None: the default schedule, read at each disconnect
        self.reconnect_retry = reconnect_retry
        self._out_breaker = CircuitBreaker(output_breaker) if output_breaker else None
        self._err_breaker = (CircuitBreaker(error_output_breaker)
                             if error_output_breaker else None)
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
        #: seconds from the first read to the last write (warmup excluded)
        self.traffic_seconds = 0.0
        self._seq_assigned = 0
        self._seq_emitted = 0
        self._drained = asyncio.Event()

    def tuners(self) -> list:
        """The shape tuner of every processor that has one, walking ``_inner``
        chains as the JAX stream and engine do."""
        found = []
        for proc in getattr(self.pipeline, "processors", None) or []:
            node, seen = proc, set()
            while node is not None and id(node) not in seen:
                seen.add(id(node))
                tuner = getattr(node, "tuner", None)
                if tuner is not None and hasattr(tuner, "run_cycle"):
                    found.append(tuner)
                    break
                node = getattr(node, "_inner", None)
        return found

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
            t0 = time.perf_counter()
            input_q: asyncio.Queue = asyncio.Queue(maxsize=self.queue_size)
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
        try:
            while not cancel.is_set():
                read_f = asyncio.ensure_future(self.input.read())
                done, _ = await asyncio.wait({read_f, cancel_wait},
                                             return_when=asyncio.FIRST_COMPLETED)
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
                if self.buffer is not None:
                    await self.buffer.write(batch, ack)
                else:
                    await input_q.put(_WorkItem(batch, ack))
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
        while True:
            item = await self.buffer.read()
            if item is None:
                for _ in range(self.thread_num):
                    await input_q.put(_DONE)
                return
            await input_q.put(_WorkItem(*item))

    async def _do_processor(self, input_q: asyncio.Queue, output_q: asyncio.Queue) -> None:
        while True:
            # backpressure: wait (bounded) while the reorder window is full
            while (self._seq_assigned - self._seq_emitted) > MAX_PENDING:
                self._drained.clear()
                try:
                    await asyncio.wait_for(self._drained.wait(), 1.0)
                except asyncio.TimeoutError:
                    pass
            item = await input_q.get()
            if isinstance(item, _Done):
                await output_q.put(_DONE)
                return
            seq = self._seq_assigned
            self._seq_assigned += 1
            try:
                results = await self.pipeline.process(item.batch)
                err = None
            except Exception as e:  # processor failure -> error path
                results, err = [], e
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

    # -- the delivery path ---------------------------------------------------

    async def _safe_ack(self, ack: Ack) -> None:
        """An ack confirms work already written: one that raises must not
        stop the output stage (the source redelivers; at-least-once)."""
        try:
            await ack.ack()
        except Exception as e:
            self.ack_failures += 1
            logger.warning("[%s] ack failed (duplicate delivery possible): %s", self.name, e)

    async def _safe_nack(self, ack: Ack) -> None:
        try:
            await ack.nack()
        except Exception as e:
            logger.warning("[%s] nack failed: %s", self.name, e)

    def _count_retry(self) -> None:
        self.output_retries += 1

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
        self._clear_attempts(item.batch)
        await self._safe_ack(item.ack)

    async def _emit(self, item: _WorkItem, results: list[MessageBatch],
                    err: Optional[Exception]) -> None:
        if err is not None:
            self.errors += 1
            attempts = self._bump_attempts(item.batch)
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
            await self._safe_ack(item.ack)
            return
        try:
            for b in results:
                await self._write_guarded(self.output, self._out_breaker,
                                          self.output_retry, b, f"[{self.name}] output write")
                self.rows_out += b.num_rows
        except Exception as e:
            self.write_errors += 1
            attempts = self._bump_attempts(item.batch)
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
        await self._safe_ack(item.ack)

    def _bump_attempts(self, batch: MessageBatch) -> int:
        key = batch_fingerprint(batch)
        n = self._attempts.get(key, 0) + 1
        if key not in self._attempts and len(self._attempts) >= MAX_TRACKED_ATTEMPTS:
            self._attempts.pop(next(iter(self._attempts)))
        self._attempts[key] = n
        return n

    def _clear_attempts(self, batch: MessageBatch) -> None:
        """Forget a batch's failed attempts; hashes only while some are
        tracked, so the healthy path never pays for it."""
        if self._attempts:
            self._attempts.pop(batch_fingerprint(batch), None)


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
                  reconnect_retry=cfg.input_reconnect)
