"""Stream runtime: input -> [buffer] -> N processor workers -> ordered output.

Counterpart of the core loop of ``arkflow_tpu/runtime/stream.py``:

- Bounded queues of ``thread_num * 4`` between stages.
- Workers stamp a sequence number at dequeue; the output task restores
  the input order with a reorder map before writing.
- Backpressure: workers pause while more than ``MAX_PENDING`` batches wait
  in the reorder window.
- Acks fire only after every produced batch was written (at-least-once).
  A chain that returns nothing acks at once.
- With a buffer, the input writes into it and a buffer task moves its
  emissions into the worker queue; an emission's ack covers its sources.
- ``EndOfInput`` drains the stream and shuts it down.
- A processing error counts a delivery attempt of the batch (keyed by
  ``batch_fingerprint``). Below ``max_delivery_attempts`` a batch whose
  source delivers a nacked batch again (its ack is ``redeliverable``: the
  fault input with ``redeliver_unacked``) is nacked, so a transient
  failure such as a step deadline miss heals on redelivery. Otherwise the
  error is logged, the batch acked and counted in ``dropped_batches``
  (there is no ``error_output`` in the port yet). The default of 1, as in
  the JAX package, never nacks. A failed write is logged and nacked.
- Ordered close: input -> buffer -> pipeline -> output.
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
from arkflow_tpu_torch.errors import ArkError, EndOfInput
from arkflow_tpu_torch.runtime.pipeline import Pipeline

logger = logging.getLogger("arkflow_torch.stream")

MAX_PENDING = 1024
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
                 buffer: Optional[Buffer] = None, max_delivery_attempts: int = 1):
        self.input = input_
        self.buffer = buffer
        self.pipeline = pipeline
        self.output = output
        self.thread_num = max(1, thread_num)
        self.name = name
        self.queue_size = self.thread_num * 4
        self.max_delivery_attempts = max(1, max_delivery_attempts)
        self.rows_out = 0
        self.errors = 0
        #: failed batches acked after their last delivery attempt
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
                        await self._safe(reorder.pop(seq)[0].ack.nack, "nack")
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

    async def _safe(self, fn, what: str) -> None:
        try:
            await fn()
        except Exception as e:
            logger.warning("[%s] %s failed: %s", self.name, what, e)

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
                await self._safe(item.ack.nack, "nack")
                return
            logger.error("[%s] processing error after %d delivery attempt(s); batch "
                         "dropped: %s", self.name, attempts, err, exc_info=err)
            self.dropped_batches += 1
            self._clear_attempts(item.batch)
            await self._safe(item.ack.ack, "ack")
            return
        self._clear_attempts(item.batch)
        try:
            for b in results:
                await self.output.write(b)
                self.rows_out += b.num_rows
        except Exception as e:
            self.errors += 1
            logger.error("[%s] output write failed; not acking: %s", self.name, e)
            await self._safe(item.ack.nack, "nack")
            return
        await self._safe(item.ack.ack, "ack")

    def _bump_attempts(self, batch: MessageBatch) -> int:
        key = batch_fingerprint(batch)
        n = self._attempts.pop(key, 0) + 1
        if len(self._attempts) >= MAX_TRACKED_ATTEMPTS:
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
    buffer = build_component("buffer", cfg.buffer, resource) if cfg.buffer else None
    return Stream(input_, pipeline, output,
                  thread_num=cfg.pipeline.effective_threads(),
                  name=name or cfg.name or "stream", buffer=buffer,
                  max_delivery_attempts=cfg.pipeline.max_delivery_attempts)
