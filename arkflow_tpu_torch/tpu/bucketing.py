"""Shape bucketing: pad ragged batches onto a small grid of (batch, seq) shapes,
and coalesce stream batches into emissions that fill that grid.

Counterpart of ``arkflow_tpu/tpu/bucketing.py`` without ``dp_scaled``. The
grid bounds padding waste (each dimension at
most doubles), keeps the device's working set at a few known shapes (one
CUDA graph each, ``tpu/compiled_step.py``), and keeps batches and outputs
identical to the JAX package's for the same input. After a device OOM the
runner caps its grid (``BucketPolicy.capped``) and announces the cap on the
process-wide ``bucket_cap_bus()``, which shrinks every registered
coalescer's target (``MicroBatchCoalescer.cap``). A shape tuner's commit
(``tpu/tuner.py``) moves coalescers the other way: ``BucketCapBus.retarget``
(or a stream-bound listener) hands them a new grid, token budget and
deadline, clamped under any standing cap.
"""

from __future__ import annotations

import logging
import threading
import weakref
from collections import deque
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from arkflow_tpu_torch.batch import (
    DEFAULT_BINARY_VALUE_FIELD,
    MessageBatch,
    VarlenColumn,
    batch_fingerprint,
)
from arkflow_tpu_torch.components.base import Ack, VecAck, split_ack
from arkflow_tpu_torch.errors import ConfigError
from arkflow_tpu_torch.tpu.extract import payload_token_estimates

logger = logging.getLogger("arkflow_torch.bucketing")


def pow2_buckets(lo: int, hi: int) -> list[int]:
    out = []
    b = max(1, lo)
    while b < hi:
        out.append(b)
        b *= 2
    out.append(hi)
    return out


@dataclass(frozen=True)
class BucketPolicy:
    batch_buckets: tuple[int, ...] = tuple(pow2_buckets(8, 256))
    seq_buckets: tuple[int, ...] = tuple(pow2_buckets(32, 512))
    #: packed serving only: how far past the row grid the EXAMPLE-dim grid
    #: extends (a packed row holds several examples, so a full row bucket of
    #: short texts carries more examples than rows). 1 keeps the example
    #: grid identical to the row grid.
    example_scale: int = 1

    @classmethod
    def from_config(cls, config: dict, *, max_batch: Optional[int] = None,
                    max_seq: Optional[int] = None,
                    default_example_scale: int = 1) -> "BucketPolicy":
        bb = config.get("batch_buckets")
        sb = config.get("seq_buckets")
        if bb is None:
            bb = pow2_buckets(8, max_batch or 256)
        if sb is None:
            sb = pow2_buckets(32, max_seq or 512)
        bb = tuple(sorted(int(x) for x in bb))
        sb = tuple(sorted(int(x) for x in sb))
        if not bb or not sb or bb[0] <= 0 or sb[0] <= 0:
            raise ConfigError("bucket lists must be non-empty positive ints")
        es = config.get("example_scale", default_example_scale)
        if not isinstance(es, int) or isinstance(es, bool) or es < 1:
            raise ConfigError(f"example_scale must be an int >= 1, got {es!r}")
        return cls(bb, sb, es)

    @staticmethod
    def _pick(n: int, buckets: Sequence[int]) -> int:
        for b in buckets:
            if n <= b:
                return b
        return buckets[-1]

    def batch_bucket(self, n: int) -> int:
        return self._pick(n, self.batch_buckets)

    def seq_bucket(self, n: int) -> int:
        return self._pick(n, self.seq_buckets)

    def max_batch(self) -> int:
        return self.batch_buckets[-1]

    def capped(self, below: int) -> Optional["BucketPolicy"]:
        """OOM degradation: the grid with only the batch buckets strictly
        below ``below`` (the bucket the device failed to hold); None when no
        smaller bucket exists."""
        smaller = tuple(b for b in self.batch_buckets if b < below)
        if not smaller:
            return None
        return BucketPolicy(smaller, self.seq_buckets, self.example_scale)

    # -- packed serving: example-dim grid + token-budget grid ---------------

    def example_buckets(self) -> tuple[int, ...]:
        """The packed path's EXAMPLE-dim grid: the row grid, pow2-extended up
        to ``max_batch * example_scale`` (and at least the top seq bucket, so
        one row of minimum-length examples always has an example bucket)."""
        out = list(self.batch_buckets)
        top = self.batch_buckets[-1]
        want = (max(top * self.example_scale, self.seq_buckets[-1])
                if self.example_scale > 1 else top)
        while top < want:
            top *= 2
            out.append(top)
        return tuple(out)

    def example_bucket(self, n: int) -> int:
        return self._pick(n, self.example_buckets())

    def max_examples(self) -> int:
        return self.example_buckets()[-1]

    def token_buckets(self, seq: int) -> tuple[int, ...]:
        """Each batch bucket's row capacity in tokens at row width ``seq``."""
        if seq < 1:
            raise ConfigError(f"token_buckets seq must be >= 1, got {seq}")
        return tuple(b * seq for b in self.batch_buckets)

    def token_budget(self, seq: int) -> int:
        """Tokens that fill the largest (rows, seq) shape: the natural
        emission target of a token-budget coalescer feeding ``pack_tokens``."""
        return self.token_buckets(seq)[-1]


class BucketCapBus:
    """Process-wide fan-out of device OOM caps to live coalescers: the
    runner and the memory buffer are built from different config sections,
    and when the device proves it cannot hold a bucket every registered
    coalescer stops carving emissions of it. A coalescer registered after a
    cap gets the standing cap, and caps only shrink. Shape listeners (memory
    buffers, which own the coalesce deadline) follow a tuner's ``retarget``
    as well."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._coalescers: "weakref.WeakSet[MicroBatchCoalescer]" = weakref.WeakSet()
        self._cap: Optional[int] = None
        #: objects with ``retarget_shapes(batch_buckets, token_budget,
        #: deadline_s, expect=...)``
        self._listeners: "weakref.WeakSet" = weakref.WeakSet()

    @property
    def cap(self) -> Optional[int]:
        return self._cap

    def register(self, coalescer: "MicroBatchCoalescer") -> None:
        with self._lock:
            self._coalescers.add(coalescer)
            if self._cap is not None:
                coalescer.cap(self._cap)

    def register_listener(self, listener) -> None:
        """Register a buffer-level shape listener for later retargets. A
        retarget is not replayed onto a late registration (a cap is a device
        fact, a retarget one stream's preference): it starts on its
        configured grid and follows the next commit."""
        with self._lock:
            self._listeners.add(listener)

    def announce(self, cap: int) -> None:
        with self._lock:
            self._cap = cap if self._cap is None else min(self._cap, cap)
            for c in list(self._coalescers):
                c.cap(self._cap)

    def _clamped(self, buckets: tuple[int, ...],
                 token_budget: Optional[int]) -> tuple[tuple[int, ...], Optional[int]]:
        """An OOM cap always wins over a retarget: the buckets above it are
        dropped (the cap itself when none is left) and the budget scales as
        ``MicroBatchCoalescer.cap`` scales it."""
        if self._cap is None or not buckets:
            return buckets, token_budget
        fitting = tuple(b for b in buckets if b <= self._cap)
        if not fitting:
            fitting = (max(1, int(self._cap)),)
        if token_budget is not None and fitting[-1] != buckets[-1]:
            token_budget = max(1, int(token_budget * fitting[-1] / buckets[-1]))
        return fitting, token_budget

    def clamp(self, batch_buckets: Sequence[int], token_budget: Optional[int] = None
              ) -> tuple[tuple[int, ...], Optional[int]]:
        """The standing cap applied to a grid and budget: a stream-bound
        commit, which bypasses the broadcast, clamps through here."""
        with self._lock:
            return self._clamped(tuple(int(b) for b in batch_buckets), token_budget)

    def retarget(self, batch_buckets: Sequence[int], *, token_budget: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 expect: Optional[Sequence[int]] = None) -> None:
        """A tuner commit's broadcast: the coalescers whose current grid is
        ``expect`` (None: all) adopt the clamped grid and budget, and the
        listeners also the deadline. A listener's own coalescer (its
        ``coalescer``) follows the listener alone, so it is retargeted once,
        under the listener's bounds. Scoped by ``expect`` because the bus
        is process-wide: one stream's retune must leave another's grid
        alone. A stream binds its tuner to its own buffer, which a commit
        then retargets directly: the broadcast serves tuners that no stream
        bound."""
        bb = tuple(sorted(int(b) for b in batch_buckets))
        exp = tuple(sorted(int(b) for b in expect)) if expect is not None else None
        with self._lock:
            cb, ct = self._clamped(bb, token_budget)
            owned = {id(getattr(listener, "coalescer", None)) for listener in self._listeners}
            for c in list(self._coalescers):
                if id(c) not in owned and (exp is None or c.buckets == exp):
                    c.retarget(cb, ct)
            for listener in list(self._listeners):
                try:
                    listener.retarget_shapes(cb, ct, deadline_s, expect=exp)
                except Exception:
                    logger.exception("bucket retarget listener failed")

    def reset(self) -> None:
        """Test hook: forget the cap and the registrations."""
        with self._lock:
            self._cap = None
            self._coalescers.clear()
            self._listeners.clear()


_CAP_BUS = BucketCapBus()


def bucket_cap_bus() -> BucketCapBus:
    return _CAP_BUS


class MicroBatchCoalescer:
    """Merges stream batches into emissions that fill the bucket grid.

    Row mode: held ``(batch, ack)`` pairs are carved into emissions of
    EXACTLY the largest batch bucket, splitting the batch that straddles the
    boundary and sharing its ack across both emissions (``split_ack``).
    Token-budget mode (``token_budget``): emissions carve the held row
    prefix whose estimated token sum fills the budget
    (``extract.payload_token_estimates``), still on ROW boundaries, so the
    packed row count lands on the grid after ``pack_tokens``. The caller
    (the memory buffer) owns the deadline; ``pop_flush`` carves the
    remainder on deadline or close.

    Every emission carries a ``VecAck`` over its source acks (or their split
    shares): an acked emission acks exactly the sources whose rows it held,
    a nacked one nacks them.

    Poison isolation: the stream counts delivery attempts per emission
    fingerprint, so a poison source whose redeliveries kept regrouping with
    fresh traffic would mint a new fingerprint every round and be nacked
    forever. The coalescer therefore watches its sources' acks
    (``_SuspectObserverAck``): the sources of a nacked emission turn
    suspect, and a suspect re-arriving is emitted alone and first (the
    ``_solo`` queue), with the fingerprint the stream's budget counts, so
    quarantine fires. A suspect's final ack (delivered or quarantined)
    clears it. Hashing happens only on failure paths and on adds and acks
    whose row count matches a current suspect's.
    """

    #: bound on the suspect table; entries clear on ack, so this only
    #: matters with thousands of concurrently failing source batches
    MAX_SUSPECTS = 1024

    def __init__(self, batch_buckets: Sequence[int], *,
                 token_budget: Optional[int] = None,
                 token_field: Optional[str] = None,
                 token_bytes: Optional[float] = None,
                 max_row_tokens: Optional[int] = None):
        buckets = tuple(sorted(int(b) for b in batch_buckets))
        if not buckets or buckets[0] <= 0:
            raise ConfigError("coalesce batch_buckets must be non-empty positive ints")
        if token_budget is not None and token_budget < 1:
            raise ConfigError(
                f"coalesce token_budget must be a positive int, got {token_budget}")
        if token_bytes is not None and token_bytes <= 0:
            raise ConfigError(f"coalesce token_bytes must be positive, got {token_bytes}")
        if max_row_tokens is not None and max_row_tokens < 1:
            raise ConfigError(f"coalesce max_row_tokens must be >= 1, got {max_row_tokens}")
        self.buckets = buckets
        self.target = buckets[-1]
        #: token-budget mode: emissions carve this many estimated tokens
        #: instead of ``target`` rows (None = row mode)
        self.token_budget = int(token_budget) if token_budget is not None else None
        self._token_field = token_field or DEFAULT_BINARY_VALUE_FIELD
        self._token_bytes = token_bytes
        self._max_row_tokens = max_row_tokens
        #: held entries: (batch, ack, per-row token estimates or None)
        self._held: deque[tuple[MessageBatch, Ack, Optional[np.ndarray]]] = deque()
        #: suspect (previously nacked) batches, emitted alone and first
        self._solo: deque[tuple[MessageBatch, Ack, Optional[np.ndarray]]] = deque()
        #: fingerprint -> row count of each current suspect source batch
        self._suspects: dict[bytes, int] = {}
        #: row counts of the current suspects: an add or ack whose row count
        #: is not here skips the hash
        self._suspect_rows: set[int] = set()
        #: suspect batches emitted alone so far
        self.solo_emissions = 0
        self._rows = 0
        self._tokens = 0

    @property
    def rows(self) -> int:
        return self._rows

    @property
    def tokens(self) -> int:
        """Estimated tokens held (token-budget mode; 0 in row mode)."""
        return self._tokens

    @property
    def pending(self) -> int:
        """Held entries (suspects' solo entries and zero-row batches whose
        acks still wait included)."""
        return len(self._held) + len(self._solo)

    @property
    def suspects(self) -> int:
        """Source batches currently suspect."""
        return len(self._suspects)

    def cap(self, max_bucket: int) -> None:
        """Shrink the target grid after a device OOM (``BucketCapBus``):
        drop the buckets above ``max_bucket``; if none is left the cap is
        the only bucket. Token-budget mode shrinks the budget by the same
        ratio. Held rows drain at the new target."""
        fitting = tuple(b for b in self.buckets if b <= max_bucket)
        if not fitting:
            fitting = (max(1, int(max_bucket)),)
        if fitting == self.buckets:
            return
        if self.token_budget is not None:
            self.token_budget = max(1, int(self.token_budget * fitting[-1] / self.target))
        self.buckets = fitting
        self.target = fitting[-1]

    def retarget(self, batch_buckets: Sequence[int],
                 token_budget: Optional[int] = None) -> None:
        """Adopt a new target grid (a tuner commit, ``BucketCapBus.retarget``),
        in either direction: the runner's grid flipped and every new shape
        was captured first. Held rows drain at the new target. The budget
        changes only in token mode (a mode change would change what an
        emission is); None leaves it."""
        buckets = tuple(sorted(int(b) for b in batch_buckets))
        if not buckets or buckets[0] <= 0:
            return
        self.buckets = buckets
        self.target = buckets[-1]
        if token_budget is not None and self.token_budget is not None:
            self.token_budget = max(1, int(token_budget))

    def _row_tokens(self, batch: MessageBatch) -> np.ndarray:
        """Per-row estimates off the payload column (binary or string). A
        batch without a usable payload column counts each row as ``max_row_tokens`` (or 1), so
        malformed traffic still flows instead of wedging the budget."""
        col = batch.column(self._token_field) if batch.has_column(self._token_field) else None
        if isinstance(col, VarlenColumn):
            return payload_token_estimates(col, token_bytes=self._token_bytes,
                                           max_tokens=self._max_row_tokens)
        return np.full(batch.num_rows, self._max_row_tokens or 1, dtype=np.int64)

    # -- suspect tracking --------------------------------------------------

    def _mark_suspect(self, batch: MessageBatch) -> None:
        key = batch_fingerprint(batch)
        if key not in self._suspects and len(self._suspects) >= self.MAX_SUSPECTS:
            self._suspects.pop(next(iter(self._suspects)))
        self._suspects[key] = batch.num_rows
        self._suspect_rows.add(batch.num_rows)

    def _clear_suspect(self, batch: MessageBatch) -> None:
        if batch.num_rows not in self._suspect_rows:
            return  # prefilter: a healthy ack never hashes
        if self._suspects.pop(batch_fingerprint(batch), None) is not None:
            self._suspect_rows = set(self._suspects.values())

    def add(self, batch: MessageBatch, ack: Ack) -> None:
        ack = _SuspectObserverAck(self, batch, ack)
        lens = self._row_tokens(batch) if self.token_budget is not None else None
        if (batch.num_rows in self._suspect_rows
                and batch_fingerprint(batch) in self._suspects):
            self._solo.append((batch, ack, lens))
        else:
            self._held.append((batch, ack, lens))
        self._rows += batch.num_rows
        if lens is not None:
            self._tokens += int(lens.sum())

    def _carve(self, rows: int) -> tuple[MessageBatch, Ack]:
        """Take exactly ``rows`` held rows as one emission, splitting the
        boundary batch (its source ack is shared across both emissions)."""
        parts: list[MessageBatch] = []
        acks: list[Ack] = []
        need = rows
        while need > 0:
            batch, ack, _ = self._held.popleft()
            if batch.num_rows <= need:
                parts.append(batch)
                acks.append(ack)
                need -= batch.num_rows
            else:
                head_ack, tail_ack = split_ack(ack, 2)
                parts.append(batch.slice(0, need))
                acks.append(head_ack)
                self._held.appendleft((batch.slice(need), tail_ack, None))
                need = 0
        self._rows -= rows
        return MessageBatch.concat(parts), VecAck(acks)

    def _carve_tokens(self, budget: int) -> tuple[MessageBatch, Ack]:
        """Take the longest held row prefix whose estimated token sum fits
        ``budget``, splitting the boundary batch at a row edge. A single row
        whose estimate alone exceeds the budget emits solo: downstream
        packing and truncation own over-long rows."""
        parts: list[MessageBatch] = []
        acks: list[Ack] = []
        took_rows = 0
        took_tokens = 0
        need = budget
        while need > 0 and self._held:
            batch, ack, lens = self._held[0]
            total = int(lens.sum())
            if total <= need:
                self._held.popleft()
                parts.append(batch)
                acks.append(ack)
                took_rows += batch.num_rows
                took_tokens += total
                need -= total
                continue
            # boundary batch: rows [0, k) fit the remaining budget
            cs = np.cumsum(lens)
            k = int(np.searchsorted(cs, need, side="right"))
            if k == 0:
                if parts:
                    break  # the next row alone would overflow: emit under budget
                k = 1  # a single over-budget row still has to flow
            self._held.popleft()
            if k >= batch.num_rows:
                # the whole batch fits after all (one over-budget row): take
                # it intact rather than strand an empty tail and its share
                parts.append(batch)
                acks.append(ack)
                took_rows += batch.num_rows
                took_tokens += total
                break
            head_ack, tail_ack = split_ack(ack, 2)
            parts.append(batch.slice(0, k))
            acks.append(head_ack)
            self._held.appendleft((batch.slice(k), tail_ack, lens[k:]))
            took_rows += k
            took_tokens += int(cs[k - 1])
            break
        self._rows -= took_rows
        self._tokens -= took_tokens
        return MessageBatch.concat(parts), VecAck(acks)

    def _pop_solo(self) -> Optional[tuple[MessageBatch, Ack]]:
        if not self._solo:
            return None
        batch, ack, lens = self._solo.popleft()
        self.solo_emissions += 1
        self._rows -= batch.num_rows
        if lens is not None:
            self._tokens -= int(lens.sum())
        return batch, ack

    def pop_exact(self) -> Optional[tuple[MessageBatch, Ack]]:
        """Next emission: a suspect batch alone, else exactly ``target``
        rows (row mode) or a ``token_budget``-filling row prefix (token
        mode); None until held rows reach it."""
        emission = self._pop_solo()
        if emission is not None:
            return emission
        if self.token_budget is not None:
            if self._tokens < self.token_budget:
                return None
            return self._carve_tokens(self.token_budget)
        if self._rows < self.target:
            return None
        return self._carve(self.target)

    def _take_all(self) -> tuple[MessageBatch, Ack]:
        """Every held (non-suspect) entry as one emission; called with the
        solo queue drained."""
        parts = [b for b, _, _ in self._held]
        acks = VecAck([a for _, a, _ in self._held])
        self._held.clear()
        self._rows = 0
        self._tokens = 0
        return MessageBatch.concat(parts), acks

    def pop_flush(self) -> Optional[tuple[MessageBatch, Ack]]:
        """Deadline/close flush, one emission per call. Row mode: carve the
        LARGEST bucket the held rows fill exactly (40 rows against [8, 16,
        32] emit 32, then 8), and the sub-minimum remainder as one batch.
        Token mode: full-budget emissions first, then the whole remainder as
        one batch (the packer right-sizes its row count to a smaller bucket).
        Suspects drain through ``pop_exact`` first."""
        emission = self.pop_exact()
        if emission is not None:
            return emission
        if not self._held:
            return None
        if self.token_budget is None:
            fitting = [b for b in self.buckets if b <= self._rows]
            if fitting:
                return self._carve(fitting[-1])
        return self._take_all()


class _SuspectObserverAck:
    """A source's ack as the coalescer holds it: a nack marks the source
    suspect (its redelivery emits alone), a final ack (delivered or
    quarantined) clears it."""

    __slots__ = ("_coalescer", "_batch", "_inner")

    def __init__(self, coalescer: MicroBatchCoalescer, batch: MessageBatch, inner: Ack):
        self._coalescer = coalescer
        self._batch = batch
        self._inner = inner

    @property
    def redeliverable(self) -> bool:
        return bool(getattr(self._inner, "redeliverable", False))

    async def ack(self) -> None:
        self._coalescer._clear_suspect(self._batch)
        await self._inner.ack()

    async def nack(self) -> None:
        # mark before the inner nack: the source may requeue at once, and
        # the redelivered write must already see the suspicion
        self._coalescer._mark_suspect(self._batch)
        await self._inner.nack()
