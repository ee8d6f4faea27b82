"""Exact-match response cache with in-flight request collapsing.

Counterpart of ``arkflow_tpu/runtime/respcache.py``, whole. Duplicate
deliveries are structural in a stream: at-least-once redelivery replays
batches after nacks, the ``burst`` and ``ack_dup`` faults mint duplicates,
and clients retry identical payloads. The cache answers them in front of
the device:

- **Key**: ``batch_fingerprint`` (data and broker provenance, without the
  ingest stamp and the ``__meta_ext_*`` columns), behind a model-version
  epoch. A redelivered batch and a byte-identical retry hash equal, so a
  hit returns the cached output arrays as they are: bitwise-equal answers.
  The tenant column is left out too, so tenant B may receive tenant A's
  answer to the same bytes, counted as B's hit.
- **Bounds**: LRU over ``capacity`` entries and a per-entry TTL.
- **In-flight collapsing**: N concurrent duplicates make one device step;
  the first caller computes while the rest await its future. A failed
  compute reaches every waiter and caches nothing, so the stream's
  nack/redelivery path keeps charge of retries.
- **Epochs**: a committed swap, a tuner flip or an integrity quarantine
  bumps the epoch (``bump_epoch``), which flushes every entry.

Single event loop: the bookkeeping runs on the loop, without a lock;
``compute`` may hop to executor threads.
"""

from __future__ import annotations

import asyncio
import time
from collections import OrderedDict
from typing import Any, Awaitable, Callable, Mapping, Optional

from arkflow_tpu_torch.errors import ConfigError
from arkflow_tpu_torch.obs import global_registry


class ResponseCache:
    def __init__(self, capacity: int, ttl_s: Optional[float] = None,
                 name: str = "model"):
        if capacity < 1:
            raise ConfigError(
                f"response_cache.capacity must be >= 1, got {capacity}")
        if ttl_s is not None and ttl_s <= 0:
            raise ConfigError(
                f"response_cache.ttl must be > 0, got {ttl_s}")
        self.capacity = capacity
        self.ttl_s = ttl_s
        #: model-version epoch folded into every key (``get_or_compute``):
        #: ``batch_fingerprint`` identifies the REQUEST, not the weights that
        #: answered it — after a hot-swap a byte-identical duplicate must
        #: miss, or the cache would serve bitwise pre-swap responses forever
        self._epoch = 0
        #: key -> (expires_at_monotonic | None, value); insertion order = LRU
        self._entries: "OrderedDict[bytes, tuple[Optional[float], Any]]" = OrderedDict()
        self._inflight: dict[bytes, asyncio.Future] = {}
        reg = global_registry()
        labels = {"model": name}
        self.m_hits = reg.counter(
            "arkflow_cache_hits_total",
            "response-cache hits (device step skipped)", labels)
        self.m_misses = reg.counter(
            "arkflow_cache_misses_total",
            "response-cache misses (device step paid)", labels)
        self.m_collapsed = reg.counter(
            "arkflow_cache_collapsed_total",
            "duplicate in-flight requests collapsed onto one device step", labels)
        self.m_evictions = reg.counter(
            "arkflow_cache_evictions_total",
            "entries evicted by LRU capacity or TTL expiry", labels)
        self.m_size = reg.gauge(
            "arkflow_cache_size", "response-cache resident entries", labels)
        self._name = name
        #: tenant label -> hit counter (cardinality-capped like the
        #: controller's tenant metrics; the long tail shares __other__)
        self._tenant_hits: dict[str, Any] = {}
        #: the stream's TenantPolicy (set_tenant_policy) — aligns label
        #: capping with the admission controller; None = default cap only
        self._tenant_policy = None
        #: per-INSTANCE counts for report(): the registry dedupes metric
        #: series on (name, labels), so two streams serving the same model
        #: share the counters above — /health must still report each
        #: cache's own traffic, not the pooled totals
        self.n_hits = self.n_misses = self.n_collapsed = self.n_evictions = 0

    @property
    def epoch(self) -> int:
        return self._epoch

    def bump_epoch(self) -> None:
        """A model swap committed: every cached response was computed by the
        OLD weights. The epoch in the key makes them unreachable (a post-swap
        duplicate misses and recomputes); the flush reclaims their memory
        now instead of waiting for LRU churn. In-flight computes keyed under
        the old epoch complete harmlessly — they store under a key no new
        lookup can form."""
        self._epoch += 1
        flushed = len(self._entries)
        if flushed:
            self._entries.clear()
            self.m_evictions.inc(flushed)
            self.n_evictions += flushed
            self.m_size.set(0)

    def set_tenant_policy(self, policy) -> None:
        """Adopt the stream's tenant policy (stream hook via the serving
        processor) so hit labels reserve configured tenants and honor
        ``max_tracked`` exactly like the admission controller's labels."""
        self._tenant_policy = policy

    def _count_tenant_hit(self, tenant: Optional[str]) -> None:
        """Tenant-labeled hit counter, bounded by the shared capping rule
        (``overload.cap_tenant_label``): past the cap the long tail shares
        one ``__other__`` series."""
        from arkflow_tpu_torch.runtime.overload import MAX_TENANT_LABELS, cap_tenant_label

        policy = self._tenant_policy
        label = cap_tenant_label(
            tenant, self._tenant_hits,
            reserved=(policy.weights if policy is not None else ()),
            cap=(policy.max_tracked if policy is not None
                 else MAX_TENANT_LABELS))
        c = self._tenant_hits.get(label)
        if c is None:
            c = self._tenant_hits[label] = global_registry().counter(
                "arkflow_cache_tenant_hits_total",
                "response-cache hits by tenant",
                {"model": self._name, "tenant": label})
        c.inc()

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, key: bytes) -> Optional[Any]:
        """Cached value for ``key`` (refreshing its LRU position), or None.
        Counts neither hit nor miss — ``get_or_compute`` owns the metrics."""
        entry = self._entries.get(key)
        if entry is None:
            return None
        expires_at, value = entry
        if expires_at is not None and time.monotonic() >= expires_at:
            del self._entries[key]
            self.m_evictions.inc()
            self.n_evictions += 1
            self.m_size.set(len(self._entries))
            return None
        self._entries.move_to_end(key)
        return value

    def store(self, key: bytes, value: Any) -> None:
        expires_at = (time.monotonic() + self.ttl_s
                      if self.ttl_s is not None else None)
        self._entries[key] = (expires_at, value)
        self._entries.move_to_end(key)
        while len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.m_evictions.inc()
            self.n_evictions += 1
        self.m_size.set(len(self._entries))

    async def get_or_compute(self, key: bytes,
                             compute: Callable[[], Awaitable[Any]],
                             tenant: Optional[str] = None) -> Any:
        """The serving-path entry point: cached value, a collapsed wait on
        an identical in-flight compute, or a fresh compute (stored on
        success). Exceptions from ``compute`` reach every collapsed caller
        and leave the cache untouched."""
        # the model-version epoch is part of the identity: the same request
        # against different weights is a different cache entry
        key = self._epoch.to_bytes(8, "big") + key
        hit = self.lookup(key)
        if hit is not None:
            self.m_hits.inc()
            self.n_hits += 1
            self._count_tenant_hit(tenant)
            return hit
        fut = self._inflight.get(key)
        if fut is not None:
            self.m_collapsed.inc()
            self.n_collapsed += 1
            self._count_tenant_hit(tenant)
            return await fut
        self.m_misses.inc()
        self.n_misses += 1
        fut = asyncio.get_running_loop().create_future()
        self._inflight[key] = fut
        try:
            value = await compute()
        except BaseException as e:
            if isinstance(e, Exception):
                fut.set_exception(e)
                # consume once so a storm with zero collapsed waiters does
                # not log "exception was never retrieved"; real waiters
                # still receive it from their awaits
                fut.exception()
            else:  # CancelledError etc.: wake waiters without caching
                fut.cancel()
            raise
        else:
            self.store(key, value)
            fut.set_result(value)
            return value
        finally:
            self._inflight.pop(key, None)

    def report(self) -> dict:
        """Snapshot for /health."""
        return {
            "entries": len(self._entries),
            "capacity": self.capacity,
            "ttl_s": self.ttl_s,
            "epoch": self._epoch,
            "hits": self.n_hits,
            "misses": self.n_misses,
            "collapsed": self.n_collapsed,
            "evictions": self.n_evictions,
        }


def parse_response_cache_config(config: Any) -> Optional[tuple[int, Optional[float]]]:
    """Validate ``response_cache`` config -> ``(capacity, ttl_s)``, or None
    when disabled. Pure parse: config.py runs this at ``--validate`` time
    without minting a cache (and its metric series) per validation pass."""
    from arkflow_tpu_torch.utils.duration import parse_duration

    if config is None or config is False:
        return None
    if config is True:
        config = {}
    if not isinstance(config, Mapping):
        raise ConfigError("response_cache must be a mapping or boolean")
    capacity = config.get("capacity", 1024)
    if isinstance(capacity, bool) or not isinstance(capacity, int) or capacity < 1:
        raise ConfigError(
            f"response_cache.capacity must be an int >= 1, got {capacity!r}")
    ttl = config.get("ttl")
    ttl_s = parse_duration(ttl) if ttl is not None else None
    if ttl_s is not None and ttl_s <= 0:
        raise ConfigError(f"response_cache.ttl must be > 0, got {ttl!r}")
    return int(capacity), ttl_s


def build_response_cache(config: Any, *, name: str) -> Optional[ResponseCache]:
    """``response_cache: {capacity: 1024, ttl: 30s}`` -> ResponseCache.
    ``None``/``false`` disables; ``true`` takes the defaults."""
    parsed = parse_response_cache_config(config)
    if parsed is None:
        return None
    capacity, ttl_s = parsed
    return ResponseCache(capacity, ttl_s, name=name)
