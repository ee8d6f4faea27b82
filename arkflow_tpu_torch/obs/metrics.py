"""Metrics: counters, gauges and histograms with Prometheus text exposition.

Counterpart of ``arkflow_tpu/obs/metrics.py``, kept as the port's own copy
so the port imports nothing of the JAX package. Names, label sets, help
strings, buckets and the exposition text are the JAX package's, so one
dashboard reads either package. The stream's stages update these metrics on
the event loop, the runner's and the server's on executor and watchdog
threads too, so every mutation holds a per-metric lock (``+=`` on a float
is a read-modify-write). Reads of one float are lock-free. Histograms keep
fixed log-spaced buckets and a bounded reservoir for exact small-N
quantiles. The engine serves ``exposition()`` at ``GET /metrics``.
"""

from __future__ import annotations

import math
import random
import threading
import time
from typing import Iterable, Optional


class Counter:
    __slots__ = ("name", "help", "labels", "value", "_lock")

    def __init__(self, name: str, help_: str = "", labels: Optional[dict[str, str]] = None):
        self.name = name
        self.help = help_
        self.labels = labels or {}
        self.value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n


class Gauge:
    __slots__ = ("name", "help", "labels", "value", "_lock")

    def __init__(self, name: str, help_: str = "", labels: Optional[dict[str, str]] = None):
        self.name = name
        self.help = help_
        self.labels = labels or {}
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        self.value = float(v)  # single assignment: atomic enough

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self.value += n

    def dec(self, n: float = 1.0) -> None:
        with self._lock:
            self.value -= n


#: default latency buckets: 0.1ms .. ~100s, log-spaced
_DEFAULT_BUCKETS = tuple(0.0001 * (2.0 ** i) for i in range(21))


class Histogram:
    __slots__ = ("name", "help", "labels", "buckets", "counts", "sum", "count",
                 "_reservoir", "_rng", "_lock")

    RESERVOIR = 2048

    def __init__(self, name: str, help_: str = "", labels: Optional[dict[str, str]] = None,
                 buckets: Iterable[float] = _DEFAULT_BUCKETS):
        self.name = name
        self.help = help_
        self.labels = labels or {}
        self.buckets = tuple(sorted(buckets))
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0
        self._reservoir: list[float] = []
        self._rng = random.Random(0xA2C)
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        with self._lock:
            self.sum += v
            self.count += 1
            # linear scan is fine: ~21 buckets, and observe() is called per batch, not per row
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self.counts[i] += 1
                    break
            else:
                self.counts[-1] += 1
            r = self._reservoir
            if len(r) < self.RESERVOIR:
                r.append(v)
            else:
                j = self._rng.randrange(self.count)
                if j < self.RESERVOIR:
                    r[j] = v

    def quantile(self, q: float) -> float:
        with self._lock:
            s = sorted(self._reservoir)
        if not s:
            return math.nan
        idx = min(len(s) - 1, max(0, int(q * len(s))))
        return s[idx]

    def time(self):
        return _Timer(self)


class _Timer:
    __slots__ = ("h", "t0")

    def __init__(self, h: Histogram):
        self.h = h

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.h.observe(time.perf_counter() - self.t0)
        return False


class MetricsRegistry:
    def __init__(self) -> None:
        self._metrics: dict[tuple[str, tuple[tuple[str, str], ...]], object] = {}
        #: guards registration (get-or-create) — metric families are minted
        #: from worker threads too (pool members, watchdogs); without it two
        #: threads can each create the series and split its updates
        self._reg_lock = threading.Lock()

    def _key(self, name: str, labels: Optional[dict[str, str]]):
        return (name, tuple(sorted((labels or {}).items())))

    def counter(self, name: str, help_: str = "", labels: Optional[dict[str, str]] = None) -> Counter:
        k = self._key(name, labels)
        m = self._metrics.get(k)
        if m is None:
            with self._reg_lock:
                m = self._metrics.get(k)
                if m is None:
                    m = self._metrics[k] = Counter(name, help_, labels)
        return m  # type: ignore[return-value]

    def gauge(self, name: str, help_: str = "", labels: Optional[dict[str, str]] = None) -> Gauge:
        k = self._key(name, labels)
        m = self._metrics.get(k)
        if m is None:
            with self._reg_lock:
                m = self._metrics.get(k)
                if m is None:
                    m = self._metrics[k] = Gauge(name, help_, labels)
        return m  # type: ignore[return-value]

    def histogram(self, name: str, help_: str = "", labels: Optional[dict[str, str]] = None,
                  buckets: Iterable[float] = _DEFAULT_BUCKETS) -> Histogram:
        k = self._key(name, labels)
        m = self._metrics.get(k)
        if m is None:
            with self._reg_lock:
                m = self._metrics.get(k)
                if m is None:
                    m = self._metrics[k] = Histogram(name, help_, labels, buckets)
        return m  # type: ignore[return-value]

    def clear(self) -> None:
        self._metrics.clear()

    def collect(self) -> list[object]:
        return list(self._metrics.values())

    def sum_values(self, name: str) -> float:
        """Sum of a counter/gauge family across ALL label sets (e.g. every
        pool member's ``arkflow_tpu_step_deadline_misses``) — what chaos
        tests and the soak harness assert against."""
        return sum(m.value for m in self._metrics.values()
                   if isinstance(m, (Counter, Gauge)) and m.name == name)

    # -- Prometheus text exposition ---------------------------------------

    @staticmethod
    def _escape_label(v: str) -> str:
        """Text-format label escaping (backslash, quote, newline) — tenant
        ids and error strings are attacker-influenced, so an unescaped
        quote would corrupt the whole scrape."""
        return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")

    @classmethod
    def _fmt_labels(cls, labels: dict[str, str], extra: Optional[dict[str, str]] = None) -> str:
        all_labels = {**labels, **(extra or {})}
        if not all_labels:
            return ""
        inner = ",".join(f'{k}="{cls._escape_label(v)}"'
                         for k, v in sorted(all_labels.items()))
        return "{" + inner + "}"

    @staticmethod
    def _escape_help(text: str) -> str:
        return str(text).replace("\\", "\\\\").replace("\n", "\\n")

    @staticmethod
    def _fmt_le(b: float) -> str:
        # repr() keeps full float precision so cumulative buckets parse back
        # to the exact thresholds; integral thresholds render Prometheus
        # style ("1" not "1.0" is also accepted, keep repr for stability)
        return repr(b)

    def exposition(self) -> str:
        """Prometheus text format. Conformance notes: all samples of a
        metric family are CONTIGUOUS and preceded by exactly one # TYPE
        (families whose label sets were minted at different times must not
        interleave with other families); histogram buckets are cumulative
        with a terminal ``+Inf`` bucket equal to ``_count``; label values
        are escaped."""
        with self._reg_lock:
            metrics = list(self._metrics.values())
        by_name: dict[str, list] = {}
        for m in metrics:
            by_name.setdefault(m.name, []).append(m)  # type: ignore[attr-defined]
        lines: list[str] = []
        for name, family in by_name.items():
            first = family[0]
            kind = ("counter" if isinstance(first, Counter)
                    else "gauge" if isinstance(first, Gauge) else "histogram")
            if first.help:
                lines.append(f"# HELP {name} {self._escape_help(first.help)}")
            lines.append(f"# TYPE {name} {kind}")
            for m in family:
                if isinstance(m, (Counter, Gauge)):
                    lines.append(f"{name}{self._fmt_labels(m.labels)} {m.value}")
                elif isinstance(m, Histogram):
                    cum = 0
                    for b, c in zip(m.buckets, m.counts):
                        cum += c
                        lines.append(
                            f'{name}_bucket{self._fmt_labels(m.labels, {"le": self._fmt_le(b)})} {cum}')
                    cum += m.counts[-1]
                    lines.append(f'{name}_bucket{self._fmt_labels(m.labels, {"le": "+Inf"})} {cum}')
                    lines.append(f"{name}_sum{self._fmt_labels(m.labels)} {m.sum}")
                    lines.append(f"{name}_count{self._fmt_labels(m.labels)} {m.count}")
        return "\n".join(lines) + "\n"


_GLOBAL = MetricsRegistry()


def global_registry() -> MetricsRegistry:
    return _GLOBAL
