"""Named counters, gauges, and fixed-bucket histograms (twin of
``repro/obs/metrics.py``).

Two kinds of registry share one implementation:

  * the **process-global** :data:`REGISTRY`, the sink every instrumented
    module (dispatch, serve, train) records into.  Its instruments consult
    :func:`repro_torch.obs.trace.enabled` on every mutation, so with
    observability off each one returns after that check;
  * **private always-on registries**, e.g. the serve ``Scheduler``'s, the
    backing store of its ``stats`` view.  ``Registry(on=None)`` (the
    default) records unconditionally.

Instruments are created once and cached by name (module-level references are
the intended usage: no per-call dict lookups on hot paths); ``reset()``
zeroes values in place so cached references stay valid.  ``snapshot()``
returns a plain-JSON nested dict suitable for embedding in a trace file's
``otherData`` or a benchmark report.

Histograms use fixed geometric buckets (default: factor-2 from 1 µs when the
recorded unit is seconds: 40 buckets cover ~9 decades).  Percentiles are
nearest-rank over the bucket counts and return the **upper edge** of the
bucket holding the ranked sample, so the estimate always bounds the true
percentile from above and is off by at most one bucket ratio; the exact
observed min/max tighten the ends.
"""
from __future__ import annotations

import math
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs import trace as _trace

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY", "exp_buckets",
    "counter", "gauge", "histogram", "snapshot", "reset",
]


def exp_buckets(start: float = 1e-6, factor: float = 2.0,
                count: int = 40) -> Tuple[float, ...]:
    """Geometric bucket upper bounds ``start * factor**i``; the implicit
    final bucket is ``(last, inf)``."""
    if start <= 0 or factor <= 1 or count < 1:
        raise ValueError(f"bad bucket spec start={start} factor={factor} "
                         f"count={count}")
    return tuple(start * factor ** i for i in range(count))


DEFAULT_BUCKETS = exp_buckets()


class _Instrument:
    __slots__ = ("name", "_on", "_lock")

    def __init__(self, name: str, on: Optional[Callable[[], bool]],
                 lock: threading.Lock):
        self.name = name
        self._on = on
        self._lock = lock

    def _recording(self) -> bool:
        return self._on is None or self._on()


class Counter(_Instrument):
    """Monotonic accumulator (ints or float totals like seconds)."""

    __slots__ = ("_value",)

    def __init__(self, name, on, lock):
        super().__init__(name, on, lock)
        self._value = 0

    def inc(self, n=1) -> None:
        if not self._recording():
            return
        with self._lock:
            self._value += n

    @property
    def value(self):
        return self._value

    def _reset(self) -> None:
        self._value = 0


class Gauge(_Instrument):
    """Last-write-wins point-in-time value (queue depth, slot occupancy)."""

    __slots__ = ("_value",)

    def __init__(self, name, on, lock):
        super().__init__(name, on, lock)
        self._value = 0

    def set(self, v) -> None:
        if not self._recording():
            return
        self._value = v

    @property
    def value(self):
        return self._value

    def _reset(self) -> None:
        self._value = 0


class Histogram(_Instrument):
    """Fixed-bucket histogram with nearest-rank percentile estimates."""

    __slots__ = ("buckets", "_counts", "_count", "_sum", "_min", "_max")

    def __init__(self, name, on, lock, buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, on, lock)
        b = tuple(float(x) for x in buckets)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError(f"histogram buckets must be strictly "
                             f"increasing, got {b!r}")
        self.buckets = b
        self._counts = [0] * (len(b) + 1)  # +1: overflow bucket (last, inf)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, v: float) -> None:
        if not self._recording():
            return
        v = float(v)
        # binary search for the first bucket whose upper edge holds v
        lo, hi = 0, len(self.buckets)
        while lo < hi:
            mid = (lo + hi) // 2
            if v <= self.buckets[mid]:
                hi = mid
            else:
                lo = mid + 1
        with self._lock:
            self._counts[lo] += 1
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile estimate: the upper edge of the bucket
        containing the ranked sample (exact observed max for the overflow
        bucket / p=100, exact min when the rank lands in the first occupied
        bucket's floor).  0.0 when empty."""
        if self._count == 0:
            return 0.0
        if not 0 <= p <= 100:
            raise ValueError(f"percentile p={p} outside [0, 100]")
        rank = max(int(math.ceil(p / 100.0 * self._count)), 1)
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= rank:
                if i >= len(self.buckets):
                    return self._max  # overflow bucket: max is exact
                return min(self.buckets[i], self._max)
        return self._max

    def summary(self) -> Dict[str, float]:
        return {
            "count": self._count,
            "sum": self._sum,
            "min": 0.0 if self._count == 0 else self._min,
            "max": 0.0 if self._count == 0 else self._max,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
        }

    def _reset(self) -> None:
        self._counts = [0] * (len(self.buckets) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf


class Registry:
    """Get-or-create store of named instruments.

    ``on`` gates every instrument's mutators; the process-global
    :data:`REGISTRY` passes :func:`repro_torch.obs.trace.enabled`, private
    registries pass ``None`` (always record).
    """

    def __init__(self, on: Optional[Callable[[], bool]] = None):
        self._on = on
        self._lock = threading.Lock()
        self._instruments: Dict[str, _Instrument] = {}

    def _get(self, name: str, cls, **kwargs):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, self._on, self._lock, **kwargs)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(name, Histogram, buckets=buckets)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._instruments)

    def snapshot(self) -> Dict[str, Dict]:
        """Plain-JSON view: {"counters": {...}, "gauges": {...},
        "histograms": {name: {count, sum, min, max, p50, p90, p99}}}."""
        with self._lock:
            insts = list(self._instruments.values())
        out: Dict[str, Dict] = {"counters": {}, "gauges": {}, "histograms": {}}
        for inst in insts:
            if isinstance(inst, Counter):
                out["counters"][inst.name] = inst.value
            elif isinstance(inst, Gauge):
                out["gauges"][inst.name] = inst.value
            elif isinstance(inst, Histogram):
                out["histograms"][inst.name] = inst.summary()
        return out

    def reset(self) -> None:
        """Zero every instrument IN PLACE: cached references stay valid."""
        with self._lock:
            for inst in self._instruments.values():
                inst._reset()


# the process-global sink; its instruments are no-ops while obs is disabled
REGISTRY = Registry(on=_trace.enabled)


def counter(name: str) -> Counter:
    return REGISTRY.counter(name)


def gauge(name: str) -> Gauge:
    return REGISTRY.gauge(name)


def histogram(name: str, buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
    return REGISTRY.histogram(name, buckets=buckets)


def snapshot() -> Dict[str, Dict]:
    return REGISTRY.snapshot()


def reset() -> None:
    REGISTRY.reset()
