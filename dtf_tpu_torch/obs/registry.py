"""Metrics registry -- counters, gauges, histograms, one export format.

A copy of ``dtf_tpu/obs/registry.py`` (the port imports nothing of
dtf_tpu).  The export is the BenchmarkMetric record shape
({"name", "value", "unit"}) that ``utils/benchmark_logger.py`` writes.

Pure Python: percentile math uses the same linear interpolation as
numpy's default method.

Thread safety: every mutation takes the metric's lock.  Histograms
append to a bounded reservoir (beyond ``max_samples`` a deterministic
LCG picks replacement slots -- uniform reservoir sampling without
seeding global RNG state).
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Optional


class Counter:
    """Monotonic count (requests served, sheds, pushes, ...)."""

    def __init__(self, name: str, unit: str = ""):
        self.name = name
        self.unit = unit
        self._mu = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._mu:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def snapshot(self) -> dict:
        return {"type": "counter", "value": self._value}


class Gauge:
    """Last-written value (queue depth, slot occupancy, ...)."""

    def __init__(self, name: str, unit: str = ""):
        self.name = name
        self.unit = unit
        self._mu = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._mu:
            self._value = float(v)

    @property
    def value(self) -> float:
        return self._value

    def snapshot(self) -> dict:
        return {"type": "gauge", "value": self._value}


class Histogram:
    """Value distribution with percentile snapshots.

    Keeps up to ``max_samples`` observations; past that, each new value
    replaces a pseudo-uniformly chosen slot with probability
    max_samples/seen (classic reservoir sampling, deterministic LCG so
    runs are reproducible).  count/sum/min/max stay exact regardless.
    """

    PERCENTILES = (50.0, 90.0, 99.0)

    def __init__(self, name: str, unit: str = "", max_samples: int = 65536):
        self.name = name
        self.unit = unit
        self.max_samples = int(max_samples)
        self._mu = threading.Lock()
        self._samples: List[float] = []
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lcg = 0x2545F4914F6CDD1D

    def observe(self, v: float) -> None:
        v = float(v)
        with self._mu:
            self._count += 1
            self._sum += v
            if v < self._min:
                self._min = v
            if v > self._max:
                self._max = v
            if len(self._samples) < self.max_samples:
                self._samples.append(v)
            else:
                # reservoir: keep each of the `seen` values with equal
                # probability max_samples/seen
                self._lcg = (self._lcg * 6364136223846793005 + 1442695040888963407) % (1 << 64)
                j = self._lcg % self._count
                if j < self.max_samples:
                    self._samples[j] = v

    @property
    def count(self) -> int:
        return self._count

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def reset(self) -> None:
        """Drop all observations (the instrument stays registered).
        Benches use this to exclude warmup/compile traffic from the
        measured distribution — the engine's references stay live,
        unlike MetricsRegistry.reset() which drops the instruments."""
        with self._mu:
            self._samples.clear()
            self._count = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = -math.inf

    def percentile(self, q: float) -> float:
        """Linear-interpolated percentile over the reservoir — the same
        definition as numpy.percentile's default method."""
        with self._mu:
            data = sorted(self._samples)
        return percentile(data, q)

    def snapshot(self) -> dict:
        with self._mu:
            data = sorted(self._samples)
            count, total = self._count, self._sum
            lo = self._min if count else 0.0
            hi = self._max if count else 0.0
        out = {"type": "histogram", "count": count,
               "mean": (total / count if count else 0.0),
               "min": lo, "max": hi}
        for q in self.PERCENTILES:
            out[f"p{q:g}"] = percentile(data, q)
        return out


def percentile(sorted_data: List[float], q: float) -> float:
    """numpy.percentile(..., method='linear') over pre-sorted data."""
    n = len(sorted_data)
    if n == 0:
        return 0.0
    if n == 1:
        return float(sorted_data[0])
    pos = (q / 100.0) * (n - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, n - 1)
    frac = pos - lo
    return float(sorted_data[lo] * (1.0 - frac) + sorted_data[hi] * frac)


class MetricsRegistry:
    """Name → metric, get-or-create, one export.

    ``counter/gauge/histogram`` return the existing instrument when the
    name is already registered (and raise if it is registered as a
    different type — a silent type morph would corrupt the export)."""

    def __init__(self):
        self._mu = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get_or_create(self, cls, name: str, unit: str, **kw):
        with self._mu:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, unit=unit, **kw)
                self._metrics[name] = m
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str, unit: str = "") -> Counter:
        return self._get_or_create(Counter, name, unit)

    def gauge(self, name: str, unit: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, unit)

    def histogram(self, name: str, unit: str = "",
                  max_samples: int = 65536) -> Histogram:
        return self._get_or_create(Histogram, name, unit,
                                   max_samples=max_samples)

    def get(self, name: str):
        return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._mu:
            return sorted(self._metrics)

    def snapshot(self) -> Dict[str, dict]:
        """{name: metric snapshot} for logging/debug dumps."""
        with self._mu:
            items = list(self._metrics.items())
        return {name: m.snapshot() for name, m in items}

    def to_benchmark_metrics(self) -> List[dict]:
        """The existing BenchmarkMetric record format, one dict per
        scalar: counters/gauges export as themselves, histograms expand
        to ``<name>_p50/_p90/_p99/_mean`` plus ``<name>_count``."""
        out: List[dict] = []
        with self._mu:
            items = sorted(self._metrics.items())
        for name, m in items:
            snap = m.snapshot()
            if snap["type"] == "histogram":
                if not snap["count"]:
                    continue
                for q in Histogram.PERCENTILES:
                    key = f"p{q:g}"
                    out.append({"name": f"{name}_{key}",
                                "value": snap[key], "unit": m.unit})
                out.append({"name": f"{name}_mean", "value": snap["mean"],
                            "unit": m.unit})
                out.append({"name": f"{name}_count",
                            "value": float(snap["count"]), "unit": "count"})
            else:
                out.append({"name": name, "value": float(snap["value"]),
                            "unit": m.unit})
        return out

    def reset(self) -> None:
        with self._mu:
            self._metrics.clear()


_default: Optional[MetricsRegistry] = None
_default_mu = threading.Lock()


def default_registry() -> MetricsRegistry:
    """The process-global registry (the data service's reader lag,
    cache hit ratio and respawn count live here; subsystems with a
    natural owner -- the serve engine -- carry their own instance
    instead)."""
    global _default
    with _default_mu:
        if _default is None:
            _default = MetricsRegistry()
        return _default
