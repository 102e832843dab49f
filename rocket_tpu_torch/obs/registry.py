"""The run's metrics registry: counters, gauges and log-bucketed histograms
(counterpart of ``rocket_tpu/obs/registry.py``).

Everything here is host arithmetic under a lock, so an instrumented step
never touches the device. The sources that feed it: the card's allocator
watermarks (:meth:`MetricsRegistry.record_device_memory`, at tracker-flush
cadence), the health monitor (``health/*``), the watchdog's stall count,
the Profiler's ``perf/*`` gauges and the goodput fractions. Snapshots go to
every Tracker backend under ``obs/*`` at a flush and into
``telemetry.json`` at the end of a run. The instrument names and the
histogram buckets (powers of two over ``base``) are the reference's, so
the two packages' snapshots of the same observations are equal.
"""

from __future__ import annotations

import math
import threading
from typing import Optional

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "estimate_quantiles"]


class Counter:
    """A count that only grows (events seen, stalls fired)."""

    __slots__ = ("_total", "_guard")

    def __init__(self) -> None:
        self._total = 0.0
        self._guard = threading.Lock()

    def inc(self, amount: float = 1.0) -> None:
        with self._guard:
            self._total += amount

    def reset(self) -> None:
        with self._guard:
            self._total = 0.0

    @property
    def value(self) -> float:
        return self._total


class Gauge:
    """The last value written (a queue depth, allocated bytes); None until set."""

    __slots__ = ("_last",)

    def __init__(self) -> None:
        self._last: Optional[float] = None

    def set(self, value: float) -> None:
        self._last = float(value)

    @property
    def value(self) -> Optional[float]:
        return self._last


def _bucket(value: float, base: float) -> int:
    """Exponent k of the smallest ``base * 2**k`` at or above ``value``
    (0 for anything up to ``base``)."""
    scaled = max(value, 0.0) / base
    return 0 if scaled <= 1.0 else math.ceil(math.log2(scaled))


class Histogram:
    """Count, sum, extremes and power-of-two buckets of observed values:
    bucket ``le_U`` holds the values in ``(U / 2, U]``, U = ``base * 2**k``,
    enough range for microseconds up to hours with no configuration."""

    __slots__ = ("count", "total", "min", "max", "buckets", "base", "_guard")

    def __init__(self, base: float = 1e-6) -> None:
        self.base = base
        self._guard = threading.Lock()
        self._zero()

    def _zero(self) -> None:
        self.count, self.total = 0, 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self.buckets: dict = {}  # exponent -> count

    def observe(self, value: float) -> None:
        v = float(value)
        k = _bucket(v, self.base)
        with self._guard:
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self.buckets[k] = self.buckets.get(k, 0) + 1

    def reset(self) -> None:
        """Empty it in place: whoever holds this instrument keeps observing
        into the same object (a window's mark)."""
        with self._guard:
            self._zero()

    @property
    def mean(self) -> Optional[float]:
        return self.total / self.count if self.count else None

    def snapshot(self) -> dict:
        return {"count": self.count, "total": self.total, "mean": self.mean,
                "min": self.min, "max": self.max,
                "buckets": {f"le_{self.base * 2 ** k:g}": n
                            for k, n in sorted(self.buckets.items())}}


def estimate_quantiles(snapshot: dict, qs=(0.5, 0.9, 0.99)) -> dict:
    """``{"p50": ..., ...}`` from a :meth:`Histogram.snapshot` (the form
    ``telemetry.json`` stores, so a report needs no live instrument). Inside
    the bucket that holds the rank the value is interpolated geometrically
    (the buckets are log-spaced), then clamped to the recorded min and max.
    An empty or malformed record gives ``{}``."""
    try:
        count = int(snapshot.get("count") or 0)
        edges = sorted((float(key[3:]), int(n))
                       for key, n in (snapshot.get("buckets") or {}).items()
                       if key.startswith("le_"))
    except (AttributeError, TypeError, ValueError):
        return {}
    if count <= 0 or not edges:
        return {}
    low, high = snapshot.get("min"), snapshot.get("max")
    result = {}
    for q in qs:
        rank, seen = q * count, 0
        for upper, n in edges:
            seen += n
            if seen < rank:
                continue
            inside = 1.0 - (seen - rank) / n if n else 1.0
            value = upper / 2.0 * 2.0 ** inside
            if isinstance(low, (int, float)):
                value = max(value, float(low))
            if isinstance(high, (int, float)):
                value = min(value, float(high))
            result[f"p{int(q * 100)}"] = value
            break
    return result


class MetricsRegistry:
    """Name -> instrument, each made on first use and kept for the run."""

    def __init__(self) -> None:
        self._guard = threading.Lock()
        self._kinds: dict = {"counter": {}, "gauge": {}, "histogram": {}}

    def _get(self, kind: str, name: str, make):
        with self._guard:
            table = self._kinds[kind]
            if name not in table:
                table[name] = make()
            return table[name]

    def counter(self, name: str) -> Counter:
        return self._get("counter", name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get("gauge", name, Gauge)

    def histogram(self, name: str, base: float = 1e-6) -> Histogram:
        return self._get("histogram", name, lambda: Histogram(base=base))

    def reset(self, prefix: str = "") -> int:
        """Zero the counters and histograms whose name starts with
        ``prefix`` (gauges are simply written again); the instruments stay
        registered. Returns how many were reset."""
        with self._guard:
            hits = [inst for kind in ("counter", "histogram")
                    for name, inst in self._kinds[kind].items() if name.startswith(prefix)]
        for inst in hits:
            inst.reset()
        return len(hits)

    def record_device_memory(self) -> None:
        """The CUDA caching allocator's bytes in use and their peak, as the
        reference's HBM gauges (``hbm/bytes_in_use_max``,
        ``hbm/peak_bytes_in_use_max``), the largest over the visible cards.
        ``torch.cuda.memory_stats`` is a host-side query of the allocator: no
        transfer, no sync. Without a card nothing is written, as the
        reference writes nothing for a CPU backend."""
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return
        in_use, peak = [], []
        for index in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(index)
            if "allocated_bytes.all.current" in stats:
                in_use.append(stats["allocated_bytes.all.current"])
                peak.append(stats["allocated_bytes.all.peak"])
        if in_use:
            self.gauge("hbm/bytes_in_use_max").set(max(in_use))
            self.gauge("hbm/peak_bytes_in_use_max").set(max(peak))

    def snapshot(self) -> dict:
        """Every instrument, structured (``telemetry.json``)."""
        with self._guard:
            counters = {n: c.value for n, c in self._kinds["counter"].items()}
            gauges = {n: g.value for n, g in self._kinds["gauge"].items() if g.value is not None}
            hists = {n: h.snapshot() for n, h in self._kinds["histogram"].items()}
        return {"counters": counters, "gauges": gauges, "histograms": hists}

    def scalars(self) -> dict:
        """A flat ``name -> float`` view for tracker backends: counters and
        set gauges as they are, each histogram as ``/count`` and ``/mean``."""
        flat: dict = {}
        with self._guard:
            flat.update((n, c.value) for n, c in self._kinds["counter"].items())
            flat.update((n, g.value) for n, g in self._kinds["gauge"].items()
                        if g.value is not None)
            for name, h in self._kinds["histogram"].items():
                flat[f"{name}/count"] = float(h.count)
                if h.count:
                    flat[f"{name}/mean"] = h.total / h.count
        return flat
