# Copied from src/repro/obs/metrics.py.
"""Counters, gauges, streaming fixed-bucket histograms, and windowed
time series — the fleet simulator's live signals.

Instruments are registered by dotted name (``fleet.queue_depth``,
``planner.screen_combos``; see CONTRIBUTING "Metric naming") in a
:class:`MetricsRegistry`.  Besides the live instruments, the registry
holds *time series*: ``record(name, t, value)`` appends one sample at
simulated (or wall) time ``t`` — this is what the cluster model's
windowed sampler writes every ``window_s`` of simulated time, and what
``TelemetryReport.timeseries`` reads back as NumPy arrays.

The histogram is streaming and fixed-bucket: ``observe`` is O(log
n_buckets) with no per-sample allocation, percentiles interpolate
within the bucket — the standard telemetry trade (bounded memory, small
quantile error) rather than keeping every sample.
"""
from __future__ import annotations

from bisect import bisect_left
from typing import Optional

import numpy as np


def labelled(base: str, **labels) -> str:
    """``labelled("runtime.stage_s", k=2)`` -> ``"runtime.stage_s{k=2}"``.

    The one canonical label spelling (sorted keys, no spaces), so
    subsystems registering the same logical metric collide on the same
    name instead of fragmenting the registry.
    """
    if not labels:
        return base
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{base}{{{inner}}}"


class Counter:
    """Monotonic float counter."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name, self.value = name, 0.0

    def inc(self, v: float = 1.0) -> None:
        self.value += v


class Gauge:
    """Last-write-wins instantaneous value (may go up and down)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name, self.value = name, 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def add(self, v: float) -> None:
        self.value += v


def latency_buckets(lo: float = 1e-5, hi: float = 100.0,
                    per_decade: int = 9) -> tuple:
    """Log-spaced bucket upper bounds covering [lo, hi] seconds."""
    n_dec = np.log10(hi / lo)
    n = int(round(n_dec * per_decade)) + 1
    return tuple(float(b) for b in np.geomspace(lo, hi, n))


class Histogram:
    """Streaming fixed-bucket histogram (upper-bound buckets + +inf)."""

    __slots__ = ("name", "bounds", "counts", "n", "total", "vmin", "vmax")

    def __init__(self, name: str, bounds=None):
        self.name = name
        self.bounds = tuple(sorted(bounds)) if bounds else latency_buckets()
        self.counts = [0] * (len(self.bounds) + 1)   # last = overflow
        self.reset()

    def reset(self) -> None:
        for i in range(len(self.counts)):
            self.counts[i] = 0
        self.n, self.total = 0, 0.0
        self.vmin, self.vmax = float("inf"), float("-inf")

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.bounds, v)] += 1
        self.n += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def mean(self) -> float:
        return self.total / self.n if self.n else float("nan")

    def percentile(self, p: float) -> float:
        """Quantile estimate: linear interpolation inside the bucket the
        target rank lands in, clamped to the observed [min, max]."""
        if not self.n:
            return float("nan")
        rank = (p / 100.0) * self.n
        cum = 0
        for i, c in enumerate(self.counts):
            if not c:
                continue
            if cum + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else min(self.vmin, 0.0)
                hi = (self.bounds[i] if i < len(self.bounds)
                      else self.vmax)
                frac = (rank - cum) / c
                est = lo + frac * (hi - lo)
                return float(min(max(est, self.vmin), self.vmax))
            cum += c
        return self.vmax


class MetricsRegistry:
    """Get-or-create instruments by name + append-only time series."""

    def __init__(self):
        self._instruments: dict = {}
        self._series: dict = {}

    def _get(self, name: str, cls, *args):
        inst = self._instruments.get(name)
        if inst is None:
            inst = self._instruments[name] = cls(name, *args)
        elif not isinstance(inst, cls):
            raise TypeError(f"metric {name!r} already registered as "
                            f"{type(inst).__name__}, not {cls.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, bounds=None) -> Histogram:
        return self._get(name, Histogram, bounds)

    # ------------------------------------------------------ time series ----
    def record(self, name: str, t: float, value: float) -> None:
        self._series.setdefault(name, []).append((float(t), float(value)))

    def timeseries(self, name: str) -> tuple:
        """``(times, values)`` NumPy arrays (empty when never recorded)."""
        rows = self._series.get(name, ())
        if not rows:
            return np.empty(0), np.empty(0)
        a = np.asarray(rows)
        return a[:, 0], a[:, 1]

    def series_names(self) -> list:
        return sorted(self._series)

    def names(self) -> list:
        return sorted(self._instruments)

    def snapshot(self) -> dict:
        """Current value of every instrument (histograms report count)."""
        out = {}
        for name, inst in sorted(self._instruments.items()):
            out[name] = inst.n if isinstance(inst, Histogram) else inst.value
        return out

    def get(self, name: str) -> Optional[object]:
        return self._instruments.get(name)
