# Copied from src/repro/obs/__init__.py.
"""``repro_torch.obs`` — the unified telemetry layer: spans, fleet metrics,
Perfetto trace export.

Three pillars:

* :class:`Tracer` — hierarchical spans on two clocks (simulated and
  wall), exported as Chrome trace-event JSON for https://ui.perfetto.dev
  (``repro_torch.obs.trace``).
* :class:`MetricsRegistry` — counters, gauges, streaming fixed-bucket
  histograms, and the windowed time series the fleet simulator samples
  (``repro_torch.obs.metrics``).
* :data:`NULL` — the shared :class:`NullRecorder`: every instrumented
  hot path defaults to it, and guards with ``if obs.enabled:`` (or
  dispatches to an uninstrumented loop) so tracing costs nothing
  measurable when off.

A :class:`Recorder` bundles one tracer + one registry; instrumented
subsystems (``netsim.events``, ``fleet.cluster``, ``runtime.engine``,
``fleet.planner``, ``fleet.controller`` — the adaptive control loop's
``controller.*`` series/counters and replan/switch/era spans) take
``obs=`` and a :class:`TelemetryReport` (``Study.observe()``) reads
everything back.

Deliberately zero-dependency beyond NumPy: importable from the innermost
event loop, no jax, no repro imports outward.
"""
from __future__ import annotations

from repro_torch.obs.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                               labelled, latency_buckets)
from repro_torch.obs.report import TelemetryReport
from repro_torch.obs.trace import (Span, Tracer, chrome_events, write_chrome_trace)

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry", "labelled",
    "latency_buckets", "NULL", "NullRecorder", "Recorder", "Span",
    "TelemetryReport", "Tracer", "chrome_events", "write_chrome_trace",
]


class Recorder:
    """One tracer + one metrics registry; ``enabled`` is True.

    ``window_s`` is the default sampling window instrumented simulators
    use for windowed time series (``fleet.cluster`` reads it).
    """

    enabled = True

    def __init__(self, window_s: float = 0.05):
        self.tracer = Tracer()
        self.metrics = MetricsRegistry()
        self.window_s = window_s

    def report(self) -> TelemetryReport:
        return TelemetryReport(self)


# ------------------------------------------------------------- null path ----
class _NullSpan:
    """Inert span stand-in: context manager, ignores arg updates."""

    __slots__ = ("args",)

    def __init__(self):
        self.args = {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class _NullTracer:
    enabled = False
    spans: tuple = ()

    def wall_now(self) -> float:
        return 0.0

    def add(self, *a, **kw):
        return _NULL_SPAN

    def instant(self, *a, **kw):
        return _NULL_SPAN

    def extend(self, spans) -> None:
        pass

    def span(self, *a, **kw):
        return _NULL_SPAN


class _NullInstrument:
    __slots__ = ()
    value = 0.0
    n = 0

    def inc(self, v: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def add(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass

    def reset(self) -> None:
        pass

    def percentile(self, p: float) -> float:
        return float("nan")

    def mean(self) -> float:
        return float("nan")


_NULL_INSTRUMENT = _NullInstrument()


class _NullMetrics:
    def counter(self, name):
        return _NULL_INSTRUMENT

    def gauge(self, name):
        return _NULL_INSTRUMENT

    def histogram(self, name, bounds=None):
        return _NULL_INSTRUMENT

    def record(self, name, t, value) -> None:
        pass

    def timeseries(self, name):
        import numpy as np
        return np.empty(0), np.empty(0)

    def series_names(self) -> list:
        return []

    def names(self) -> list:
        return []

    def snapshot(self) -> dict:
        return {}

    def get(self, name):
        return None


class NullRecorder:
    """The off switch: same surface as :class:`Recorder`, every method a
    no-op, ``enabled`` False.  Instrumented code holds the shared
    :data:`NULL` instance by default and never allocates on the hot
    path."""

    enabled = False
    window_s = 0.05

    def __init__(self):
        self.tracer = _NullTracer()
        self.metrics = _NullMetrics()

    def report(self) -> TelemetryReport:
        return TelemetryReport(self)


NULL = NullRecorder()
