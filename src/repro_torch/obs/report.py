# Copied from src/repro/obs/report.py.
"""``TelemetryReport`` — the read side of a :class:`repro_torch.obs.Recorder`.

What ``Study.observe()`` hands back: one object that exports the
collected spans as a Perfetto-loadable Chrome trace, reads windowed
metric time series as NumPy arrays, and prints a text summary.  The
report is a *view*: it holds the live recorder, so it can be created
once and re-read as later pipeline stages add telemetry.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.obs.trace import write_chrome_trace


class TelemetryReport:
    """See module docstring.  Construct via ``Study.observe()`` or
    ``Recorder.report()``."""

    def __init__(self, recorder):
        self._rec = recorder

    @property
    def recorder(self):
        """The live recorder — hand it (``obs=report.recorder``) to
        simulators driven outside the Study so their telemetry lands in
        the same report."""
        return self._rec

    @property
    def spans(self) -> list:
        return self._rec.tracer.spans

    @property
    def metrics(self):
        return self._rec.metrics

    # ---------------------------------------------------------- export ----
    def to_chrome_trace(self, path: str, clock: str = "both",
                        metadata: Optional[dict] = None) -> str:
        """Write Chrome trace-event JSON; open the file at
        https://ui.perfetto.dev.  ``clock="sim"`` keeps only the
        simulated timeline (bit-reproducible under a seed — the CI
        artifact mode); ``"wall"`` only the host timeline; ``"both"``
        exports the two as separate Perfetto processes."""
        return write_chrome_trace(self.spans, path, clock=clock,
                                  metadata=metadata)

    def timeseries(self, name: str) -> tuple:
        """``(times, values)`` arrays of one windowed metric (e.g.
        ``"fleet.queue_depth"``); empty arrays when never recorded."""
        return self._rec.metrics.timeseries(name)

    def series_names(self) -> list:
        return self._rec.metrics.series_names()

    def counters(self) -> dict:
        return self._rec.metrics.snapshot()

    # --------------------------------------------------------- summary ----
    def summary(self, top: int = 8) -> str:
        """Span counts per category, instrument snapshot, and the
        recorded time series with their last sampled values."""
        lines = []
        by_cat: dict = {}
        for s in self.spans:
            by_cat[s.cat or s.clock] = by_cat.get(s.cat or s.clock, 0) + 1
        lines.append(f"telemetry: {len(self.spans)} spans"
                     + (" (" + ", ".join(f"{c}: {n}" for c, n in
                                         sorted(by_cat.items())) + ")"
                        if by_cat else ""))
        snap = self._rec.metrics.snapshot()
        if snap:
            lines.append("instruments:")
            for name, v in snap.items():
                lines.append(f"  {name:40s} {v:g}")
        names = self.series_names()
        if names:
            lines.append("time series (windowed):")
            for name in names:
                t, v = self.timeseries(name)
                lines.append(f"  {name:40s} {len(v):4d} samples, "
                             f"last {v[-1]:g} @ t={t[-1]:.3f}s")
        longest = sorted((s for s in self.spans if s.dur > 0),
                         key=lambda s: -s.dur)[:top]
        if longest:
            lines.append(f"longest spans (top {len(longest)}):")
            for s in longest:
                lines.append(f"  {s.name:32s} [{s.clock}] "
                             f"{s.dur * 1e3:10.3f} ms  {s.cat}")
        return "\n".join(lines)

    def __repr__(self):
        n_series = len(self.series_names())
        return (f"TelemetryReport({len(self.spans)} spans, "
                f"{len(self.counters())} instruments, "
                f"{n_series} time series)")

    # convenient aggregate used by tests and the example ------------------
    def span_total_s(self, name: str, clock: Optional[str] = None) -> float:
        """Summed duration of every span called ``name``."""
        return float(sum(s.dur for s in self.spans
                         if s.name == name
                         and (clock is None or s.clock == clock)))

    def window_percentile(self, name: str, p: float) -> float:
        """Percentile over a recorded time series' values (helper for
        quick assertions on windowed signals)."""
        _, v = self.timeseries(name)
        return float(np.percentile(v, p)) if len(v) else float("nan")
