# Copied from src/repro/netsim/events.py; scheduling in the past raises ValueError.
"""The shared discrete-event engine (the *supervisor* layer, paper §IV).

One implementation serves every simulator in the repo: the per-flow
transport models in ``repro_torch.netsim.protocols`` and the fleet-scale cluster
model in ``repro_torch.fleet.cluster`` both schedule onto this queue — there is
deliberately no second event loop anywhere.

Executes events in correct temporal order; callbacks may schedule further
events.  Deterministic tie-breaking by insertion sequence keeps runs
reproducible.  ``schedule`` returns an :class:`EventHandle` so timers that
become moot (TCP retransmission timeouts after the ACK, dynamic-batching
windows that fill early) can be cancelled instead of firing dead.

Telemetry: pass a ``repro_torch.obs.Recorder`` as ``obs`` and every fired
event becomes an instant span on the simulated clock (named by the
``label`` given to :meth:`EventQueue.schedule_named`, falling back to
the callback's qualname) plus ``events.fired`` / ``events.cancelled``
counters; each :meth:`run` is wrapped in an event-chain span.  Cancelled
events are *counted, never spanned* — a span means the callback ran.
With the default :data:`repro_torch.obs.NULL` recorder the hot loop is the
uninstrumented one (dispatch happens once per ``run`` call, not per
event), so tracing off costs nothing measurable.
"""
from __future__ import annotations

import heapq
from typing import Callable

from repro_torch.obs import NULL


class EventHandle:
    """Cancellation token for a scheduled event.

    ``cancel`` after the event already fired is a harmless no-op: the
    event left the heap when it ran, so the flag is never read again.
    ``label`` is telemetry metadata — set only when ``schedule`` was
    given one (the slot stays unset otherwise, keeping handle
    construction on the hot path as cheap as the uninstrumented
    engine's; the traced loop reads it with ``getattr``).
    """

    __slots__ = ("time", "seq", "cancelled", "label")

    def __init__(self, time: float, seq: int):
        self.time = time
        self.seq = seq
        self.cancelled = False

    def cancel(self) -> None:
        self.cancelled = True


class EventQueue:
    def __init__(self, obs=None):
        self._q = []
        self._seq = 0
        self.now = 0.0
        self.n_fired = 0          # events executed (cancelled ones excluded)
        self.n_cancelled = 0
        self.obs = NULL if obs is None else obs

    def schedule(self, time: float, fn: Callable[[], None]) -> EventHandle:
        if time < self.now - 1e-12:
            raise ValueError(f"event at {time} scheduled in the past ({self.now})")
        h = EventHandle(time, self._seq)
        heapq.heappush(self._q, (time, self._seq, fn, h))
        self._seq += 1
        return h

    def schedule_named(self, time: float, fn: Callable[[], None],
                       label: str) -> EventHandle:
        """:meth:`schedule` plus a telemetry label naming the event's
        instant span in exported traces.  A separate method (one extra
        attribute store) so the unlabelled hot path stays exactly the
        uninstrumented engine's — even a defaulted ``label=None``
        parameter on :meth:`schedule` costs a measurable fraction of a
        bare event cycle."""
        h = self.schedule(time, fn)
        h.label = label
        return h

    def peek(self) -> float:
        """Time of the next live event (inf when drained)."""
        while self._q and self._q[0][3].cancelled:
            heapq.heappop(self._q)
        return self._q[0][0] if self._q else float("inf")

    def run(self, until: float = float("inf"), max_events: int = 10_000_000) -> None:
        if self.obs.enabled:
            return self._run_traced(until, max_events)
        n = 0
        while self._q and self._q[0][0] <= until:
            t, _, fn, h = heapq.heappop(self._q)
            if h.cancelled:
                self.n_cancelled += 1
                continue
            self.now = t
            fn()
            n += 1
            self.n_fired += 1
            if n >= max_events:
                raise RuntimeError("event budget exceeded (livelock?)")

    def _run_traced(self, until: float, max_events: int) -> None:
        """The recording twin of :meth:`run` — same semantics, plus an
        instant span per fired event and fired/cancelled counters.  Kept
        separate so the null path above stays the bare hot loop."""
        tracer = self.obs.tracer
        c_fired = self.obs.metrics.counter("events.fired")
        c_cancelled = self.obs.metrics.counter("events.cancelled")
        t_start, n = self.now, 0
        while self._q and self._q[0][0] <= until:
            t, _, fn, h = heapq.heappop(self._q)
            if h.cancelled:
                self.n_cancelled += 1
                c_cancelled.inc()
                continue
            self.now = t
            tracer.instant(getattr(h, "label", None)
                           or getattr(fn, "__qualname__", "event"),
                           t, clock="sim", tid="events", cat="event")
            fn()
            n += 1
            self.n_fired += 1
            c_fired.inc()
            if n >= max_events:
                raise RuntimeError("event budget exceeded (livelock?)")
        if n:
            tracer.add("event-chain", t_start, self.now, clock="sim",
                       tid="events", cat="event", args={"n_events": n})

    def empty(self) -> bool:
        return self.peek() == float("inf")
