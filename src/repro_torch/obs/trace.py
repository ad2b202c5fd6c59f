# Copied from src/repro/obs/trace.py.
"""Hierarchical spans with two clocks, exported as Chrome trace-event
JSON (loadable at https://ui.perfetto.dev).

A :class:`Span` is one named interval on one *clock*:

* ``clock="sim"`` — simulated seconds on the shared discrete-event
  engine's timeline (``repro_torch.netsim.events.EventQueue.now``).  Sim spans
  are bit-reproducible across runs of the same seeded simulation, so a
  trace exported with ``clock="sim"`` is diffable in CI.
* ``clock="wall"`` — host seconds since the tracer's epoch
  (``time.perf_counter``-based), for the phases that really execute:
  planner screen/refine, runtime stage forwards, calibration sweeps.

The two timelines export as two Perfetto *processes* ("simulated clock"
pid 1, "wall clock" pid 2), each span's ``tid`` naming a track within
its process; span containment per track gives the hierarchy, so the
Chrome ``"X"`` complete-event encoding suffices (plus ``"i"`` instants
for zero-duration marks and ``"M"`` metadata naming the tracks).

Nothing here imports jax or any repro subsystem — the tracer must stay
importable from the innermost event loop.
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Optional

CLOCKS = ("sim", "wall")
_PID = {"sim": 1, "wall": 2}
_PROCESS_NAME = {"sim": "simulated clock", "wall": "wall clock"}


@dataclass
class Span:
    """One named interval; ``t0 == t1`` marks an instant event."""
    name: str
    t0: float
    t1: float
    clock: str = "sim"
    tid: str = "main"
    cat: str = ""
    args: dict = field(default_factory=dict)
    children: list = field(default_factory=list)

    @property
    def dur(self) -> float:
        return self.t1 - self.t0

    def walk(self):
        """This span, then every descendant (pre-order)."""
        yield self
        for c in self.children:
            yield from c.walk()


class Tracer:
    """Collects spans; see the module docstring for the clock model.

    ``add``/``instant`` record on an explicit timeline (simulation code
    passes ``EventQueue.now``); the :meth:`span` context manager times a
    wall-clock phase.  ``to_chrome_trace`` writes the Perfetto-loadable
    JSON.
    """

    def __init__(self):
        self.spans: list[Span] = []
        self._epoch = time.perf_counter()
        self._stack: list[Span] = []     # open wall-clock span() nesting

    def wall_now(self) -> float:
        """Seconds since this tracer's epoch (the wall timeline)."""
        return time.perf_counter() - self._epoch

    # ---------------------------------------------------------- record ----
    def add(self, name: str, t0: float, t1: float, *, clock: str = "sim",
            tid: str = "main", cat: str = "",
            args: Optional[dict] = None,
            parent: Optional[Span] = None) -> Span:
        """Record one completed span; returns it (for arg updates)."""
        s = Span(name, float(t0), float(t1), clock, tid, cat,
                 dict(args) if args else {})
        if parent is not None:
            parent.children.append(s)
        self.spans.append(s)
        return s

    def instant(self, name: str, t: float, *, clock: str = "sim",
                tid: str = "main", cat: str = "",
                args: Optional[dict] = None) -> Span:
        return self.add(name, t, t, clock=clock, tid=tid, cat=cat, args=args)

    def extend(self, spans) -> None:
        """Adopt already-built spans (e.g. a runtime result's tree)."""
        self.spans.extend(spans)

    @contextmanager
    def span(self, name: str, *, tid: str = "main", cat: str = "",
             args: Optional[dict] = None):
        """Wall-clock phase timer; nests (children attach to the
        innermost open span on the same tracer)."""
        parent = self._stack[-1] if self._stack else None
        s = self.add(name, self.wall_now(), 0.0, clock="wall", tid=tid,
                     cat=cat, args=args, parent=parent)
        self._stack.append(s)
        try:
            yield s
        finally:
            self._stack.pop()
            s.t1 = self.wall_now()

    # ---------------------------------------------------------- export ----
    def chrome_events(self, clock: str = "both") -> list:
        return chrome_events(self.spans, clock=clock)

    def to_chrome_trace(self, path: str, clock: str = "both",
                        metadata: Optional[dict] = None) -> str:
        return write_chrome_trace(self.spans, path, clock=clock,
                                  metadata=metadata)


def chrome_events(spans, clock: str = "both") -> list:
    """Flatten spans to Chrome trace events (``clock`` filters to one
    timeline; ``"both"`` keeps the two as separate pids)."""
    if clock not in CLOCKS + ("both",):
        raise ValueError(f"clock must be one of {CLOCKS + ('both',)}, "
                         f"got {clock!r}")
    keep = [s for s in spans if clock == "both" or s.clock == clock]
    # stable integer tids per (pid, track name), in first-seen order
    tids: dict = {}
    for s in keep:
        tids.setdefault((_PID[s.clock], s.tid), len(tids) + 1)
    events = []
    for (pid, name), tid in tids.items():
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": _PROCESS_NAME[
                           "sim" if pid == _PID["sim"] else "wall"]}})
        events.append({"name": "thread_name", "ph": "M", "pid": pid,
                       "tid": tid, "args": {"name": name}})
    # dedupe the repeated process_name rows
    seen, meta = set(), []
    for e in events:
        key = (e["name"], e["pid"], e["tid"])
        if key not in seen:
            seen.add(key)
            meta.append(e)
    events = meta
    for s in keep:
        pid, tid = _PID[s.clock], tids[(_PID[s.clock], s.tid)]
        ts = round(s.t0 * 1e6, 3)                 # Chrome wants microseconds
        e = {"name": s.name, "cat": s.cat or s.clock, "pid": pid,
             "tid": tid, "ts": ts}
        if s.t1 > s.t0:
            e["ph"] = "X"
            e["dur"] = round((s.t1 - s.t0) * 1e6, 3)
        else:
            e["ph"] = "i"
            e["s"] = "t"
        if s.args:
            e["args"] = s.args
        events.append(e)
    # deterministic ordering: metadata first, then by (pid, ts, tid, name)
    events.sort(key=lambda e: (e["ph"] != "M", e["pid"],
                               e.get("ts", -1.0), e["tid"], e["name"]))
    return events


def write_chrome_trace(spans, path: str, clock: str = "both",
                       metadata: Optional[dict] = None) -> str:
    """Write ``{"traceEvents": [...]}`` JSON; returns ``path``."""
    doc = {"traceEvents": chrome_events(spans, clock=clock),
           "displayTimeUnit": "ms"}
    if metadata:
        doc["metadata"] = metadata
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    return path
