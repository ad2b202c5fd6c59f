# Copied from src/repro/fleet/scenario.py.
"""Drift and fault injection for the adaptive control loop.

A :class:`RegimeChangeTrace` is a fleet workload whose statistics *move*:
phases of different arrival rates/patterns spliced into one
:class:`~repro_torch.fleet.traffic.Trace` (``Trace.concat`` / ``Trace.slice``
do the splicing with provenance preserved), plus scheduled faults —
link degradations (the channel a device class sits behind is replaced at
a simulated time, via ``netsim.channel.ChannelSchedule``) and replica
fail/recover events (the serving pool shrinks and grows).

The scenario is pure data: the adaptive controller
(``fleet.controller``) consumes it with either cluster engine, and
``schedule_faults`` wires the same events onto a live ``ClusterSim``'s
event queue for event-engine studies (``ClusterSim.set_replicas`` applies
replica events in place; link changes fire a callback).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

from repro_torch.fleet.traffic import DeviceClass, Trace, generate_trace
from repro_torch.netsim.channel import ChannelSchedule, degrade


@dataclass(frozen=True)
class Phase:
    """One stationary stretch of a regime-change workload."""
    duration_s: float
    rate_hz: float
    pattern: str = "poisson"
    kw: tuple = ()                   # pattern kwargs as sorted items

    def kwargs(self) -> dict:
        return dict(self.kw)


@dataclass(frozen=True)
class LinkDegradation:
    """At ``t_s`` the named device class's channel degrades (or is
    restored: factors of 1.0 / loss_add 0.0 with a later event).
    ``device=None`` applies to every class."""
    t_s: float
    capacity_factor: float = 1.0
    latency_factor: float = 1.0
    loss_add: float = 0.0
    device: Optional[str] = None


@dataclass(frozen=True)
class ReplicaEvent:
    """At ``t_s`` the serving pool gains (``delta > 0``, recovery) or
    loses (``delta < 0``, failure) replicas."""
    t_s: float
    delta: int


@dataclass(frozen=True)
class RegimeChangeTrace:
    """A spliced multi-phase trace plus its scheduled faults.

    ``boundaries`` holds each phase's start time (first is 0.0);
    ``replica_pool`` is the total replicas physically available before
    any failure (``None`` = unconstrained).
    """
    trace: Trace
    mix: tuple                       # DeviceClass population
    boundaries: tuple = (0.0,)
    link_events: tuple = ()          # LinkDegradation, sorted by t_s
    replica_events: tuple = ()       # ReplicaEvent, sorted by t_s
    replica_pool: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "link_events",
                           tuple(sorted(self.link_events,
                                        key=lambda e: e.t_s)))
        object.__setattr__(self, "replica_events",
                           tuple(sorted(self.replica_events,
                                        key=lambda e: e.t_s)))

    @property
    def horizon_s(self) -> float:
        return self.trace.horizon_s

    @classmethod
    def from_phases(cls, mix: Sequence[DeviceClass],
                    phases: Sequence[Phase], *, seed: int = 0,
                    link_events=(), replica_events=(),
                    replica_pool: Optional[int] = None
                    ) -> "RegimeChangeTrace":
        """Build the spliced trace: one ``generate_trace`` per phase
        (seeded ``seed + i`` so phases are independently reproducible),
        sliced to the phase duration and concatenated in order."""
        if not phases:
            raise ValueError("need at least one phase")
        parts, bounds, t = [], [], 0.0
        for i, ph in enumerate(phases):
            # overdraw ~25% so the generated horizon covers duration_s,
            # then cut exactly at the boundary
            n = max(1, int(ph.rate_hz * ph.duration_s * 1.25) + 8)
            part = generate_trace(mix, n, ph.rate_hz, pattern=ph.pattern,
                                  seed=seed + i, **ph.kwargs())
            parts.append(part.slice(0.0, ph.duration_s))
            bounds.append(t)
            t += ph.duration_s
        trace = parts[0]
        for p in parts[1:]:
            trace = trace.concat(p)
        return cls(trace, tuple(mix), tuple(bounds), tuple(link_events),
                   tuple(replica_events), replica_pool)

    # ----------------------------------------------------- link regimes ----
    def channel_schedule(self, device: DeviceClass) -> ChannelSchedule:
        """The device's channel as a time-indexed schedule: each
        matching :class:`LinkDegradation` replaces the channel with a
        degraded copy *of the base channel* (events are absolute
        regimes, so a later event with unit factors restores the
        link)."""
        events = []
        for ev in self.link_events:
            if ev.device is not None and ev.device != device.name:
                continue
            events.append((ev.t_s, degrade(
                device.channel, capacity_factor=ev.capacity_factor,
                latency_factor=ev.latency_factor, loss_add=ev.loss_add)))
        return ChannelSchedule(device.channel, tuple(events))

    def devices_at(self, t: float) -> tuple:
        """The device mix with each class behind its channel regime
        active at simulated time ``t``."""
        from dataclasses import replace as _replace
        out = []
        for d in self.mix:
            ch = self.channel_schedule(d).at(t)
            out.append(d if ch is d.channel else _replace(d, channel=ch))
        return tuple(out)

    def available_replicas(self, t: float,
                           initial: Optional[int] = None) -> Optional[int]:
        """Replicas physically available at ``t``: the pool plus every
        fail/recover delta so far (``None`` = unconstrained and no
        failure ever applies a cap)."""
        pool = self.replica_pool if initial is None else initial
        if pool is None:
            return None
        for ev in self.replica_events:
            if ev.t_s <= t:
                pool += ev.delta
        return max(1, pool)

    def events_between(self, t0: float, t1: float) -> list:
        """All fault events with ``t0 < t_s <= t1``, time-ordered — what
        the controller sees when it wakes at ``t1`` having last looked
        at ``t0``."""
        evs = [e for e in self.link_events if t0 < e.t_s <= t1]
        evs += [e for e in self.replica_events if t0 < e.t_s <= t1]
        return sorted(evs, key=lambda e: e.t_s)


def schedule_faults(scenario: RegimeChangeTrace, sim,
                    on_link_change=None) -> list:
    """Wire the scenario's faults onto a live ``ClusterSim``: replica
    events apply in place via ``sim.set_replicas`` as the queue reaches
    them, link changes invoke ``on_link_change(t, device_name, channel)``
    (the cluster itself never prices wires — the embedder re-prices its
    flows).  Returns the scheduled event handles."""
    handles = []
    for ev in scenario.replica_events:
        def _apply(delta=ev.delta):
            sim.set_replicas(max(1, sim.n_replicas + delta))
        handles.append(sim.q.schedule_named(ev.t_s, _apply,
                                            "replica-event"))
    if on_link_change is not None:
        for d in scenario.mix:
            sched = scenario.channel_schedule(d)
            handles += sched.schedule_on(
                sim.q, lambda t, ch, name=d.name: on_link_change(t, name, ch))
    return handles
