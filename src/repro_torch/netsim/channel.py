# Copied from src/repro/netsim/channel.py.
"""Channel model (the *netsim* layer): propagation delay, capacity,
interface speed, and the loss *saboteur* (paper §IV's five parameters).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Channel:
    latency_s: float            # propagation delay per packet
    capacity_bps: float         # link available bandwidth
    interface_bps: float        # physical interface speed (NIC)
    loss_rate: float = 0.0      # saboteur: per-packet loss probability
    seed: int = 0

    @property
    def effective_bps(self) -> float:
        return min(self.capacity_bps, self.interface_bps)

    def serialization_s(self, n_bytes: int) -> float:
        return n_bytes * 8.0 / self.effective_bps

    def loss_mask(self, n: int, stream: int = 0) -> np.ndarray:
        """Deterministic per-packet loss draws (True = lost)."""
        rng = np.random.default_rng((self.seed, stream))
        return rng.random(n) < self.loss_rate


def degrade(channel: Channel, *, capacity_factor: float = 1.0,
            latency_factor: float = 1.0, loss_add: float = 0.0) -> Channel:
    """A degraded copy of ``channel``: capacity scaled down, propagation
    delay scaled up, extra loss compounded on top of the existing rate.
    The interface speed is physical and does not degrade."""
    if not (0.0 < capacity_factor <= 1.0):
        raise ValueError(f"capacity_factor must be in (0, 1], "
                         f"got {capacity_factor}")
    if latency_factor < 1.0:
        raise ValueError(f"latency_factor must be >= 1, got {latency_factor}")
    loss = 1.0 - (1.0 - channel.loss_rate) * (1.0 - loss_add)
    return Channel(channel.latency_s * latency_factor,
                   channel.capacity_bps * capacity_factor,
                   channel.interface_bps, loss_rate=loss, seed=channel.seed)


@dataclass(frozen=True)
class ChannelSchedule:
    """A channel whose parameters change at scheduled simulated times.

    ``events`` is a sorted tuple of ``(t_s, Channel)``: from ``t_s``
    onward the link *is* that channel (absolute replacement, not a
    delta — compose with :func:`degrade` to derive one).  :meth:`at`
    answers "which channel carries a transfer starting at ``t``", which
    is how the adaptive controller prices per-arrival wire legs;
    :meth:`schedule_on` arms one named event per change on an
    ``EventQueue`` (the same loop ``ClusterSim`` runs on), so an
    embedding simulation observes link changes as they happen rather
    than by polling.
    """
    base: Channel
    events: tuple = ()               # ((t_s, Channel), ...) sorted by t_s

    def __post_init__(self):
        ev = tuple(sorted(self.events, key=lambda e: e[0]))
        object.__setattr__(self, "events", ev)

    def at(self, t: float) -> Channel:
        ch = self.base
        for t_ev, c in self.events:
            if t_ev <= t:
                ch = c
            else:
                break
        return ch

    def epoch(self, t: float) -> int:
        """Index of the link regime active at ``t`` (0 = base) — a
        cache key for anything priced per link state."""
        k = 0
        for t_ev, _ in self.events:
            if t_ev <= t:
                k += 1
            else:
                break
        return k

    def schedule_on(self, queue, on_change) -> list:
        """Schedule ``on_change(t_s, channel)`` for every future event
        on ``queue`` (a ``netsim.events.EventQueue``); returns the event
        handles so an embedder can cancel them."""
        return [queue.schedule_named(
                    t_ev, lambda t=t_ev, c=ch: on_change(t, c),
                    "link-change")
                for t_ev, ch in self.events if t_ev >= queue.now]


def compose_channels(channels) -> Channel:
    """The effective single channel of a multi-link store-and-forward
    segment: latencies add, bandwidth is the bottleneck link, loss
    compounds (``1 - prod(1 - p)``).  Used when a logical wire hop of a
    tier plan traverses several physical links (a skipped tier forwards
    without computing) but the consumer prices one transfer per hop.
    """
    channels = list(channels)
    if not channels:
        raise ValueError("compose_channels needs at least one channel")
    if len(channels) == 1:
        return channels[0]
    loss = 1.0
    for ch in channels:
        loss *= 1.0 - ch.loss_rate
    return Channel(sum(ch.latency_s for ch in channels),
                   min(ch.capacity_bps for ch in channels),
                   min(ch.interface_bps for ch in channels),
                   loss_rate=1.0 - loss, seed=channels[0].seed)


# Interface presets from the paper (§IV): Gigabit, Fast-Ethernet, Wi-Fi.
INTERFACES = {
    "gigabit": 1000e6,
    "fast-ethernet": 100e6,
    "wifi": 160e6,
    "10gbe": 10e9,
    # TPU fabric profiles of the reference's multi-pod adaptation
    "tpu-ici-link": 50e9 * 8,          # 50 GB/s per ICI link
    "tpu-dcn": 25e9,
}
