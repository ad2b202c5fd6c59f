# Copied from src/repro/fleet/traffic.py.
"""Fleet workload generation: who sends, and when.

The paper evaluates one sensing node on one link; a deployment serves a
*population* — heterogeneous device classes (``core.scenarios`` platform
profiles, each behind its own channel) firing requests under realistic
arrival processes.  Three processes cover the regimes that matter for
capacity planning:

* ``poisson`` — memoryless steady-state load (the M in M/D/c),
* ``bursty``  — a two-state Markov-modulated Poisson process (on/off
  bursts), same mean rate but heavy short-term contention,
* ``diurnal`` — sinusoidally modulated rate (day/night swing) realised by
  thinning a dominating Poisson process.

Everything is deterministic under a seed: the same ``(mix, pattern, rate,
n, seed)`` tuple always yields the identical trace.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.scenarios import PlatformProfile, edge_platform
from repro_torch.netsim.channel import Channel

ARRIVAL_PATTERNS = ("poisson", "bursty", "diurnal")


@dataclass(frozen=True)
class DeviceClass:
    """One slice of the fleet: a platform profile behind a channel."""
    name: str
    platform: PlatformProfile
    channel: Channel
    protocols: tuple = ("tcp", "udp")   # transports this class supports
    weight: float = 1.0                 # share of the request population

    @classmethod
    def make(cls, platform_name: str, channel: Channel, *,
             name: Optional[str] = None, protocols: tuple = ("tcp", "udp"),
             weight: float = 1.0) -> "DeviceClass":
        return cls(name or platform_name, edge_platform(platform_name),
                   channel, protocols, weight)


@dataclass(frozen=True)
class FleetRequest:
    rid: int
    t_arrival: float                    # seconds since trace start
    device: str                         # DeviceClass.name


@dataclass(frozen=True)
class Trace:
    requests: tuple                     # FleetRequest, sorted by t_arrival
    horizon_s: float
    pattern: str
    seed: Optional[int] = None          # provenance: the generating seed

    def __len__(self):
        return len(self.requests)

    def for_device(self, name: str) -> "Trace":
        sub = tuple(r for r in self.requests if r.device == name)
        return Trace(sub, self.horizon_s, self.pattern, self.seed)

    def mean_rate_hz(self) -> float:
        return len(self.requests) / self.horizon_s if self.horizon_s else 0.0

    def arrival_times(self) -> np.ndarray:
        """All arrival times as one float array (request order) — the
        form the vectorized cluster engine consumes."""
        return np.fromiter((r.t_arrival for r in self.requests), float,
                           len(self.requests))

    def slice(self, t0: float, t1: float) -> "Trace":
        """The sub-trace of arrivals in ``[t0, t1)``, re-based to start
        at 0 (horizon ``t1 - t0``).  Request ids and the generating seed
        are preserved — a slice is provenance-traceable back to the
        trace it was cut from.  The controller's observation windows and
        scenario splicing both live on this."""
        if t1 < t0:
            raise ValueError(f"empty slice window [{t0}, {t1})")
        sub = tuple(replace(r, t_arrival=r.t_arrival - t0)
                    for r in self.requests if t0 <= r.t_arrival < t1)
        return Trace(sub, t1 - t0, self.pattern, self.seed)

    def concat(self, other: "Trace") -> "Trace":
        """This trace followed by ``other`` time-shifted to start at
        this trace's horizon.  Request ids are renumbered sequentially
        (downstream consumers key on unique rids); the seed survives
        only when both parts carry the same one — a splice of two
        different generations has no single generating seed, and
        pretending otherwise would poison downstream provenance."""
        shift, n0 = self.horizon_s, len(self.requests)
        reqs = tuple(replace(r, rid=i) for i, r in enumerate(self.requests))
        reqs += tuple(replace(r, rid=n0 + i, t_arrival=r.t_arrival + shift)
                      for i, r in enumerate(other.requests))
        pattern = (self.pattern if self.pattern == other.pattern
                   else f"{self.pattern}+{other.pattern}")
        seed = self.seed if self.seed == other.seed else None
        return Trace(reqs, shift + other.horizon_s, pattern, seed)


# ------------------------------------------------------ arrival processes ----
def poisson_arrivals(rate_hz: float, n: int, rng: np.random.Generator) -> np.ndarray:
    """n exponential inter-arrival gaps at ``rate_hz``."""
    assert rate_hz > 0 and n > 0
    return np.cumsum(rng.exponential(1.0 / rate_hz, n))


def bursty_arrivals(rate_hz: float, n: int, rng: np.random.Generator, *,
                    burst_factor: float = 8.0, p_on: float = 0.2,
                    mean_run: int = 20) -> np.ndarray:
    """Two-state MMPP: bursts run ``burst_factor`` hotter than the quiet
    state; burst runs last ~``mean_run`` arrivals and hold ``p_on`` of all
    arrivals (exit/entry flip probabilities are balanced for that
    stationary split), so the long-run mean rate stays ``rate_hz``:
    E[gap] = p_on/r_on + (1-p_on)/r_off = 1/rate.
    """
    assert rate_hz > 0 and n > 0 and 0.0 < p_on < 1.0
    r_off = rate_hz * (p_on / burst_factor + (1.0 - p_on))
    r_on = burst_factor * r_off
    f_exit = 1.0 / mean_run                      # leave a burst
    f_enter = f_exit * p_on / (1.0 - p_on)       # enter a burst
    on = bool(rng.random() < p_on)
    # vectorized: the per-arrival state chain decomposes into alternating
    # runs with geometric lengths (flip checked after each arrival), so
    # draw run lengths in bulk, expand to a per-arrival state array, and
    # scale one block of unit exponentials — megafleet traces (10^6+)
    # generate in milliseconds instead of minutes
    lens, states, covered = [], [], 0
    while covered < n:
        m = int(np.ceil((n - covered) / (1.0 / f_exit + 1.0 / f_enter))) + 16
        pair_len = np.empty(2 * m, np.int64)
        pair_on = np.empty(2 * m, bool)
        first, second = (f_exit, f_enter) if on else (f_enter, f_exit)
        pair_len[0::2] = rng.geometric(first, m)
        pair_len[1::2] = rng.geometric(second, m)
        pair_on[0::2], pair_on[1::2] = on, not on
        lens.append(pair_len)
        states.append(pair_on)
        covered += int(pair_len.sum())
    on_arr = np.repeat(np.concatenate(states), np.concatenate(lens))[:n]
    gaps = rng.exponential(1.0, n) / np.where(on_arr, r_on, r_off)
    return np.cumsum(gaps)


def diurnal_arrivals(rate_hz: float, n: int, rng: np.random.Generator, *,
                     period_s: float = 60.0, depth: float = 0.8) -> np.ndarray:
    """Sinusoidal rate ``rate*(1 + depth*sin)`` via thinning: draw from the
    dominating Poisson process at the peak rate and keep each arrival with
    probability rate(t)/peak.
    """
    assert rate_hz > 0 and n > 0 and 0.0 <= depth < 1.0
    peak = rate_hz * (1.0 + depth)
    # vectorized thinning: draw the dominating process and the accept
    # coins in chunks (mean accept ratio 1/(1+depth), so overdraw by
    # that factor plus slack), keep going until n survive
    out = np.empty(n)
    t0, k = 0.0, 0
    while k < n:
        m = int((n - k) * (1.0 + depth) * 1.2) + 64
        t = t0 + np.cumsum(rng.exponential(1.0 / peak, m))
        r_t = rate_hz * (1.0 + depth * np.sin(2.0 * np.pi * t / period_s))
        acc = t[rng.random(m) * peak < r_t]
        take = min(n - k, len(acc))
        out[k:k + take] = acc[:take]
        k += take
        t0 = float(t[-1])
    return out


_PROCESSES = {"poisson": poisson_arrivals, "bursty": bursty_arrivals,
              "diurnal": diurnal_arrivals}


def generate_trace(mix: Sequence[DeviceClass], n_requests: int,
                   rate_hz: float, *, pattern: str = "poisson",
                   seed: int = 0, **pattern_kw) -> Trace:
    """A deterministic fleet trace: arrival times from the chosen process,
    device classes drawn independently with probability ∝ weight.  The
    seed is recorded on the returned :class:`Trace` so downstream
    artifacts (exported telemetry, CI trace diffs) carry their own
    provenance."""
    if pattern not in _PROCESSES:
        raise ValueError(f"unknown pattern {pattern!r}; "
                         f"choose from {ARRIVAL_PATTERNS}")
    if not mix:
        raise ValueError("device mix is empty")
    rng = np.random.default_rng(seed)
    times = _PROCESSES[pattern](rate_hz, n_requests, rng, **pattern_kw)
    w = np.array([d.weight for d in mix], float)
    assert (w > 0).all(), "device weights must be positive"
    picks = rng.choice(len(mix), size=n_requests, p=w / w.sum())
    reqs = tuple(FleetRequest(i, float(times[i]), mix[picks[i]].name)
                 for i in range(n_requests))
    return Trace(reqs, float(times[-1]), pattern, seed)
