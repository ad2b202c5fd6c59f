# Copied from src/repro/runtime/faults.py.
"""Deterministic fault injection + recovery policy for the live runtime.

Split-Et-Impera's premise is that the cut crosses a real, unreliable
network (paper §IV: the saboteur, the TCP/UDP loss study) — yet a live
:class:`~repro_torch.runtime.engine.SplitRuntime` with no fault model silently
assumes every transfer arrives intact and the tail server never dies.
This module is the runtime's half of the sim-vs-reality loop for
*failure*:

* :class:`FaultPlan` — a seeded, fully deterministic fault schedule
  (transfer loss spikes, frame corruption, tail-server blackouts and
  stragglers, stage exceptions).  Every decision is a pure function of
  ``(seed, request, hop/stage, attempt)`` — never of wall-clock time or
  execution order — so the same plan replays the identical fault
  sequence across runs, across ``fused=True/False``, and across hosts.
* :class:`RecoveryPolicy` — what the runtime *does* about it: per-hop
  timeouts derived from the netsim channel RTO (the same constant
  ``netsim.protocols.simulate_tcp`` arms its retransmission timers
  with), capped exponential backoff with deterministic jitter, a
  per-request deadline budget, and the two graceful-degradation rungs
  (codec downgrade, full local fallback).

Both objects are inert data: the recovery machinery itself lives in
``runtime.engine`` (``SplitRuntime(faults=..., recovery=...)``) and is
only entered when a plan is present — the zero-fault fast path is never
touched.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

# netsim's transport constants: the recovery timeout is derived from the
# same RTO formula the simulated TCP arms its retransmission timers with
from repro_torch.netsim.protocols import MTU_BYTES

#: fault kinds a transfer attempt can draw (order fixes the rate bands)
TRANSFER_FAULTS = ("drop", "corrupt", "straggle")


class FaultError(RuntimeError):
    """An injected stage exception (the ``stage_fault_rate`` fault kind).

    Raised *inside* the stage execution wrapper so the recovery loop
    exercises real exception machinery, and typed so nothing but the
    fault layer is ever caught.
    """


class RecoveryExhausted(RuntimeError):
    """Recovery ran out of options: the hop exhausted its attempt budget
    (or the request its deadline) and the policy forbids local fallback."""


def _draw(seed: int, rid: int, idx: int, attempt: int, salt: int) -> float:
    """One uniform [0, 1) draw keyed purely on identity, never on order."""
    return float(np.random.default_rng(
        (seed, rid, idx, attempt, salt)).random())


@dataclass(frozen=True)
class FaultPlan:
    """A deterministic, seeded fault schedule for one runtime.

    Rates are per *attempt*: each (request ``rid``, hop ``k``, attempt
    ``a``) transfer attempt draws one uniform number from
    ``rng((seed, rid, k, a))`` and maps it onto the ``drop`` /
    ``corrupt`` / ``straggle`` bands; stage executions draw the same way
    per (rid, stage, attempt).  ``blackouts`` are windows on the
    request's *virtual clock* (seconds since the request started —
    compute + wire + waits) during which the tail-server hop is down
    regardless of the rates.

    ``max_consecutive`` caps how many consecutive faulted attempts one
    (rid, hop/stage) may draw: past it the schedule stops injecting, so
    every fault burst is finite and a retrying runtime always terminates
    (blackout windows are finite by construction).  Set it high to force
    the degradation rungs instead.
    """
    seed: int = 0
    drop_rate: float = 0.0           # transfer attempt lost (timeout fires)
    corrupt_rate: float = 0.0        # frame delivered but corrupted (CRC)
    straggle_rate: float = 0.0       # tail-server straggler: late delivery
    straggle_s: float = 0.05         # extra seconds a straggler costs
    stage_fault_rate: float = 0.0    # stage raises FaultError
    blackouts: tuple = ()            # ((t0_s, t1_s), ...) virtual clock
    max_consecutive: int = 6

    def __post_init__(self):
        object.__setattr__(self, "blackouts",
                           tuple((float(a), float(b))
                                 for a, b in self.blackouts))
        for a, b in self.blackouts:
            if b <= a:
                raise ValueError(f"blackout window ({a}, {b}) is empty")

    @property
    def any_faults(self) -> bool:
        return bool(self.drop_rate or self.corrupt_rate
                    or self.straggle_rate or self.stage_fault_rate
                    or self.blackouts)

    # ------------------------------------------------------- decisions ----
    def transfer_fault(self, rid: int, hop: int,
                       attempt: int) -> Optional[str]:
        """Fate of transfer attempt ``attempt`` of hop ``hop``:
        ``'drop' | 'corrupt' | 'straggle' | None`` — deterministic."""
        if attempt >= self.max_consecutive:
            return None
        r = _draw(self.seed, rid, hop, attempt, salt=1)
        edge = 0.0
        for kind, rate in zip(TRANSFER_FAULTS, (self.drop_rate,
                                                self.corrupt_rate,
                                                self.straggle_rate)):
            edge += rate
            if r < edge:
                return kind
        return None

    def stage_fault(self, rid: int, stage: int, attempt: int) -> bool:
        """Does stage ``stage`` raise on execution attempt ``attempt``?"""
        if attempt >= self.max_consecutive:
            return False
        return _draw(self.seed, rid, stage, attempt,
                     salt=2) < self.stage_fault_rate

    def blackout_at(self, t: float) -> bool:
        """Is the tail server dark at virtual time ``t``?"""
        return any(a <= t < b for a, b in self.blackouts)

    def blackout_end(self, t: float) -> float:
        """End of the blackout window covering ``t`` (``t`` if none)."""
        for a, b in self.blackouts:
            if a <= t < b:
                return b
        return t

    # ------------------------------------------------------- corruption ----
    def corrupt_bytes(self, buf: bytes, rid: int, hop: int, attempt: int,
                      lo: int = 0) -> bytes:
        """A deterministically corrupted copy of ``buf``: 1-4 bytes in
        ``[lo, len)`` XOR-flipped (``lo`` lets the caller spare the
        header so the detection burden falls on the CRC, not the
        magic)."""
        if not buf:
            return buf
        lo = min(lo, len(buf) - 1)
        rng = np.random.default_rng((self.seed, rid, hop, attempt, 3))
        n = int(rng.integers(1, 5))
        offs = lo + rng.integers(0, len(buf) - lo, size=n)
        out = bytearray(buf)
        for o in offs:
            out[int(o)] ^= 0xFF
        return bytes(out)

    # ------------------------------------------------------- schedules ----
    def transfer_schedule(self, rid: int, hop: int, n: int) -> tuple:
        """The first ``n`` attempt fates of one hop — the determinism
        witness property tests compare across runs."""
        return tuple(self.transfer_fault(rid, hop, a) for a in range(n))


@dataclass(frozen=True)
class RecoveryPolicy:
    """What the runtime does when the wire (or a stage) misbehaves.

    * **Timeout** — a transfer attempt that never delivers is detected
      after :meth:`timeout_s`: the netsim channel's RTO (``2*RTT +
      serialization(MTU)``, exactly the constant
      ``netsim.protocols.simulate_tcp`` arms) plus the frame's own
      serialization time.  Unpriced hops (no channel) use
      ``default_timeout_s``.
    * **Backoff** — retries wait ``min(base * mult^attempt, cap)`` plus
      a *deterministic* jitter fraction drawn from ``(seed, rid, hop,
      attempt)`` — reproducible, but uncorrelated across requests so
      synchronized retry storms still decorrelate.  ``base_backoff_s``
      of ``None`` uses one hop RTO.
    * **Deadline** — the per-request budget on the virtual clock
      (compute + wire + waits).  When the next attempt could no longer
      fit, the request escalates to the degradation rungs instead of
      retrying forever.
    * **Degradation rungs** — (1) after ``downgrade_after`` corrupted
      frames on one hop the codec downgrades one rung
      (``ae8 -> int8 -> f32``, re-encoded locally from the original
      boundary activation); (2) when the server leg exhausts its attempt
      or deadline budget and ``local_fallback`` is set, the edge runs
      every remaining stage itself.  Both are explicitly flagged in
      ``RuntimeResult.meta`` and priced in the per-stage accounting.
    """
    max_attempts: int = 8            # per hop (timeouts + corruptions)
    base_backoff_s: Optional[float] = None   # None: one hop RTO
    backoff_mult: float = 2.0
    backoff_cap_s: float = 0.5
    jitter: float = 0.1              # fraction of the backoff, deterministic
    deadline_s: Optional[float] = None       # per-request virtual budget
    downgrade_after: int = 2         # corrupted frames before codec downgrade
    local_fallback: bool = True
    default_timeout_s: float = 0.05  # unpriced hops have no RTO to derive

    def rto_s(self, channel) -> float:
        """The netsim RTO of ``channel`` (``simulate_tcp``'s timer)."""
        if channel is None:
            return self.default_timeout_s
        return (2 * (2 * channel.latency_s)
                + channel.serialization_s(MTU_BYTES) + 1e-6)

    def timeout_s(self, channel, nbytes: int) -> float:
        """Loss-detection time of one ``nbytes`` transfer attempt."""
        if channel is None:
            return self.default_timeout_s
        return self.rto_s(channel) + channel.serialization_s(nbytes)

    def backoff_s(self, attempt: int, *, seed: int, rid: int,
                  hop: int, channel=None) -> float:
        """Capped exponential backoff with deterministic jitter."""
        base = (self.base_backoff_s if self.base_backoff_s is not None
                else self.rto_s(channel))
        raw = min(base * self.backoff_mult ** attempt, self.backoff_cap_s)
        return raw * (1.0 + self.jitter * _draw(seed, rid, hop, attempt,
                                                salt=4))


#: codec degradation ladders, strongest first.  Corruption on an 'ae8'
#: hop smears whole rows through the AE-decoder matmul; 'int8' localises
#: the damage to the flipped codes; 'f32' needs no scales at all and is
#: the last rung before local fallback.
DOWNGRADE_LADDER = {
    "ae8": ("ae8", "int8", "f32"),
    "int8": ("int8", "f32"),
    "f32": ("f32",),
}


def downgrade_ladder(kind: str) -> tuple:
    """The rung sequence for a hop whose nominal wire kind is ``kind``."""
    return DOWNGRADE_LADDER[kind]
