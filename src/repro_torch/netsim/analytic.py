# Copied from src/repro/netsim/analytic.py (the whole file).
"""Vectorized closed-form makespan engine (the planner fast path).

The tier planner's search space — cut list x stage->tier assignment
(x protocol x batch in the fleet planner) — grows combinatorially, and
pricing every combination with one discrete-event simulation each
(``simulate_pipeline`` schedules n_micro transfers per hop, each a
per-packet event run) caps how much of the space can be explored.  This
module prices the *whole* candidate set as array operations instead:

* :func:`transfer_duration_s` — closed forms of the zero-loss transport
  models in ``netsim.protocols``.  UDP is ``n_pkts * ser + lat``.  TCP's
  windowed send obeys ``f[j] = max(f[j-1], f[j-W] + 2*lat) + ser`` (a
  packet goes out when the link frees *and* the window opens); solving
  the recurrence gives ``f[n-1] = (r+1)*ser + q*max(W*ser, 2*lat+ser)``
  with ``q, r = divmod(n-1, W)`` — the two maximum terms are the
  link-bound and ack-bound steady states.
* :func:`pipeline_makespan_s` — the GPipe fill/drain + bottleneck form
  of the microbatched schedule.  With per-microbatch hop durations
  constant (the zero-loss case), the event engine is a deterministic
  flow shop — tiers and links are serial FIFO resources, propagation is
  a pure delay — whose makespan is exactly
  ``sum(per-microbatch stage and hop times) + (n_micro-1) * bottleneck``
  where the bottleneck is the slowest serial resource (stage time / n or
  sender-busy hop time).  Per-hop packetisation overhead is kept (each
  microbatch pays ``ceil``-rounded packets), so the planner's
  unchopped-fallback decision (``sequential < pipelined``) is identical
  to the event engine's.

**Contract**: the event engine in ``netsim.events``/``netsim.protocols``
stays the single semantic authority.  On loss-free paths
(:attr:`PathParams.exact`) the closed form must agree with
``simulate_pipeline`` to 1e-9 relative — enforced by the
``check_closed_form`` hook the planner's refinement stage runs — and on
lossy paths it is a *screen* only (loss-free optimistic bound for TCP,
upper bound for UDP): survivors must be re-priced by the event engine.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from repro_torch.netsim.protocols import TCP_WINDOW


@dataclass(frozen=True)
class PathParams:
    """Per-hop channel/protocol constants of a ``NetworkPath``, as arrays
    ready for broadcasting against ``(n_combos, n_hops)`` payload
    tensors."""
    ser_s: np.ndarray           # one-MTU serialization time per hop
    latency_s: np.ndarray       # propagation delay per hop
    mtu: np.ndarray             # packet size per hop (bytes)
    is_tcp: np.ndarray          # bool per hop
    window: np.ndarray          # TCP send window per hop
    loss_rate: np.ndarray       # saboteur loss per hop

    @property
    def n_hops(self) -> int:
        return len(self.ser_s)

    @property
    def exact(self) -> bool:
        """True when the closed form equals the event engine (no loss:
        transfer durations are deterministic and microbatch-independent)."""
        return bool((self.loss_rate == 0.0).all())


def path_params(path) -> PathParams:
    """Extract :class:`PathParams` from a ``NetworkPath`` (or anything
    ``netsim.simulator.as_path`` accepts)."""
    from repro_torch.netsim.simulator import as_path
    path = as_path(path)
    for h in path:
        if h.protocol not in ("tcp", "udp"):
            raise ValueError(f"unknown protocol {h.protocol!r}")
    return PathParams(
        ser_s=np.array([h.channel.serialization_s(h.mtu) for h in path]),
        latency_s=np.array([h.channel.latency_s for h in path]),
        mtu=np.array([float(h.mtu) for h in path]),
        is_tcp=np.array([h.protocol == "tcp" for h in path]),
        window=np.array([float(TCP_WINDOW) for _ in path.hops]),
        loss_rate=np.array([h.channel.loss_rate for h in path]),
    )


def transfer_duration_s(n_bytes, pp: PathParams) -> np.ndarray:
    """Zero-loss transfer durations, vectorized.

    ``n_bytes``: array whose last axis runs over the path's hops
    (``(..., n_hops)``); returns the same shape.  Matches
    ``protocols.simulate_tcp`` / ``simulate_udp`` exactly at
    ``loss_rate == 0`` (both charge a full-MTU serialization per packet,
    and a zero-byte payload still costs one packet).
    """
    n_bytes = np.asarray(n_bytes, dtype=float)
    n_pkts = np.maximum(1.0, np.ceil(n_bytes / pp.mtu))
    ser, lat = pp.ser_s, pp.latency_s
    # TCP: q full window cycles at the steady-state rate (link-bound
    # W*ser vs ack-bound 2*lat+ser), then r+1 back-to-back packets
    q, r = np.divmod(n_pkts - 1.0, pp.window)
    cycle = np.maximum(pp.window * ser, 2.0 * lat + ser)
    tcp = (r + 1.0) * ser + q * cycle + lat
    udp = n_pkts * ser + lat
    return np.where(pp.is_tcp, tcp, udp)


def pipeline_makespan_s(stage_s, hop_bytes, pp: PathParams,
                        n_micro: int = 4, hop_mask=None) -> tuple:
    """Closed-form ``(pipelined, sequential)`` makespans, vectorized.

    ``stage_s``: ``(..., n_tiers)`` per-stage compute times (zero entries
    model pass-through tiers); ``hop_bytes``: ``(..., n_hops)`` payloads;
    ``hop_mask``: optional bool ``(..., n_hops)`` marking which physical
    links a combo actually crosses (a plan ending early uses a prefix of
    the chain) — unused hops contribute nothing.

    The pipelined form is the deterministic-flow-shop makespan: the first
    microbatch's end-to-end path time plus ``n_micro - 1`` periods of the
    bottleneck serial resource, where a link holds a microbatch for its
    sender-clocked time (duration minus one propagation delay, the same
    convention ``simulate_pipeline`` frees links under).
    """
    if n_micro < 1:
        raise ValueError(f"n_micro must be >= 1, got {n_micro}")
    stage_s = np.asarray(stage_s, dtype=float)
    hop_bytes = np.asarray(hop_bytes, dtype=float)
    if hop_mask is None:
        hop_mask = np.ones(hop_bytes.shape, dtype=bool)
    full = np.where(hop_mask, transfer_duration_s(hop_bytes, pp), 0.0)
    seq = stage_s.sum(-1) + full.sum(-1)

    mb_bytes = np.maximum(1.0, np.ceil(hop_bytes / n_micro))
    mb = np.where(hop_mask, transfer_duration_s(mb_bytes, pp), 0.0)
    busy = np.where(hop_mask, np.maximum(mb - pp.latency_s, 0.0), 0.0)
    stage_mb = stage_s / n_micro
    bottleneck = np.maximum(stage_mb.max(-1, initial=0.0),
                            busy.max(-1, initial=0.0))
    pipe = stage_mb.sum(-1) + mb.sum(-1) + (n_micro - 1) * bottleneck
    return pipe, seq


def closed_form_pipeline(stage_s, hop_bytes, path, *,
                         n_micro: int = 4) -> tuple:
    """Scalar convenience: ``(pipelined_s, sequential_s)`` of one combo —
    same validation as ``simulate_pipeline``."""
    pp = path_params(path)
    if len(stage_s) != pp.n_hops + 1 or len(hop_bytes) != pp.n_hops:
        raise ValueError(
            f"{pp.n_hops}-hop path needs {pp.n_hops + 1} stage times and "
            f"{pp.n_hops} payloads, got {len(stage_s)}/{len(hop_bytes)}")
    pipe, seq = pipeline_makespan_s(
        np.asarray(stage_s, dtype=float)[None, :],
        np.asarray(hop_bytes, dtype=float)[None, :], pp, n_micro)
    return float(pipe[0]), float(seq[0])


def assert_event_match(name: str, closed: float, event: float,
                       rel: float = 1e-9) -> None:
    """The screen-analytically / refine-exactly contract: on exact paths
    the closed form must reproduce the event engine."""
    if not math.isclose(closed, event, rel_tol=rel, abs_tol=1e-15):
        raise AssertionError(
            f"closed-form {name} diverged from the event engine: "
            f"{closed!r} vs {event!r} (rel tol {rel}) — the event engine "
            f"is the semantic authority; fix netsim.analytic")
