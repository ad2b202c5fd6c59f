# Copied from src/repro/fleet/controller.py.
"""Online adaptive replanning: a drift-aware control loop over the fleet.

The planner (``fleet.planner``) answers "which deployment for *this*
workload" once, offline.  Real workloads move: arrival rates swing,
links degrade, replicas fail.  :class:`AdaptiveController` closes the
loop — it watches a running cluster's windowed decision signals, detects
regime changes, re-screens the candidate space, and switches plans live
through an explicit migration model.

The control loop, end to end::

      telemetry window        drift detection           re-screen
    ┌──────────────────┐   ┌──────────────────┐   ┌────────────────────┐
    │ rate, drops,     │──▶│ rate-drift / drop │──▶│ closed-form screen │
    │ queue depth, p99 │   │ / queue / fault   │   │ + vectorized price │
    └──────────────────┘   └──────────────────┘   └─────────┬──────────┘
              ▲                                             │ hysteresis
              │            ┌──────────────────┐             ▼
              └────────────│ era simulation   │◀── switch: drain old,
                           │ (either engine)  │     warm up new
                           └──────────────────┘

Design invariants:

* **Engine-matched decisions.**  Drift detection keys only on signals
  that are *exactly* identical across the event and vectorized cluster
  engines (arrival counts, drop counts, queue depth — integers the two
  engines agree on by construction), and every candidate is priced with
  the vectorized engine regardless of which engine runs the simulation.
  ``run(scenario, engine="event")`` and ``engine="vectorized"``
  therefore make *identical switch decisions*; only float-accumulation
  noise in reported percentiles differs (the standing ``PCTL_RTOL``
  contract of ``fleet.vectorized``).

* **Eras.**  A run is a sequence of plan eras.  Each era is a fresh
  cluster (on either engine); at a switch the old era *drains* — every
  request that arrived before the switch finishes (or drops) on the old
  plan — while the new era's early arrivals pay an explicit warm-up:
  their cluster offer time is clamped to ``t_switch + warmup_s``.  The
  number of requests delayed and the total added delay are the
  *migration disruption*, reported per switch and in aggregate.

* **Bounded flapping.**  A voluntary switch requires an improvement
  margin (``min_improvement``), respects a cooldown, and is refused
  outright once ``max_switches`` voluntary switches have happened — the
  bound is a hard guard on the switch path, so ``n_switches <=
  max_switches`` holds for every scenario by construction.  Forced
  reconfigurations (replica fail/recover capping the live pool) do not
  count against the bound: they are physics, not policy.

* **Static is the same machinery.**  :meth:`run_static` runs the
  identical era pipeline with replanning disabled, so "adaptive with no
  triggers" and "static" produce bit-identical latencies — the no-op
  property tests assert exact array equality, not approximate closeness.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Callable, Optional, Sequence

import numpy as np

from repro_torch.core.qos import QoSRequirements
from repro_torch.fleet.cluster import ClusterConfig, ClusterSim
from repro_torch.fleet.scenario import RegimeChangeTrace
from repro_torch.fleet.traffic import Trace
from repro_torch.fleet.vectorized import signals_at, simulate_cluster_vectorized
from repro_torch.netsim import analytic
from repro_torch.netsim.simulator import NetworkConfig, NetworkPath
from repro_torch.obs import NULL
from repro_torch.serving.engine import BatchCostModel


# ----------------------------------------------------------- candidates ----
@dataclass(frozen=True)
class CandidatePlan:
    """One switchable deployment: a split candidate fully configured.

    The controller's decision space is a *fixed grid* of these — built
    from a :class:`~repro_torch.fleet.planner.DeploymentPlanner` search space
    via :meth:`AdaptiveController.from_planner`, or handed in directly
    (planner-free mode: property tests and benchmarks price candidates
    without a model in sight)."""
    key: str                         # unique id, e.g. "SC@3:tcp:b8:r2"
    label: str                       # 'SC@k' | 'RC'
    split: Optional[int]
    protocol: str
    max_batch: int
    n_replicas: int
    batch_window_s: float
    cost: BatchCostModel             # server-side batched service model
    queue_limit: int = 4096

    def cluster_cfg(self, k_eff: int) -> ClusterConfig:
        return ClusterConfig(k_eff, self.max_batch, self.batch_window_s,
                             self.queue_limit)

    def capacity_hz(self, avail: Optional[int] = None) -> float:
        """Closed-form saturation throughput: ``k * B / svc(B)``."""
        k = self.n_replicas if avail is None else min(self.n_replicas, avail)
        return k * self.max_batch / self.cost.service_time(self.max_batch)


@dataclass(frozen=True)
class ControllerConfig:
    """Control-loop tuning.  ``None`` disables the matching trigger;
    with every trigger disabled and a fault-free scenario the adaptive
    run is provably a no-op (exactly equal to the static run)."""
    control_period_s: float = 1.0    # decision (and signal-window) cadence
    drift_threshold: Optional[float] = 0.35   # |rate-ref|/ref to trigger
    drop_trigger: Optional[float] = 0.0       # window drop fraction >
    queue_trigger: Optional[int] = None       # queue depth >
    min_improvement: float = 0.10    # new p99 < (1-m) * incumbent p99
    cooldown_s: float = 0.0          # min spacing between switches
    warmup_s: float = 0.0            # new-plan offers clamped to t+warmup
    max_switches: int = 4            # hard cap on voluntary switches
    max_priced: int = 8              # shortlist size priced per replan
    fault_trigger: Optional[int] = None   # runtime fault reports/window >=


@dataclass
class SwitchRecord:
    """One plan transition (voluntary or forced), with its migration
    disruption filled in as the new era accumulates arrivals."""
    t_s: float
    from_key: str
    to_key: str
    reason: str     # rate-drift|drops|queue|fault|runtime-fault|replica-cap
    forced: bool = False
    predicted_p99_s: float = float("nan")   # priced p99 of the new plan
    incumbent_p99_s: float = float("nan")   # priced p99 of the old plan
    n_delayed: int = 0               # requests held back by warm-up
    added_delay_s: float = 0.0       # total seconds of warm-up delay


@dataclass(frozen=True)
class EraStats:
    """One plan era's outcome (arrivals in ``[t_start, t_end)``, drained
    to completion on that era's plan)."""
    key: str
    t_start: float
    t_end: float
    n_replicas: int
    n_offered: int
    n_served: int
    dropped: int
    p50_s: float
    p99_s: float
    forced: bool                     # era opened by a forced reconfig


@dataclass(frozen=True)
class AdaptiveRunResult:
    """Everything one adaptive (or static) run produced."""
    engine: str
    latencies: np.ndarray            # end-to-end seconds, served requests
    n_offered: int
    dropped: int
    eras: tuple                      # EraStats, time order
    switches: tuple                  # SwitchRecord, time order
    n_decisions: int                 # control ticks evaluated
    n_replans: int                   # re-screens actually computed
    n_suppressed: int                # triggers that did not switch

    @property
    def n_switches(self) -> int:
        """Voluntary switches — the quantity ``max_switches`` bounds."""
        return sum(1 for s in self.switches if not s.forced)

    @property
    def n_forced(self) -> int:
        return sum(1 for s in self.switches if s.forced)

    @property
    def plan_keys(self) -> tuple:
        return tuple(e.key for e in self.eras)

    @property
    def p50_s(self) -> float:
        return (float(np.percentile(self.latencies, 50))
                if len(self.latencies) else float("nan"))

    @property
    def p99_s(self) -> float:
        return (float(np.percentile(self.latencies, 99))
                if len(self.latencies) else float("nan"))

    @property
    def drop_fraction(self) -> float:
        return self.dropped / self.n_offered if self.n_offered else 0.0

    @property
    def migration(self) -> dict:
        """Aggregate migration disruption across every switch."""
        return {"n_delayed": sum(s.n_delayed for s in self.switches),
                "added_delay_s": sum(s.added_delay_s
                                     for s in self.switches)}


# ------------------------------------------------------------ era state ----
class _Era:
    """Mutable state of the currently-running plan era."""

    __slots__ = ("cand", "k_eff", "t_start", "warmup_end", "forced",
                 "switch", "t_arr", "offer", "count", "dev_pos", "sim",
                 "drops_mark", "served_mark")

    def __init__(self, cand: CandidatePlan, k_eff: int, t_start: float,
                 warmup_end: float, forced: bool,
                 switch: Optional[SwitchRecord]):
        self.cand, self.k_eff = cand, k_eff
        self.t_start, self.warmup_end = t_start, warmup_end
        self.forced, self.switch = forced, switch
        self.t_arr: list = []        # arrival-time chunks (np arrays)
        self.offer: list = []        # matching offer-time chunks
        self.count = 0
        self.dev_pos: dict = {}      # device name -> wire-draw cursor
        self.sim: Optional[ClusterSim] = None   # event engine only
        self.drops_mark = 0          # cumulative drops at last decision
        self.served_mark = 0         # served-list watermark

    def arrays(self):
        if not self.t_arr:
            return np.empty(0), np.empty(0)
        return np.concatenate(self.t_arr), np.concatenate(self.offer)


_ZERO_FLOW = {"edge_s": 0.0, "wire_s": np.zeros(1), "wire_bytes": 0,
              "accuracy": 1.0}


class AdaptiveController:
    """Drift-aware closed-loop replanner over a fixed candidate grid.

    ``flow_fn(device, cand, protocol) -> {"edge_s", "wire_s",
    "wire_bytes", "accuracy"}`` prices the per-device pre-cluster leg
    (edge compute + wire draws); ``None`` means a zero-cost leg
    (planner-free mode).  Flows are cached per (device, candidate label,
    protocol, link epoch) — a link degradation advances the epoch and
    forces a re-price, which is how degraded wires reach both the
    simulation and the replan pricing.
    """

    def __init__(self, candidates: Sequence[CandidatePlan], *,
                 qos: Optional[QoSRequirements] = None,
                 config: Optional[ControllerConfig] = None,
                 flow_fn: Optional[Callable] = None,
                 planner=None, obs=None):
        cands = tuple(candidates)
        if not cands:
            raise ValueError("need at least one CandidatePlan")
        keys = [c.key for c in cands]
        if len(set(keys)) != len(keys):
            raise ValueError("candidate keys must be unique")
        self.candidates = cands
        self.by_key = {c.key: c for c in cands}
        self.qos = qos
        self.config = config if config is not None else ControllerConfig()
        self.obs = NULL if obs is None else obs
        self._flow_fn = flow_fn
        self._planner = planner      # for epoch-keyed flow-cache clearing
        self._flow_cache: dict = {}
        self._planner_epochs = None
        self._scheds: dict = {}
        self._mix: dict = {}
        # runtime fault reports (t_s, n): the live runtime's recovery
        # counters, consumed by the fault_trigger rescue rule
        self._fault_reports: list = []

    def report_faults(self, t_s: float, n: int = 1) -> None:
        """Feed the controller the live runtime's fault counters (e.g.
        ``RuntimeResult.meta["recovery"]["retries"]`` or a
        ``runtime.fault.*`` telemetry sum) stamped at sim-time ``t_s``.
        With ``config.fault_trigger`` set, ``>= fault_trigger`` reported
        faults inside one control window trigger a replan (reason
        ``"runtime-fault"``) — the runtime's degradation becomes a
        rescue signal, not just a log line."""
        if n > 0:
            self._fault_reports.append((float(t_s), int(n)))

    def _runtime_faults_between(self, t0: float, t1: float) -> int:
        return sum(n for t, n in self._fault_reports if t0 < t <= t1)

    # ------------------------------------------------------ construction ----
    @classmethod
    def from_planner(cls, planner, space, *, qos=None, config=None,
                     obs=None) -> "AdaptiveController":
        """The controller's grid from a planner's search space: CS-ranked
        split candidates x protocol x batch x replicas, each priced by
        the planner's flow machinery (measured or analytic, whatever the
        planner was configured with)."""
        import itertools
        cands = []
        for sc in planner.candidates(space):
            label, split = sc
            if label == "LC":        # all-edge: nothing to re-plan
                continue
            for proto in space.protocols:
                for b, r in itertools.product(space.batch_sizes,
                                              space.replica_counts):
                    cands.append(CandidatePlan(
                        key=f"{label}:{proto}:b{b}:r{r}", label=label,
                        split=split, protocol=proto, max_batch=b,
                        n_replicas=r, batch_window_s=space.batch_window_s,
                        cost=planner._cost_model(split)))

        def flow_fn(device, cand, proto):
            return planner._flow(device, cand.label, cand.split, proto)

        return cls(cands, qos=qos, config=config, flow_fn=flow_fn,
                   planner=planner, obs=obs if obs is not None
                   else planner.obs)

    # ------------------------------------------------------------- flows ----
    def _flow_for(self, device, cand: CandidatePlan, epoch: int) -> dict:
        proto = (cand.protocol if cand.protocol in device.protocols
                 else device.protocols[0])
        key = (device.name, cand.label, proto, epoch)
        hit = self._flow_cache.get(key)
        if hit is not None:
            return hit
        if self._flow_fn is None:
            flow = _ZERO_FLOW
        else:
            if self._planner is not None and epoch != self._planner_epochs:
                # the planner caches flows per (device, label, protocol)
                # with no link-state key; a new epoch means those prices
                # are stale for the changed channel
                self._planner._flow_cache.clear()
                self._planner_epochs = epoch
            flow = self._flow_fn(device, cand, proto)
        self._flow_cache[key] = flow
        return flow

    def _device_at_epoch(self, name: str, epoch: int):
        d, sched = self._mix[name], self._scheds[name]
        if epoch == 0:
            return d
        return replace(d, channel=sched.events[epoch - 1][1])

    # ------------------------------------------------------- offer build ----
    def _offer_times(self, era: _Era, t_arr: np.ndarray,
                     dev: np.ndarray) -> np.ndarray:
        """Cluster offer times for arrivals joining ``era``: arrival +
        per-device pre-delay (edge compute + the device's wire draw,
        priced against the link regime active at the arrival), clamped
        to the era's warm-up end.  Clamped requests are the migration
        disruption, tallied onto the switch that opened the era."""
        offer = np.empty(len(t_arr))
        for name in np.unique(dev):
            idxs = np.nonzero(dev == name)[0]
            sched = self._scheds[name]
            pos0 = era.dev_pos.get(name, 0)
            era.dev_pos[name] = pos0 + len(idxs)
            ranks = pos0 + np.arange(len(idxs))
            ev_t = np.array([e[0] for e in sched.events])
            ep = (np.searchsorted(ev_t, t_arr[idxs], side="right")
                  if len(ev_t) else np.zeros(len(idxs), np.int64))
            for e in np.unique(ep):
                m = ep == e
                flow = self._flow_for(self._device_at_epoch(name, int(e)),
                                      era.cand, int(e))
                wire = np.asarray(flow["wire_s"], float)
                pre = flow["edge_s"] + wire[ranks[m] % len(wire)]
                raw = t_arr[idxs[m]] + pre
                clamped = np.maximum(raw, era.warmup_end)
                if era.switch is not None:
                    late = raw < era.warmup_end
                    era.switch.n_delayed += int(late.sum())
                    era.switch.added_delay_s += float(
                        (era.warmup_end - raw[late]).sum())
                offer[idxs[m]] = clamped
        return offer

    # --------------------------------------------------- screen + price ----
    def _screen_latency(self, cand: CandidatePlan, t_now: float) -> float:
        """Closed-form single-request latency proxy (``netsim.analytic``
        wire + edge compute + unbatched service), fleet-weighted — the
        cheap ordering the shortlist is cut with; never a price a switch
        is decided on."""
        num = den = 0.0
        for name, d in self._mix.items():
            epoch = self._scheds[name].epoch(t_now)
            dev = self._device_at_epoch(name, epoch)
            flow = self._flow_for(dev, cand, epoch)
            wire = 0.0
            if flow.get("wire_bytes", 0) > 0:
                proto = (cand.protocol if cand.protocol in dev.protocols
                         else dev.protocols[0])
                pp = analytic.path_params(
                    NetworkPath((NetworkConfig(proto, dev.channel),)))
                wire = float(analytic.transfer_duration_s(
                    np.array([flow["wire_bytes"]]), pp)[0])
            num += d.weight * (flow["edge_s"] + wire)
            den += d.weight
        return num / den + cand.cost.service_time(1)

    def _shortlist(self, rate_hz: float, t_now: float,
                   avail: Optional[int],
                   current: Optional[CandidatePlan]) -> list:
        """Capacity-feasible candidates, ordered by the closed-form
        latency screen, cut to ``max_priced`` (+ the incumbent, always,
        so hysteresis compares like for like)."""
        rows = [(c, c.capacity_hz(avail), self._screen_latency(c, t_now))
                for c in self.candidates]
        ok = [r for r in rows if r[1] > rate_hz]
        if not ok:                   # everything saturates: least-bad first
            ok = sorted(rows, key=lambda r: -r[1])
        short = [r[0] for r in
                 sorted(ok, key=lambda r: (r[2], r[0].key))]
        short = short[:self.config.max_priced]
        if current is not None and all(c.key != current.key for c in short):
            short.append(current)
        return short

    def _price(self, cand: CandidatePlan, window: Trace, t_now: float,
               avail: Optional[int]) -> dict:
        """Vectorized-engine price of one candidate on the lookback
        window — always the vectorized engine, whatever engine runs the
        simulation, so decisions are engine-independent."""
        k = (cand.n_replicas if avail is None
             else min(cand.n_replicas, avail))
        t_arr = window.arrival_times()
        if not len(t_arr):
            return {"p99_s": 0.0, "p50_s": 0.0, "drop_fraction": 0.0,
                    "accuracy": 1.0, "k": k, "n": 0}
        dev = np.array([r.device for r in window.requests])
        offer = np.empty(len(t_arr))
        acc = 1.0
        for name in np.unique(dev):
            idxs = np.nonzero(dev == name)[0]
            epoch = self._scheds[name].epoch(t_now)
            flow = self._flow_for(self._device_at_epoch(name, epoch),
                                  cand, epoch)
            acc = min(acc, float(flow.get("accuracy", 1.0)))
            wire = np.asarray(flow["wire_s"], float)
            pre = flow["edge_s"] + wire[np.arange(len(idxs)) % len(wire)]
            offer[idxs] = t_arr[idxs] + pre
        v = simulate_cluster_vectorized(offer, cand.cost,
                                        cand.cluster_cfg(k))
        keep = ~v.drop_mask
        lat = v.t_done[keep] - t_arr[keep]
        return {
            "p99_s": float(np.percentile(lat, 99)) if len(lat)
            else float("inf"),
            "p50_s": float(np.percentile(lat, 50)) if len(lat)
            else float("inf"),
            "drop_fraction": v.drop_fraction(),
            "accuracy": acc, "k": k, "n": len(t_arr),
        }

    def _choose(self, window: Trace, t_now: float, avail: Optional[int],
                current: Optional[CandidatePlan]):
        """Re-screen the space on the lookback window: closed-form
        shortlist, vectorized pricing, QoS-feasible-first selection.
        Returns ``(best, priced)`` with the incumbent always priced."""
        rate = len(window) / max(window.horizon_s, 1e-9)
        short = self._shortlist(rate, t_now, avail, current)
        priced = {c.key: self._price(c, window, t_now, avail)
                  for c in short}
        qos = self.qos

        def feasible(c):
            p = priced[c.key]
            if p["drop_fraction"] != 0.0:
                return False
            return qos is None or (p["p99_s"] <= qos.max_latency_s
                                   and p["accuracy"] >= qos.min_accuracy)

        pool = [c for c in short if feasible(c)] or short
        best = min(pool, key=lambda c: (priced[c.key]["drop_fraction"],
                                        priced[c.key]["p99_s"],
                                        c.n_replicas, c.max_batch, c.key))
        return best, priced

    # ----------------------------------------------------------- signals ----
    def _signals(self, era: _Era, t: float, t_prev: float,
                 engine: str) -> dict:
        win = t - t_prev
        t_a, off = era.arrays()
        if engine == "vectorized":
            if not len(off):
                return signals_at(t, t_offer=off, t_dispatch=off,
                                  t_done=off, drop_mask=off.astype(bool),
                                  window_s=win, t_prev=t_prev)
            v = simulate_cluster_vectorized(off, era.cand.cost,
                                            era.cand.cluster_cfg(era.k_eff))
            return signals_at(t, t_offer=v.t_offer,
                              t_dispatch=v.t_dispatch, t_done=v.t_done,
                              drop_mask=v.drop_mask, window_s=win,
                              t_prev=t_prev)
        # event engine: same quantities from the live simulation — every
        # count matches the vectorized prefix replay exactly (drops and
        # dispatches are decided at offer times, which are shared inputs)
        sim = era.sim
        past = int((off <= t).sum()) if len(off) else 0
        n_arr = int(((off > t_prev) & (off <= t)).sum()) if len(off) else 0
        drops_now = sim.stats.dropped
        n_drop = drops_now - era.drops_mark
        era.drops_mark = drops_now
        served = sim.stats.served
        new = served[era.served_mark:]
        era.served_mark = len(served)
        lat = np.array([r.latency_s for r in new], float)
        depth = sim.queue_depth
        return {
            "t": t, "arrivals": n_arr,
            "rate_hz": n_arr / win if win > 0 else 0.0,
            "drops": n_drop,
            "drop_fraction": n_drop / n_arr if n_arr else 0.0,
            "queue_depth": depth,
            "inflight": (past - drops_now) - len(served) - depth,
            "n_done": len(lat),
            "p50_s": float(np.percentile(lat, 50)) if len(lat)
            else float("nan"),
            "p99_s": float(np.percentile(lat, 99)) if len(lat)
            else float("nan"),
        }

    # --------------------------------------------------------- era admin ----
    def _open_era(self, cand: CandidatePlan, avail: Optional[int],
                  t: float, engine: str, *, forced: bool = False,
                  switch: Optional[SwitchRecord] = None,
                  warmup_s: float = 0.0) -> _Era:
        k = cand.n_replicas if avail is None else min(cand.n_replicas,
                                                      avail)
        era = _Era(cand, k, t, t + warmup_s, forced, switch)
        if engine == "event":
            era.sim = ClusterSim(cand.cost, cand.cluster_cfg(k))
        return era

    def _close_era(self, era: _Era, t_end: float, engine: str):
        """Drain the era to completion; returns (EraStats, latencies)."""
        t_a, off = era.arrays()
        if engine == "event":
            era.sim.run()            # drain: in-flight work finishes here
            st = era.sim.stats
            lat = np.array([rec.latency_s + (off[rec.rid] - t_a[rec.rid])
                            for rec in st.served])
            n_served, dropped = len(st.served), st.dropped
        elif len(off):
            v = simulate_cluster_vectorized(off, era.cand.cost,
                                            era.cand.cluster_cfg(era.k_eff))
            keep = ~v.drop_mask
            lat = v.t_done[keep] - t_a[keep]
            n_served, dropped = v.n_served, v.dropped
        else:
            lat = np.empty(0)
            n_served = dropped = 0
        stats = EraStats(
            era.cand.key, era.t_start, t_end, era.k_eff, era.count,
            n_served, dropped,
            float(np.percentile(lat, 50)) if len(lat) else float("nan"),
            float(np.percentile(lat, 99)) if len(lat) else float("nan"),
            era.forced)
        if self.obs.enabled:
            self.obs.tracer.add(
                f"era[{era.cand.key}]", era.t_start, t_end, clock="sim",
                tid="controller", cat="controller",
                args={"replicas": era.k_eff, "offered": era.count,
                      "dropped": dropped, "forced": era.forced})
        return stats, lat

    # --------------------------------------------------------- main loop ----
    def run(self, scenario: RegimeChangeTrace, *,
            initial: Optional[str] = None, engine: str = "vectorized",
            _static: bool = False) -> AdaptiveRunResult:
        """Run the closed loop over ``scenario`` on either cluster
        engine.  ``initial`` pins the starting plan by key; ``None``
        picks it online-realistically — priced on the *first* control
        window only, because at deploy time the controller can observe
        the current regime, not the future.  (A static planner sizing
        for the whole horizon is :meth:`best_static`.)"""
        if engine not in ("event", "vectorized"):
            raise ValueError(f"engine must be 'event' or 'vectorized', "
                             f"got {engine!r}")
        cfg, obs = self.config, self.obs
        trace = scenario.trace
        horizon = trace.horizon_s
        t_all = trace.arrival_times()
        dev_all = np.array([r.device for r in trace.requests])
        self._scheds = {d.name: scenario.channel_schedule(d)
                        for d in scenario.mix}
        self._mix = {d.name: d for d in scenario.mix}
        self._flow_cache.clear()
        self._planner_epochs = None

        avail = scenario.available_replicas(0.0)
        if initial is not None:
            cand0 = self.by_key[initial]
        else:
            window0 = trace.slice(0.0, min(cfg.control_period_s, horizon))
            if not len(window0):
                window0 = trace     # nothing observable yet: size for all
            cand0, _ = self._choose(window0, 0.0, avail, None)
        era = self._open_era(cand0, avail, 0.0, engine)
        eras, era_lats, switches = [], [], []
        n_decisions = n_replans = n_suppressed = 0
        last_switch_t = -float("inf")
        ref_rate: Optional[float] = None
        i = 0                        # arrival feed cursor
        t_prev = 0.0                 # previous decision tick

        ticks = [(float(k) * cfg.control_period_s, 1)
                 for k in range(1, int(np.ceil(horizon
                                               / cfg.control_period_s)))
                 if float(k) * cfg.control_period_s < horizon]
        ticks += [(ev.t_s, 0) for ev in scenario.replica_events
                  if 0.0 < ev.t_s < horizon]
        ticks.sort()                 # replica events first on tie (kind 0)

        def feed(until):
            nonlocal i
            j = int(np.searchsorted(t_all, until, side="right"))
            if j <= i:
                return
            t_arr = t_all[i:j]
            offer = self._offer_times(era, t_arr, dev_all[i:j])
            era.t_arr.append(t_arr)
            era.offer.append(offer)
            if engine == "event":
                base = era.count
                for p, off_t in enumerate(offer):
                    era.sim.offer(base + p, float(off_t))
            era.count += len(t_arr)
            i = j

        def close_and_open(cand, t, *, forced, switch, warmup_s=0.0):
            nonlocal era
            stats, lat = self._close_era(era, t, engine)
            eras.append(stats)
            era_lats.append(lat)
            era = self._open_era(cand, avail, t, engine, forced=forced,
                                 switch=switch, warmup_s=warmup_s)

        for t, kind in ticks:
            feed(t)
            if engine == "event":
                era.sim.run(until=t)
            if kind == 0:            # replica fail/recover (physics)
                avail = scenario.available_replicas(t)
                k_new = (era.cand.n_replicas if avail is None
                         else min(era.cand.n_replicas, avail))
                if k_new != era.k_eff:
                    sw = SwitchRecord(t, era.cand.key, era.cand.key,
                                      reason="replica-cap", forced=True)
                    switches.append(sw)
                    close_and_open(era.cand, t, forced=True, switch=sw)
                    if obs.enabled:
                        obs.tracer.instant("switch", t, clock="sim",
                                           tid="controller",
                                           cat="controller",
                                           args={"reason": "replica-cap",
                                                 "replicas": k_new})
                continue

            n_decisions += 1
            if _static:
                t_prev = t
                continue
            t_lo = max(era.t_start, t_prev)
            if t - t_lo <= 1e-12:
                t_prev = t
                continue
            sig = self._signals(era, t, t_lo, engine)
            if obs.enabled:
                m = obs.metrics
                m.record("controller.rate_hz", t, sig["rate_hz"])
                m.record("controller.queue_depth", t, sig["queue_depth"])
                m.record("controller.drop_fraction", t,
                         sig["drop_fraction"])
                if not np.isnan(sig["p99_s"]):
                    m.record("controller.window_p99_s", t, sig["p99_s"])

            faults = scenario.events_between(t_prev, t)
            trig = None
            if faults:
                trig = "fault"
            elif (cfg.fault_trigger is not None
                    and self._runtime_faults_between(t_prev, t)
                    >= cfg.fault_trigger):
                trig = "runtime-fault"
            elif (cfg.drop_trigger is not None
                    and sig["drop_fraction"] > cfg.drop_trigger):
                trig = "drops"
            elif (cfg.queue_trigger is not None
                    and sig["queue_depth"] > cfg.queue_trigger):
                trig = "queue"
            elif cfg.drift_threshold is not None:
                if ref_rate is None:
                    ref_rate = sig["rate_hz"]
                elif (abs(sig["rate_hz"] - ref_rate)
                        > cfg.drift_threshold * max(ref_rate, 1e-9)):
                    trig = "rate-drift"

            if trig is not None:
                n_voluntary = sum(1 for s in switches if not s.forced)
                if (n_voluntary >= cfg.max_switches
                        or t - last_switch_t < cfg.cooldown_s):
                    n_suppressed += 1
                else:
                    n_replans += 1
                    t0w = obs.tracer.wall_now()
                    window = trace.slice(max(0.0,
                                             t - cfg.control_period_s), t)
                    best, priced = self._choose(window, t, avail,
                                                era.cand)
                    cur, new = priced[era.cand.key], priced[best.key]
                    rescue = (cur["drop_fraction"] > 0.0
                              and new["drop_fraction"] == 0.0)
                    improve = (new["p99_s"] < (1.0 - cfg.min_improvement)
                               * cur["p99_s"])
                    if obs.enabled:
                        obs.metrics.counter("controller.replans").inc()
                        obs.tracer.add(
                            "replan", t0w, obs.tracer.wall_now(),
                            clock="wall", tid="controller",
                            cat="controller",
                            args={"t_sim": t, "trigger": trig,
                                  "chosen": best.key,
                                  "n_priced": len(priced)})
                    if best.key != era.cand.key and (rescue or improve):
                        sw = SwitchRecord(
                            t, era.cand.key, best.key, reason=trig,
                            predicted_p99_s=new["p99_s"],
                            incumbent_p99_s=cur["p99_s"])
                        switches.append(sw)
                        last_switch_t = t
                        close_and_open(best, t, forced=False, switch=sw,
                                       warmup_s=cfg.warmup_s)
                        if obs.enabled:
                            obs.metrics.counter(
                                "controller.switches").inc()
                            obs.tracer.add(
                                "switch", t, t + cfg.warmup_s,
                                clock="sim", tid="controller",
                                cat="controller",
                                args={"from": sw.from_key,
                                      "to": sw.to_key, "reason": trig})
                    else:
                        n_suppressed += 1
                ref_rate = sig["rate_hz"]
            t_prev = t

        feed(float("inf"))           # tail arrivals past the last tick
        stats, lat = self._close_era(era, horizon, engine)
        eras.append(stats)
        era_lats.append(lat)

        if obs.enabled:
            m = obs.metrics
            m.counter("controller.decisions").inc(n_decisions)
            m.counter("controller.forced").inc(
                sum(1 for s in switches if s.forced))
            m.counter("controller.suppressed").inc(n_suppressed)

        lat_all = (np.concatenate(era_lats) if era_lats
                   else np.empty(0))
        return AdaptiveRunResult(
            engine=engine, latencies=lat_all, n_offered=len(trace),
            dropped=sum(e.dropped for e in eras), eras=tuple(eras),
            switches=tuple(switches), n_decisions=n_decisions,
            n_replans=n_replans, n_suppressed=n_suppressed)

    def run_static(self, scenario: RegimeChangeTrace, key: str, *,
                   engine: str = "vectorized") -> AdaptiveRunResult:
        """The static baseline: one plan for the whole horizon, on the
        *same* era machinery (physical replica reconfigurations still
        apply — a failed replica is gone whether or not anyone adapts),
        so adaptive-with-no-triggers equals static exactly."""
        return self.run(scenario, initial=key, engine=engine,
                        _static=True)

    def best_static(self, scenario: RegimeChangeTrace,
                    engine: str = "vectorized") -> AdaptiveRunResult:
        """Every candidate run statically; the best by (drop fraction,
        p99) — the strongest fixed-plan baseline the grid offers."""
        runs = [self.run_static(scenario, c.key, engine=engine)
                for c in self.candidates]
        return min(runs, key=lambda r: (r.drop_fraction, r.p99_s))
