# Twin of src/repro/fleet/planner.py: the accuracy legs run ApplicationSimulator on ``device``.
"""QoS-aware deployment planning over a fleet.

Answers "which splits do I deploy for this *population* of clients", not
"which split for this one client".  The search space is

    split point x protocol x channel x batch size x replica count,

pruned with ``core.qos.rank_candidates`` (CS-curve accuracy proxy), costed
per flow with ``netsim`` (edge compute + simulated transfers + measured
accuracy under loss) and per deployment with ``fleet.cluster`` (queueing +
dynamic batching on the ``serving.engine`` replica cost model).  Output is
a Pareto front over (p99 latency, accuracy, server FLOPs/s) and a
``suggest(qos, fleet)`` API that picks one plan per device class.

Beyond the single device->server link, :func:`plan_tiers` searches
multi-tier chains (:class:`TierTopology`: device -> edge -> cloud):
cut-list x stage->tier assignment, each design point priced sequentially
and as a pipelined microbatched schedule.

Both searches are two-phase ("screen fast, verify exact"): the whole
combinatorial space is scored with the vectorized closed-form engine in
``netsim.analytic`` — exhaustively, as array operations — and only the
Pareto-front + top-K shortlist is re-priced by the discrete-event engine
(``netsim.simulator.simulate_pipeline`` / ``measure_flow``), which stays
the single semantic authority: refinement asserts the closed form agrees
to 1e-9 relative on loss-free paths.

The *cluster* leg follows the same contract: ``search`` and
:func:`simulate_deployment` take ``engine="event"|"vectorized"|"auto"``
— the arrival-level NumPy engine (``fleet.vectorized``) prices megafleet
traces orders of magnitude faster, the event engine remains the
authority, and any Pareto-front point screened vectorized is re-priced
exactly before it can be chosen.
"""
from __future__ import annotations

import itertools
import warnings
from dataclasses import dataclass, replace
from typing import Optional, Sequence

import numpy as np

from repro_torch.api.types import SplitCandidate, legal_split_candidates
from repro_torch.core import stats as S
from repro_torch.core.qos import QoSRequirements, pareto_nd, rank_candidates
from repro_torch.core.scenarios import (PLATFORMS, PlatformProfile, Scenario,
                                  cut_payload_bytes_lut,
                                  scenario_times_and_payload)
from repro_torch.core.split import legal_cut_lists, legal_cuts
from repro_torch.device import resolve_device
from repro_torch.fleet.cluster import ClusterConfig, ClusterSim
from repro_torch.fleet.traffic import DeviceClass, Trace
from repro_torch.fleet.vectorized import simulate_cluster_vectorized
from repro_torch.netsim import analytic
from repro_torch.netsim.channel import Channel, compose_channels
from repro_torch.netsim.protocols import RetryBudgetExceeded
from repro_torch.netsim.simulator import (ApplicationSimulator, NetworkConfig,
                                    NetworkPath, measure_flow,
                                    simulate_pipeline)
from repro_torch.obs import NULL
from repro_torch.serving.engine import BatchCostModel


# requests per cluster above which engine="auto" switches from the exact
# event engine to the vectorized arrival-level engine (below it the event
# engine is both authoritative and fast enough)
AUTO_VECTORIZE_MIN = 20_000

CLUSTER_ENGINES = ("event", "vectorized", "auto")


def _resolve_engine(engine: str, n_requests: int) -> str:
    """'event' or 'vectorized' for a concrete run of ``n_requests``."""
    if engine not in CLUSTER_ENGINES:
        raise ValueError(f"engine must be one of {CLUSTER_ENGINES}, "
                         f"got {engine!r}")
    if engine == "auto":
        return ("vectorized" if n_requests >= AUTO_VECTORIZE_MIN
                else "event")
    return engine


@dataclass(frozen=True)
class SearchSpace:
    split_points: tuple              # legal cut layers to consider
    protocols: tuple = ("tcp", "udp")
    batch_sizes: tuple = (1, 8)
    replica_counts: tuple = (1, 2)
    batch_window_s: float = 2e-3
    top_k_splits: int = 2            # CS-ranked prune before simulation
    include_rc: bool = True
    include_lc: bool = False


# ------------------------------------------------------- tier topologies ----
@dataclass(frozen=True)
class Tier:
    """One compute tier of a multi-hop deployment chain.

    ``uplink`` is the physical link toward the next tier (None for the
    last); ``platform`` may be a ``core.scenarios`` profile name.
    """
    name: str
    platform: PlatformProfile
    uplink: Optional[Channel] = None
    protocol: str = "tcp"

    def __post_init__(self):
        if isinstance(self.platform, str):
            if self.platform not in PLATFORMS:
                raise KeyError(f"unknown platform {self.platform!r}; "
                               f"known: {sorted(PLATFORMS)}")
            object.__setattr__(self, "platform", PLATFORMS[self.platform])


@dataclass(frozen=True)
class TierTopology:
    """An ordered device -> edge -> ... -> cloud tier chain.

    The search space of :func:`plan_tiers`: stages of a cut list are
    assigned to an increasing subsequence of these tiers (sensing always
    on tier 0), the payload store-and-forwards through any skipped tier.
    """
    tiers: tuple

    def __post_init__(self):
        tiers = tuple(self.tiers)
        object.__setattr__(self, "tiers", tiers)
        if len(tiers) < 2:
            raise ValueError("a topology needs at least 2 tiers")
        missing = [t.name for t in tiers[:-1] if t.uplink is None]
        if missing:
            raise ValueError(f"tiers {missing} have no uplink toward the "
                             f"next tier")

    def __len__(self):
        return len(self.tiers)

    def __iter__(self):
        return iter(self.tiers)

    def __getitem__(self, i) -> Tier:
        return self.tiers[i]

    @property
    def platforms(self) -> tuple:
        return tuple(t.platform for t in self.tiers)

    def path(self) -> NetworkPath:
        """The full physical link chain as a :class:`NetworkPath`."""
        return NetworkPath(tuple(NetworkConfig(t.protocol, t.uplink)
                                 for t in self.tiers[:-1]))


@dataclass(frozen=True)
class TierPlan:
    """One evaluated (cut list, stage->tier assignment) design point."""
    splits: tuple                    # ordered cut list (K cuts)
    stage_tiers: tuple               # tier names, one per stage (K+1)
    tier_index: tuple                # tier indices, one per stage (K+1)
    latency_s: float                 # pipelined one-sample makespan
    sequential_s: float              # no-overlap reference
    n_micro: int
    stage_s: tuple                   # per physical tier (pass-throughs 0)
    hop_bytes: tuple                 # per physical link
    accuracy_proxy: float = 0.0      # min CS over the cuts (weakest stage)
    refined: bool = False            # latency re-priced by the event engine

    @property
    def speedup(self) -> float:
        return self.sequential_s / self.latency_s if self.latency_s else 1.0

    def satisfies(self, qos: QoSRequirements) -> bool:
        return (self.latency_s <= qos.max_latency_s
                and self.accuracy_proxy >= qos.min_accuracy)

    def runtime_path(self, topology: TierTopology) -> list:
        """One :class:`NetworkConfig` per *logical* wire hop, for a
        ``runtime.SplitRuntime`` executing this plan.  A logical hop that
        store-and-forwards through skipped tiers is priced over the
        composed effective channel (``netsim.channel.compose_channels``).
        """
        out = []
        for j in range(len(self.splits)):
            a, b = self.tier_index[j], self.tier_index[j + 1]
            links = [topology[t] for t in range(a, b)]
            out.append(NetworkConfig(
                links[0].protocol,
                compose_channels([t.uplink for t in links])))
        return out


def _screen_combos(model, topology: TierTopology, pool, cut_counts) -> list:
    """Materialize the (cut list, assignment) candidate set as per-k
    NumPy blocks: ``(cuts (N,k), assigns (N,k))`` index arrays."""
    n_links = len(topology) - 1
    blocks = []
    for k in (cut_counts or range(1, n_links + 1)):
        if k > n_links or k > len(pool):
            continue
        # enumeration routes through the legality authority, restricted
        # to the pool — never a locally re-derived cut set
        cut_lists = [cl for cl in legal_cut_lists(model, k)
                     if all(c in pool for c in cl)]
        assigns = list(itertools.combinations(range(1, n_links + 1), k))
        if not cut_lists or not assigns:
            continue
        blocks.append((np.repeat(np.asarray(cut_lists, int),
                                 len(assigns), axis=0),
                       np.tile(np.asarray(assigns, int),
                               (len(cut_lists), 1))))
    return blocks


def _pareto2_indices(plans: Sequence[TierPlan]) -> list:
    """Indices of the (latency, -accuracy_proxy) Pareto front of a list
    already sorted by (latency, -proxy) — one linear sweep, no O(N^2)."""
    out, best = [], -np.inf
    for i, p in enumerate(plans):
        if not out or p.accuracy_proxy > best:
            out.append(i)
            best = max(best, p.accuracy_proxy)
    return out


def plan_tiers(model, params, topology: TierTopology, *,
               n_micro: int = 4, cs_curve=None, layer_idx=None,
               compression: float = 0.5, wire_dtype_bytes: int = 4,
               batch: int = 1, sample=None, cut_pool=None,
               cut_counts=None, max_evals: int = 2048,
               refine: int = 8, obs=None) -> list:
    """Search cut-list x stage->tier assignment over ``topology``.

    Every legal cut list of each considered length (default: 1 up to the
    number of links) is combined with every increasing assignment of its
    stages onto the tier chain (stage 0 always on tier 0 — the sensing
    node; skipped tiers forward the payload without computing, ending
    early is allowed).  The search is two-phase:

    1. **screen** — the *whole* combo set is priced with the vectorized
       closed-form engine (``netsim.analytic``): per-layer FLOPs prefix
       sums and per-cut payloads are computed once, every combination's
       sequential and ``n_micro``-pipelined makespan as array ops.  The
       screen is exhaustive — no combination is ever dropped.
    2. **refine** — the (latency, accuracy-proxy) Pareto front plus the
       ``refine`` fastest survivors are re-priced exactly by the event
       engine (``netsim.simulator.simulate_pipeline``), with a built-in
       assertion that the closed form agrees to 1e-9 relative on
       loss-free paths (``TierPlan.refined`` marks them).  On lossy
       links the screen is loss-free-optimistic, so refinement iterates
       to a fixpoint: the front and top-``refine`` of the *final*
       ordering are guaranteed event-priced (the QoS winner
       ``suggest_tier_plan`` picks is always on that front); plans
       outside the shortlist keep the screen price.

    Returns :class:`TierPlan`\\ s for **all** combos, sorted by
    (pipelined latency, -accuracy proxy).  ``cut_pool`` restricts the
    cuts considered (e.g. a CS shortlist); ``max_evals`` bounds only the
    exact-refinement stage (never the sweep) — a shortlist longer than
    ``max_evals`` warns and refines its head.  ``refine=0`` skips
    refinement entirely (pure closed-form screen).

    ``obs`` (a ``repro_torch.obs.Recorder``): the two phases become wall-clock
    spans — ``planner.screen`` with the swept combo count,
    ``planner.refine`` with the event-engine re-pricing count and
    fixpoint rounds — plus ``planner.screen_combos`` /
    ``planner.refined_plans`` counters, so the screen/refine split is
    *visible* in the exported trace rather than asserted by a benchmark.
    """
    from repro_torch.core.scenarios import _sample_scale
    obs = NULL if obs is None else obs
    t_screen0 = obs.tracer.wall_now()
    scale = _sample_scale(batch, sample)
    prefix = S.flops_prefix(model, params, batch, sample=sample) * scale
    pay = cut_payload_bytes_lut(model, params, batch,
                                compression=compression,
                                wire_dtype_bytes=wire_dtype_bytes,
                                sample=sample)
    pos = ({sp: i for i, sp in enumerate(layer_idx)}
           if cs_curve is not None else {})
    pool = set(legal_cuts(model))
    if cut_pool is not None:
        pool &= set(cut_pool)
    if cs_curve is not None:
        pool &= set(pos)

    platforms = topology.platforms
    n_tiers, n_links = len(topology), len(topology) - 1
    full_path = topology.path()
    pp = analytic.path_params(full_path)
    cs_lut = np.zeros(len(pay))
    if cs_curve is not None:
        for sp, i in pos.items():
            cs_lut[sp] = float(cs_curve[i])

    plans = []
    for cuts_arr, asg_arr in _screen_combos(model, topology, pool,
                                            cut_counts):
        N, k = cuts_arr.shape
        rows_ix = np.arange(N)[:, None]
        # (n_combos, K+1) stage-time tensor: prefix-sum differences over
        # the stage bounds, scattered onto the assigned physical tiers
        bounds = np.concatenate([np.zeros((N, 1), int), cuts_arr + 1,
                                 np.full((N, 1), len(pay), int)], axis=1)
        stage_f = prefix[bounds[:, 1:]] - prefix[bounds[:, :-1]]
        tier_idx = np.concatenate([np.zeros((N, 1), int), asg_arr], axis=1)
        stage_t = np.zeros((N, n_tiers))
        # pricing routes through each platform's compute_time (the single
        # compute-pricing authority), one vectorized call per tier
        for t in range(n_tiers):
            r, c = np.nonzero(tier_idx == t)
            if len(r):
                stage_t[r, t] = platforms[t].compute_time(stage_f[r, c])
        # (n_combos, K) hop-byte tensor: link l carries the payload of
        # logical hop j = #{assigned tiers <= l}; links past the last
        # assigned tier are unused
        cov = (asg_arr[:, :, None]
               <= np.arange(n_links)[None, None, :]).sum(1)
        used = cov < k
        hop_b = np.where(
            used, pay[cuts_arr[rows_ix, np.clip(cov, 0, k - 1)]], 0.0)

        pipe_s, seq_s = analytic.pipeline_makespan_s(stage_t, hop_b, pp,
                                                     n_micro, hop_mask=used)
        # microbatching is a choice: where packetisation overhead beats
        # the overlap, the plan ships unchopped (n_micro 1)
        lat = np.minimum(pipe_s, seq_s)
        n_eff = np.where(seq_s < pipe_s, 1, n_micro)
        proxy = (cs_lut[cuts_arr].min(axis=1) if cs_curve is not None
                 else np.zeros(N))
        for i in range(N):
            idx = tuple(tier_idx[i])
            last = idx[-1]
            plans.append(TierPlan(
                tuple(int(c) for c in cuts_arr[i]),
                tuple(topology[t].name for t in idx), idx,
                float(lat[i]), float(seq_s[i]), int(n_eff[i]),
                tuple(float(s) for s in stage_t[i, :last + 1]),
                tuple(int(b) for b in hop_b[i, :last]),
                float(proxy[i])))

    if obs.enabled:
        obs.tracer.add("planner.screen", t_screen0, obs.tracer.wall_now(),
                       clock="wall", tid="planner", cat="planner",
                       args={"n_combos": len(plans), "n_micro": n_micro,
                             "n_tiers": n_tiers})
        obs.metrics.counter("planner.screen_combos").inc(len(plans))

    order = lambda p: (p.latency_s, -p.accuracy_proxy)  # noqa: E731
    plans.sort(key=order)
    # fixpoint refinement: re-pricing a lossy shortlist moves it upward
    # (the screen is loss-free-optimistic for TCP), which can promote
    # un-refined plans into the front/top-K of the *new* ordering —
    # iterate until the final ordering's Pareto front and `refine`
    # fastest plans are all event-priced (one pass suffices on exact
    # paths: prices don't move).  The QoS winner downstream
    # (suggest_tier_plan) is always on that front, so it can never be a
    # screen price.  max_evals bounds the total event-engine calls.
    budget = max_evals if refine else 0
    t_refine0, n_refined, n_rounds = obs.tracer.wall_now(), 0, 0
    n_infeasible = 0
    while refine and plans:
        shortlist = sorted(set(_pareto2_indices(plans))
                           | set(range(min(refine, len(plans)))))
        todo = [i for i in shortlist if not plans[i].refined]
        if not todo:
            break
        capped = budget < len(todo)
        if capped:
            warnings.warn(
                f"plan_tiers screened all {len(plans)} (cut list, "
                f"assignment) combinations closed-form, but the event "
                f"engine re-priced only {max_evals} plans "
                f"(max_evals={max_evals}); {len(todo) - budget} "
                f"shortlisted plans keep screen latencies — exact on "
                f"loss-free paths, loss-free-optimistic otherwise",
                stacklevel=2)
            todo = todo[:budget]
        budget -= len(todo)
        for i in todo:
            p = plans[i]
            path = NetworkPath(full_path.hops[:p.tier_index[-1]])
            try:
                pipe = simulate_pipeline(list(p.stage_s), list(p.hop_bytes),
                                         path, n_micro=n_micro,
                                         check_closed_form=True)
            except RetryBudgetExceeded:
                # the event engine found a hop too lossy to deliver: the
                # plan is infeasible (inf latency fails every QoS bar),
                # the sweep continues
                n_infeasible += 1
                plans[i] = replace(p, latency_s=float("inf"),
                                   sequential_s=float("inf"), refined=True)
                continue
            n_eff, lat = n_micro, pipe.latency_s
            if pipe.sequential_s < lat:
                n_eff, lat = 1, pipe.sequential_s
            plans[i] = replace(p, latency_s=lat,
                               sequential_s=pipe.sequential_s,
                               n_micro=n_eff, refined=True)
        n_refined += len(todo)
        n_rounds += 1
        plans.sort(key=order)
        if capped:
            break
    if obs.enabled and refine:
        obs.tracer.add("planner.refine", t_refine0, obs.tracer.wall_now(),
                       clock="wall", tid="planner", cat="planner",
                       args={"n_refined": n_refined, "rounds": n_rounds,
                             "n_combos": len(plans),
                             "n_infeasible": n_infeasible})
        obs.metrics.counter("planner.refined_plans").inc(n_refined)
        if n_infeasible:
            obs.metrics.counter("planner.infeasible_plans").inc(n_infeasible)
    return plans


def suggest_tier_plan(plans: Sequence[TierPlan],
                      qos: QoSRequirements) -> Optional[TierPlan]:
    """The best QoS-feasible tier plan: max accuracy proxy, then min
    pipelined latency (None when nothing in ``plans`` satisfies).

    On a :func:`plan_tiers` result (``refine > 0``, ``max_evals`` not
    hit) the winner is guaranteed event-priced: it always lies on the
    (latency, -proxy) Pareto front, which refinement re-prices to a
    fixpoint — so a loss-blind screen latency can never be what clears
    the QoS bar here."""
    ok = [p for p in plans if p.satisfies(qos)]
    if not ok:
        return None
    return max(ok, key=lambda p: (p.accuracy_proxy, -p.latency_s))


@dataclass(frozen=True)
class PlanPoint:
    """One evaluated deployment option for one device class."""
    device: str
    label: str                       # 'SC@k' | 'RC' | 'LC'
    split_layer: Optional[int]
    protocol: Optional[str]
    max_batch: int
    n_replicas: int
    p50_s: float
    p99_s: float
    accuracy: float
    server_flops_per_s: float
    drop_fraction: float
    batch_window_s: float = 0.0      # window the point was simulated under
    engine: str = "event"            # cluster engine that priced this point

    def objectives(self) -> tuple:
        """Minimised objective vector for the Pareto filter."""
        return (self.p99_s, -self.accuracy, self.server_flops_per_s)

    def satisfies(self, qos: QoSRequirements) -> bool:
        return (self.p99_s <= qos.max_latency_s
                and self.accuracy >= qos.min_accuracy
                and self.drop_fraction == 0.0)


class DeploymentPlanner:
    """Searches deployments of ``model`` for a heterogeneous fleet.

    ``ae_map`` maps split layer -> trained bottleneck AE (splits without an
    entry ship the raw activation).  ``accuracy_fn(scenario, netcfg)``
    overrides the measured-accuracy path (tests / analytic proxies);
    without it, accuracy comes from ``ApplicationSimulator`` on
    ``eval_data`` — real forwards on loss-corrupted tensors.

    ``cost``: any :class:`repro_torch.api.types.CostModel` pricing both the
    per-flow stage times and the server's batched service time; cells it
    can't price fall back to the analytic FLOPs model.

    ``device``: where the accuracy legs' ``ApplicationSimulator`` runs its
    forwards; ``params``, ``ae_map`` and ``lc_params`` must lie there.

    ``obs`` (a ``repro_torch.obs.Recorder``): :meth:`search` emits wall-clock
    phase spans (one per device class, with leg/point counts) and
    ``planner.evaluated_points`` / ``planner.screened_legs`` counters.
    The throwaway grid-point cluster simulations are deliberately *not*
    traced (a full search would swamp the trace with dead design
    points); :func:`simulate_deployment` traces the chosen plans' shared
    clusters instead.
    """

    def __init__(self, model, params, *, cs_curve, layer_idx,
                 ae_map=None, eval_data=None, accuracy_fn=None,
                 lc_model=None, lc_params=None,
                 server_platform=PLATFORMS["server-gpu"],
                 input_bytes: Optional[int] = None, n_frames: int = 8,
                 cost=None, sample=None, obs=None, device="cuda"):
        if accuracy_fn is None and eval_data is None:
            raise ValueError("need eval_data to measure accuracy "
                             "(or pass accuracy_fn)")
        if input_bytes is None and eval_data is None:
            raise ValueError("need input_bytes when no eval_data is given "
                             "(it is derived from the eval inputs otherwise)")
        self.model, self.params = model, params
        self.cs_curve, self.layer_idx = cs_curve, list(layer_idx)
        self.ae_map = dict(ae_map or {})
        self.eval_data = eval_data
        self.accuracy_fn = accuracy_fn
        self.lc_model, self.lc_params = lc_model, lc_params
        self.server_platform = server_platform
        if input_bytes is None:
            xs = eval_data[0]
            input_bytes = int(np.prod(xs.shape[1:])) * 4
        self.input_bytes = input_bytes
        self.n_frames = n_frames
        self.cost = cost
        # example input pytree for models whose input_shape cannot
        # describe the input (transformer layered views)
        self.sample = sample
        self.obs = NULL if obs is None else obs
        self.device = resolve_device(device)
        self._flow_cache = {}
        self._cost_cache = {}
        # design points whose wire pricing blew the TCP retry budget
        # (link infeasible at that loss rate): skipped, not crashed
        self.n_infeasible_legs = 0

    # ------------------------------------------------------- candidates ----
    def candidates(self, space: SearchSpace) -> list[SplitCandidate]:
        """CS-ranked SC cuts (pruned to top-k) plus RC/LC per the space
        flags — core.qos ranking reused as-is.  Elements are
        :class:`repro_torch.api.types.SplitCandidate`\\ s (tuple-compatible with
        the historical ``(label, split_layer)`` shape)."""
        ranked = rank_candidates(self.cs_curve, self.layer_idx,
                                 space.split_points, include_lc_rc=False)
        out = list(ranked[:space.top_k_splits])
        if space.include_rc:
            out.append(SplitCandidate.rc())
        if space.include_lc and self.lc_model is not None:
            out.append(SplitCandidate.lc())
        return out

    def _scenario(self, device: DeviceClass, label: str,
                  split: Optional[int]) -> Scenario:
        cand = SplitCandidate.from_any((label, split))
        return cand.scenario(device.platform, self.server_platform)

    # ------------------------------------------------------ per-flow leg ----
    def _flow(self, device: DeviceClass, label: str, split: Optional[int],
              protocol: str) -> dict:
        """Edge compute, wire-time samples and accuracy for one
        (device class, candidate, protocol) leg — cached, since every
        (batch, replicas) point shares it."""
        key = (device.name, label, protocol)
        if key in self._flow_cache:
            return self._flow_cache[key]
        scenario = self._scenario(device, label, split)
        netcfg = NetworkConfig(protocol, device.channel)
        flow = measure_flow(scenario, netcfg, self.model, self.params,
                            self.input_bytes, n_frames=self.n_frames,
                            cost=self.cost, sample=self.sample)
        if self.accuracy_fn is not None:
            acc = float(self.accuracy_fn(scenario, netcfg))
        else:
            xs, ys = self.eval_data
            sim = ApplicationSimulator(
                self.model, self.params, netcfg, ae=self.ae_map.get(split),
                lc_model=self.lc_model, lc_params=self.lc_params,
                device=self.device)
            # reuse this leg's transfer draws — don't re-simulate them
            acc = sim.simulate(scenario, xs, ys, n_frames=self.n_frames,
                               flow=flow).accuracy
        flow["accuracy"] = acc
        self._flow_cache[key] = flow
        return flow

    def _cost_model(self, split: Optional[int]) -> BatchCostModel:
        if split not in self._cost_cache:
            cost = None
            if self.cost is not None and hasattr(self.cost, "server_cost"):
                # measured (or otherwise externally priced) server stage
                cost = self.cost.server_cost(split, self.server_platform)
            if cost is None:
                cost = BatchCostModel.for_split(
                    self.model, self.params, split, self.server_platform,
                    sample=self.sample)
            self._cost_cache[split] = cost
        return self._cost_cache[split]

    # ------------------------------------------------------- multi-tier ----
    def search_tiers(self, topology: TierTopology, *, n_micro: int = 4,
                     **kw) -> list:
        """Multi-tier search over ``topology``: cut-list x stage->tier
        assignment, priced sequentially and pipelined — the planner-bound
        spelling of :func:`plan_tiers` (CS curve, compression and sample
        wired from this planner's configuration)."""
        return plan_tiers(self.model, self.params, topology,
                          n_micro=n_micro, cs_curve=self.cs_curve,
                          layer_idx=self.layer_idx, sample=self.sample, **kw)

    def default_space(self) -> SearchSpace:
        """Every legal cut the CS curve covers, stock protocol/batch/replica
        grids — what ``suggest`` uses when no space is given.  Legality
        comes from ``api.types.legal_split_candidates`` (which routes
        through ``core.split.validate_cut``, the single authority)."""
        covered = {c.split_layer for c in legal_split_candidates(
            self.model, self.cs_curve, self.layer_idx)}
        sps = tuple(sp for sp in self.layer_idx if sp in covered)
        return SearchSpace(split_points=sps,
                           include_lc=self.lc_model is not None)

    # ---------------------------------------------------------- screening ----
    def _screen_leg(self, device: DeviceClass, label: str,
                    split: Optional[int], proto: str) -> float:
        """Closed-form per-frame flow latency (edge + zero-loss wire +
        server compute) of one (candidate, protocol) leg — the cheap
        stand-in for :meth:`_flow` the two-phase search screens with
        (``netsim.analytic``); no event simulation, no forwards.  Like
        ``measure_flow``, compute times come from the configured cost
        model when it prices the cell (so a calibrated planner screens
        with measured numbers), falling back to the analytic model."""
        scen = self._scenario(device, label, split)
        times = (self.cost.flow_times(scen.kind, split, batch=1)
                 if self.cost is not None else None)
        if times is None:
            times = scenario_times_and_payload(scen, self.model, self.params,
                                               input_bytes=self.input_bytes,
                                               sample=self.sample)
        wire = 0.0
        if times["wire_bytes"] > 0:
            pp = analytic.path_params(
                NetworkPath((NetworkConfig(proto, device.channel),)))
            wire = float(analytic.transfer_duration_s(
                np.array([times["wire_bytes"]]), pp)[0])
        return times["edge_s"] + wire + times["server_s"]

    def _screened_legs(self, device: DeviceClass, cands, space: SearchSpace,
                       refine: int) -> set:
        """Phase-1 screen of one device's (candidate, protocol) legs:
        keep the (closed-form latency, -accuracy proxy) Pareto front plus
        the ``refine`` fastest; returns the surviving ``{(label,
        protocol)}`` set.  LC legs are not screened (no wire, one
        point)."""
        legs = []
        for cand in cands:
            label, split = cand
            if label == "LC":
                continue
            for proto in space.protocols:
                if proto not in device.protocols:
                    continue
                legs.append((self._screen_leg(device, label, split, proto),
                             -float(cand.accuracy_proxy), label, proto))
        legs.sort(key=lambda t: (t[0], t[1]))
        keep, best = set(), -np.inf
        for rank, (lat, nproxy, label, proto) in enumerate(legs):
            if rank < refine or -nproxy > best:
                keep.add((label, proto))
            best = max(best, -nproxy)
        return keep

    # ------------------------------------------------------------ search ----
    def search(self, trace: Trace, devices: Sequence[DeviceClass],
               space: SearchSpace, *, refine: Optional[int] = None,
               engine: str = "event") -> list:
        """Evaluate the space; returns one PlanPoint per evaluated combo.

        ``refine=None`` (default) evaluates every combination exactly,
        as always.  ``refine=k`` makes the search two-phase: every
        (candidate, protocol) leg is first scored with the closed-form
        analytic flow model (:meth:`_screen_leg` — no event engine, no
        forwards), and only the per-device (latency, -accuracy-proxy)
        Pareto front plus the ``k`` fastest legs are evaluated exactly
        (event-engine transfer draws, measured accuracy, and the cluster
        queueing simulation over the full batch x replicas grid).  The
        screen is loss-blind, so on lossy channels prefer a ``k`` wide
        enough to keep the retransmission-sensitive alternatives in.

        ``engine`` picks the cluster simulator pricing each grid point:
        ``"event"`` (default — the exact discrete-event authority),
        ``"vectorized"`` (the arrival-level NumPy engine in
        ``fleet.vectorized``; bit-identical latencies under the
        deterministic service model, orders of magnitude faster on
        megafleet traces), or ``"auto"`` (vectorized above
        ``AUTO_VECTORIZE_MIN`` requests per cluster).  Under a
        non-event engine the search follows the repo's screen/refine
        contract: the whole grid is priced vectorized, then every
        point on the per-device Pareto front is re-priced by the event
        engine (``PlanPoint.engine`` records which simulator produced
        each number).
        """
        obs = self.obs
        points, recipes = [], []
        for device in devices:
            sub = trace.for_device(device.name)
            if not len(sub):
                continue
            t_dev0, n_before = obs.tracer.wall_now(), len(points)
            cands = self.candidates(space)
            allowed = (self._screened_legs(device, cands, space, refine)
                       if refine is not None else None)
            if obs.enabled and allowed is not None:
                obs.metrics.counter("planner.screened_legs").inc(len(allowed))
            for label, split in cands:
                if label == "LC":
                    points.append(self._lc_point(device, sub))
                    recipes.append(None)
                    continue
                for proto in space.protocols:
                    if proto not in device.protocols:
                        continue
                    if allowed is not None and (label, proto) not in allowed:
                        continue
                    try:
                        flow = self._flow(device, label, split, proto)
                    except RetryBudgetExceeded:
                        # the link is too lossy to deliver this leg's
                        # payload reliably: an infeasible design point,
                        # not a planner crash — skip it and count it
                        self.n_infeasible_legs += 1
                        if obs.enabled:
                            obs.metrics.counter(
                                "planner.infeasible_legs").inc()
                        continue
                    for b, r in itertools.product(space.batch_sizes,
                                                  space.replica_counts):
                        args = (device, sub, label, split, proto, flow,
                                b, r, space.batch_window_s)
                        points.append(self._cluster_point(*args,
                                                          engine=engine))
                        recipes.append(args)
            if obs.enabled:
                n_dev = len(points) - n_before
                obs.tracer.add(f"planner.search:{device.name}", t_dev0,
                               obs.tracer.wall_now(), clock="wall",
                               tid="planner", cat="planner",
                               args={"n_points": n_dev,
                                     "n_requests": len(sub),
                                     "screened": allowed is not None})
                obs.metrics.counter("planner.evaluated_points").inc(n_dev)
        if engine != "event":
            self._refine_front(points, recipes)
        return points

    def _refine_front(self, points: list, recipes: list) -> None:
        """Screen/refine contract for the cluster engine: re-price every
        vectorized-screened point on the per-device Pareto front with the
        exact event engine, in place.  (The vectorized engine replays the
        event semantics exactly under the deterministic service model, so
        this normally changes nothing — it is the standing guarantee that
        no plan is ever *chosen* on a fast-path price alone.)"""
        index = {id(p): i for i, p in enumerate(points)}
        n_ref = 0
        for p in self.pareto_front(points):
            i = index[id(p)]
            if recipes[i] is None or points[i].engine == "event":
                continue
            points[i] = self._cluster_point(*recipes[i], engine="event")
            n_ref += 1
        if self.obs.enabled and n_ref:
            self.obs.metrics.counter("planner.refined_points").inc(n_ref)

    def _lc_point(self, device: DeviceClass, sub: Trace) -> PlanPoint:
        """All-edge: no queueing, no server FLOPs, LC-model accuracy."""
        flow = self._flow(device, "LC", None, device.protocols[0])
        lat = flow["edge_s"]
        return PlanPoint(device.name, "LC", None, None, 0, 0,
                         lat, lat, flow["accuracy"], 0.0, 0.0)

    def _cluster_point(self, device: DeviceClass, sub: Trace, label: str,
                       split: Optional[int], proto: str, flow: dict,
                       max_batch: int, n_replicas: int, window_s: float,
                       engine: str = "event") -> PlanPoint:
        cost = self._cost_model(split)
        cfg = ClusterConfig(n_replicas, max_batch, window_s)
        engine = _resolve_engine(engine, len(sub))
        horizon = max(sub.horizon_s, 1e-9)
        if engine == "vectorized":
            # request i reaches the cluster after its edge compute + its
            # own transfer draw (frames cycled, matching the event path)
            t_arr = sub.arrival_times()
            wire = np.asarray(flow["wire_s"], float)
            pre = flow["edge_s"] + wire[np.arange(len(t_arr)) % len(wire)]
            vstats = simulate_cluster_vectorized(t_arr + pre, cost, cfg)
            keep = ~vstats.drop_mask
            lat = pre[keep] + (vstats.t_done[keep] - vstats.t_offer[keep])
            n_served, drop = vstats.n_served, vstats.drop_fraction()
        else:
            sim = ClusterSim(cost, cfg)
            wire = flow["wire_s"]
            t_server = {}
            for i, req in enumerate(sub.requests):
                pre = flow["edge_s"] + wire[i % len(wire)]
                t_server[req.rid] = pre
                sim.offer(req.rid, req.t_arrival + pre)
            stats = sim.run()
            lat = np.array([t_server[rec.rid] + rec.latency_s
                            for rec in stats.served])
            n_served, drop = len(stats.served), stats.drop_fraction()
        flops_rate = cost.flops_per_item * n_served / horizon
        return PlanPoint(
            device.name, label, split, proto, max_batch, n_replicas,
            float(np.percentile(lat, 50)) if len(lat) else float("inf"),
            float(np.percentile(lat, 99)) if len(lat) else float("inf"),
            flow["accuracy"], flops_rate, drop,
            batch_window_s=window_s, engine=engine)

    # ------------------------------------------------------------ output ----
    @staticmethod
    def pareto_front(points: Sequence[PlanPoint]) -> list:
        """Non-dominated set over (p99 latency, accuracy, server FLOPs/s),
        per device class.  Ties on the whole objective vector keep only the
        cheapest deployment (fewest replicas, then smallest batch)."""
        front = []
        for dev in sorted({p.device for p in points}):
            best = {}
            for p in points:
                if p.device != dev:
                    continue
                obj = p.objectives()
                cur = best.get(obj)
                if cur is None or (p.n_replicas, p.max_batch) < (cur.n_replicas,
                                                                 cur.max_batch):
                    best[obj] = p
            mine = [(p, obj) for obj, p in best.items()]
            front.extend(p for p, _ in pareto_nd(mine))
        return sorted(front, key=lambda p: (p.device, p.p99_s))

    def suggest(self, qos: QoSRequirements, fleet,
                space: Optional[SearchSpace] = None,
                points: Optional[Sequence[PlanPoint]] = None) -> dict:
        """Pick one deployment plan per device class.

        ``fleet`` is ``(trace, device_classes)``.  Returns
        ``{device_name: PlanPoint | None}`` — only QoS-feasible plans are
        ever returned; ``None`` marks a class no searched plan can serve
        (caller should relax QoS, add replicas, or change the network).
        Pass ``points`` from an earlier :meth:`search` to skip
        re-evaluating the space.
        """
        trace, devices = fleet
        if points is None:
            points = self.search(trace, devices,
                                 space if space is not None
                                 else self.default_space())
        plans = {}
        for d in devices:
            ok = [p for p in points if p.device == d.name and p.satisfies(qos)]
            # max accuracy, then min p99, then cheapest server
            plans[d.name] = (max(ok, key=lambda p: (p.accuracy, -p.p99_s,
                                                    -p.server_flops_per_s))
                             if ok else None)
        return plans


def simulate_deployment(plans: dict, trace: Trace,
                        devices: Sequence[DeviceClass],
                        planner: DeploymentPlanner, *, obs=None,
                        engine: str = "event",
                        check_event_engine: bool = False) -> dict:
    """Joint validation: run the chosen per-class plans against the *mixed*
    trace, sharing one cluster per (split, batch, replicas) group so device
    classes genuinely contend for the same replicas.  Each group runs under
    the batching window its plans were searched with.  Returns fleet-level
    p50/p99 per group (each row records the ``engine`` that produced it).

    ``engine``: ``"event"`` (default), ``"vectorized"``, or ``"auto"``
    (vectorized above ``AUTO_VECTORIZE_MIN`` requests per group) — the
    same knob as :meth:`DeploymentPlanner.search`.  With
    ``check_event_engine=True`` a vectorized group is additionally
    replayed by the event engine and asserted to agree (exact drop
    counts, percentiles within ``fleet.vectorized.PCTL_RTOL``).

    ``obs``: the shared clusters run fully traced — per-request lifecycle
    spans (wire -> queue wait -> service), per-replica batch tracks, and
    the windowed fleet time series (the vectorized engine feeds the same
    ``fleet.*`` series from its arrival arrays).  This is *the* fleet
    simulation ``Study.observe()`` exports: the deployment you actually
    chose, under the mixed trace."""
    obs = NULL if obs is None else obs
    by_dev = {d.name: d for d in devices}
    groups = {}
    for name, plan in plans.items():
        if plan is None or plan.label == "LC":
            continue
        groups.setdefault((plan.split_layer, plan.max_batch,
                           plan.n_replicas, plan.batch_window_s),
                          []).append(plan)
    out = {}
    for (split, b, r, window_s), members in groups.items():
        cost = planner._cost_model(split)
        cfg = ClusterConfig(r, b, window_s)
        n_group = sum(len(trace.for_device(p.device)) for p in members)
        eng = _resolve_engine(engine, n_group)
        if eng == "vectorized":
            t_parts, pre_parts, txs_parts, txb_parts = [], [], [], []
            for plan in members:
                device = by_dev[plan.device]
                flow = planner._flow(device, plan.label, plan.split_layer,
                                     plan.protocol)
                sub = trace.for_device(plan.device)
                t_arr = sub.arrival_times()
                wire = np.asarray(flow["wire_s"], float)
                wire = wire[np.arange(len(t_arr)) % len(wire)]
                t_parts.append(t_arr)
                pre_parts.append(flow["edge_s"] + wire)
                txs_parts.append(wire)
                txb_parts.append(np.full(len(t_arr),
                                         int(flow.get("wire_bytes", 0))))
            t_all = np.concatenate(t_parts)
            pre = np.concatenate(pre_parts)
            vstats = simulate_cluster_vectorized(
                t_all + pre, cost, cfg, tx_s=np.concatenate(txs_parts),
                tx_bytes=np.concatenate(txb_parts), obs=obs,
                check_event_engine=check_event_engine)
            keep = ~vstats.drop_mask
            lat = pre[keep] + (vstats.t_done[keep] - vstats.t_offer[keep])
            n_served, drop = vstats.n_served, vstats.drop_fraction()
            mean_batch = vstats.mean_batch()
            util = vstats.utilization(r, trace.horizon_s)
        else:
            sim = ClusterSim(cost, cfg, obs=obs)
            pre = {}
            for plan in members:
                device = by_dev[plan.device]
                flow = planner._flow(device, plan.label, plan.split_layer,
                                     plan.protocol)
                sub = trace.for_device(plan.device)
                wire_bytes = int(flow.get("wire_bytes", 0))
                for i, req in enumerate(sub.requests):
                    wire = flow["wire_s"][i % len(flow["wire_s"])]
                    head = flow["edge_s"] + wire
                    pre[req.rid] = head
                    sim.offer(req.rid, req.t_arrival + head,
                              tx_s=wire, tx_bytes=wire_bytes)
            stats = sim.run()
            lat = np.array([pre[rec.rid] + rec.latency_s
                            for rec in stats.served])
            n_served, drop = len(stats.served), stats.drop_fraction()
            mean_batch = stats.mean_batch()
            util = stats.utilization(r, trace.horizon_s)
        out[(split, b, r, window_s)] = {
            "devices": sorted(p.device for p in members),
            "n_served": n_served,
            "drop_fraction": drop,
            "p50_s": float(np.percentile(lat, 50)) if len(lat) else float("inf"),
            "p99_s": float(np.percentile(lat, 99)) if len(lat) else float("inf"),
            "mean_batch": mean_batch,
            "utilization": util,
            "engine": eng,
        }
    return out
