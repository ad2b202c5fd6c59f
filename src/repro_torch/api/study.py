"""The ``Study`` facade: the whole Split-Et-Impera pipeline behind one
typed, chainable object (twin of ``repro/api/study.py``).

Running the paper's workflow by hand means stitching five subsystems —
``core.saliency`` -> ``core.qos.rank_candidates`` ->
``netsim.measure_flow`` -> ``fleet.DeploymentPlanner`` ->
``runtime.SplitRuntime`` — and converting between their design-point
representations at every seam.  A ``Study`` carries one
:class:`~repro_torch.api.types.SplitCandidate` per design point
end-to-end:

    study = Study("vgg16", data=(xs, ys), device="cuda")
    best = (study.profile()            # CS curve (Grad-CAM saliency)
                 .candidates()         # legal cuts + LC/RC, CS-ranked
                 .calibrate()          # optional: measured cost tables
                 .simulate()           # single link (or fleet=(trace, mix),
                                       #  or path=[hop, hop] for K-cut lists)
                 .suggest(qos))        # Pareto + best QoS match
    runtime = study.deploy()           # ready SplitRuntime for the cut(s)

Multi-tier chains ride the same verbs: ``simulate(path=...)`` prices
K-cut candidates over a multi-hop ``NetworkPath`` (sequentially and
pipelined), ``suggest(qos, tiers=TierTopology(...))`` searches cut-list
x stage->tier assignment, and ``deploy()`` then executes the winning cut
list as a K+1-stage runtime.

Stages are lazily cached: each runs at most once unless called again
explicitly, and any stage you skip is run on demand with defaults (so
``Study(m, device=d).suggest(qos)`` is legal).  Re-running a stage
invalidates the stages after it.

Cost selection is uniform: after :meth:`calibrate`, *both* the
single-link simulator and the fleet planner price flows from the
measured :class:`~repro_torch.runtime.calibrate.CalibrationTable`,
falling back to the analytic FLOPs model for cells the grid didn't cover
— ``simulate`` never needs to know which source answered.

Telemetry rides the same chain: ``study.observe()`` arms a
``repro_torch.obs.Recorder`` and returns a live
:class:`~repro_torch.obs.report.TelemetryReport`; every stage that runs
*afterwards* records into it, and ``report.to_chrome_trace("trace.json")``
exports the lot for Perfetto.  Without ``observe()`` every subsystem sees
the null recorder and pays nothing.

``Study`` accepts a :class:`~repro_torch.models.layered.LayeredModel`, a
transformer ``ModelConfig`` (viewed through ``transformer_as_layered``),
or a config name: ``"vgg16"`` builds the small trainable VGG variant, any
``repro_torch.configs`` arch name (``"llama3.2-3b"``, ``"rwkv6-1.6b"``,
...) resolves through the registry and is reduced to its small variant
unless ``reduce=False``; every name of the registry is served.  As the
reference's, a whisper view skips the encoder and every
cross-attention (its blocks get no encoder output), and a VLM view's
embed layer puts the projected patches before the tokens.

Everything the study makes lives on ``device`` (default ``"cuda"``; on a
host without CUDA it raises unless the caller asks for ``"cpu"``).  On the
card no verb falls back to the CPU or to a kernel's plain version: the
codec kernels run wherever an AE cut is calibrated or deployed, and a zoo
study's :meth:`profile` differentiates through the view, so its backward
runs through the backward kernels of ``flash_attention``, ``rwkv6_scan``
and, for a hybrid (jamba) view's Mamba layers, ``mamba_scan``: every
family profiles on the card.  The kernels take head
dims 64 and 128 (rwkv: 64), and ``reduced()`` configs have 32, so a zoo
study on the card is built with ``reduce=False``: the config as given
(whole, or a depth cut of it made with ``dataclasses.replace``).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, replace
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.api.types import (SplitCandidate, legal_cut_list_candidates,
                                   legal_split_candidates)
from repro_torch.core import bottleneck as B
from repro_torch.core import qos as Q
from repro_torch.core.saliency import candidate_split_points, cumulative_saliency
from repro_torch.core.scenarios import PLATFORMS, PlatformProfile
from repro_torch.device import resolve_device
from repro_torch.models.layered import LayeredModel
from repro_torch.netsim.channel import Channel
from repro_torch.netsim.simulator import (ApplicationSimulator, NetworkConfig,
                                          as_path, flow_latency_s, measure_flow)
from repro_torch.tree import tree_leaves, tree_map

_VGG_NAMES = ("vgg16", "vgg16-cifar10", "vgg")


def _platform(p) -> PlatformProfile:
    if isinstance(p, str):
        if p not in PLATFORMS:
            raise KeyError(f"unknown platform {p!r}; known: {sorted(PLATFORMS)}")
        return PLATFORMS[p]
    return p


def fit_loss(model, params, x, y) -> torch.Tensor:
    """The paper's training loss (§V): the mean cross-entropy
    ``logsumexp - gold`` of ``model``'s logits over the batch."""
    logits = model.apply(params, x)
    gold = logits.gather(1, y.long()[:, None])[:, 0]
    return torch.mean(torch.logsumexp(logits, -1) - gold)


def fit_step(model, params, opt, x, y, lr) -> tuple:
    """One step of :meth:`Study.fit`: :func:`fit_loss`, its gradient, one
    Adam update.  Returns ``(params, opt, loss)``; the inputs are not
    written."""
    from repro_torch.training.optimizer import adam_update
    loss, g = B.value_and_grad(lambda p: fit_loss(model, p, x, y), params)
    params, opt = adam_update(params, g, opt, lr)
    return params, opt, loss


@dataclass(frozen=True)
class StudyScenario:
    """Where a Study's design points run: edge/server platforms and the
    link between them.  Platforms may be given as ``core.scenarios``
    profile names."""
    edge: PlatformProfile = PLATFORMS["edge-embedded"]
    server: PlatformProfile = PLATFORMS["server-gpu"]
    channel: Channel = None
    protocol: str = "tcp"
    n_frames: int = 8

    def __post_init__(self):
        object.__setattr__(self, "edge", _platform(self.edge))
        object.__setattr__(self, "server", _platform(self.server))
        if self.channel is None:
            # clean gigabit link, deterministic under the default seed
            object.__setattr__(self, "channel", Channel(1e-4, 1e9, 1e9, seed=0))

    def netcfg(self) -> NetworkConfig:
        return NetworkConfig(self.protocol, self.channel)


class Study:
    """One end-to-end split-computing design study.  See module docstring.

    ``params=`` (and ``lc=``'s) must lie on ``device``; for a transformer
    config they are the backbone's, the view's own entries being empty.
    Without ``params=`` the weights are drawn from a ``torch.Generator``
    seeded with ``seed``.  ``data=(xs, ys)``: numpy images and labels; at
    most 32 are used."""

    def __init__(self, model="vgg16", scenario: Optional[StudyScenario] = None,
                 *, params=None, data=None, lc=None, seed=0, reduce=None,
                 batch: Optional[int] = None, seq_len: int = 32,
                 compression: float = 0.5, device="cuda"):
        self.device = resolve_device(device)
        self.scenario = scenario if scenario is not None else StudyScenario()
        if not isinstance(self.scenario, StudyScenario):
            raise TypeError("scenario must be a StudyScenario (use "
                            "StudyScenario(edge=..., channel=...))")
        self.seed = seed
        self.compression = compression
        self.lc_model, self.lc_params = lc if lc is not None else (None, None)
        self._data = data
        self._recorder = None            # armed by observe()
        self._resolve_model(model, params, reduce, batch, seq_len)
        # stage caches
        self._cs = None
        self._layer_idx = None
        self._candidates = None
        self._ae_map = {}
        self._calibration = None
        self._mode = None                # 'link' | 'fleet' after simulate()
        self._verdicts = None
        self._planner = None
        self._fleet = None
        self._fleet_engine = "event"     # cluster engine of the last fleet sim
        self._points = None
        self._suggested = None
        self._plans = None
        self._deployment_stats = None    # traced joint validation (observe)
        self._path = None                # NetworkPath of the last path sim
        self._tier_topology = None
        self._tier_plans = None
        self._tier_best = None

    # ------------------------------------------------------- resolution ----
    def _resolve_model(self, model, params, reduce, batch, seq_len):
        self.cfg = None
        if isinstance(model, str):
            if model.lower() in _VGG_NAMES:
                from repro_torch.models.vgg import vgg_cifar
                hw = (self._data[0].shape[1] if self._data is not None else 16)
                model = vgg_cifar(n_classes=8, input_hw=hw, width_mult=0.25)
            else:
                from repro_torch.configs import get_config
                model = get_config(model)
        if not isinstance(model, LayeredModel):     # a transformer ModelConfig
            from repro_torch.models import transformer as T
            from repro_torch.models.common import reduced
            from repro_torch.models.layered import transformer_as_layered
            if reduce or reduce is None:
                model = reduced(model, dtype="float32")
            self.cfg = model
            backbone = (params if params is not None
                        else T.init_params(self.seed, model, device=self.device))
            model = transformer_as_layered(model, backbone)
            params = model.init(self.seed, device=self.device)
        self.model = model
        self.params = (params if params is not None
                       else model.init(self.seed, device=self.device))
        self._build_sample(batch, seq_len)

    def _build_sample(self, batch, seq_len):
        """The example input the study profiles, costs and calibrates with
        (``x``/``labels`` on the device), plus the per-frame input payload
        in bytes.  Drawn from ``numpy.random.default_rng(seed)`` in the
        reference's order; tokens are int32, as the reference's, so the
        payload every latency prices is the same."""
        rng = np.random.default_rng(self.seed)
        dev = self.device
        self._xs_np = self._ys_np = None             # host copies of data=
        if self.cfg is not None:                     # transformer batch dict
            cfg, b = self.cfg, batch or 2
            st = seq_len - (cfg.n_patches if cfg.family == "vlm" else 0)
            x = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab, (b, st)),
                                           dtype=torch.int32, device=dev)}
            if cfg.family == "vlm":
                x["patch_embeds"] = torch.as_tensor(
                    rng.normal(size=(b, cfg.n_patches, cfg.d_frontend)),
                    dtype=torch.float32, device=dev)
            if cfg.family == "encdec":
                x["frames"] = torch.as_tensor(
                    rng.normal(size=(b, cfg.n_frames, cfg.d_frontend)),
                    dtype=torch.float32, device=dev)
            self._x, self._labels = x, torch.as_tensor(
                rng.integers(0, cfg.vocab, (b, st)), dtype=torch.int32, device=dev)
            self._sample = x
            self.input_bytes = sum(t.numel() * t.element_size()
                                   for t in tree_leaves(x)) // b
        elif self._data is not None:                 # measured image data
            xs, ys = self._data
            n = min(len(xs), 32)
            self._xs_np, self._ys_np = np.asarray(xs[:n]), np.asarray(ys[:n])
            self._x = torch.as_tensor(self._xs_np, device=dev)
            self._labels = torch.as_tensor(self._ys_np, device=dev)
            self._sample = None                      # input_shape suffices
            self.input_bytes = int(np.prod(xs.shape[1:])) * 4
        else:                                        # synthetic image input
            b = batch or 8
            shape = (b,) + tuple(self.model.input_shape)
            self._x = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32,
                                      device=dev)
            self._labels = torch.as_tensor(
                rng.integers(0, self.model.n_classes, b), dtype=torch.int32, device=dev)
            self._sample = None
            self.input_bytes = int(np.prod(shape[1:])) * 4

    # --------------------------------------------------------- telemetry ----
    def observe(self, *, window_s: float = 0.05):
        """Arm telemetry and return a live
        :class:`~repro_torch.obs.report.TelemetryReport`.

        The first call creates the study's ``repro_torch.obs.Recorder``
        (``window_s`` sets the fleet metrics sampling window, simulated
        seconds); every stage that runs afterwards records into it —
        call ``observe()`` *before* the stages you want traced.
        Subsequent calls return the same live report.  Export with
        ``report.to_chrome_trace(path)`` and open in Perfetto.
        """
        if self._recorder is None:
            from repro_torch.obs import Recorder
            self._recorder = Recorder(window_s=window_s)
        return self._recorder.report()

    @property
    def _obs(self):
        """The armed recorder, or the shared null recorder (free)."""
        if self._recorder is not None:
            return self._recorder
        from repro_torch.obs import NULL
        return NULL

    # ---------------------------------------------------------- training ----
    def fit(self, *, steps: int = 300, lr: float = 5e-3, batch: int = 32,
            data_iter=None) -> "Study":
        """Train the backbone on the toy conveyor-belt task (paper §V
        recipe: Adam, lr 5e-3; :func:`fit_step` a batch) — image
        ``LayeredModel``\\ s only.  ``data_iter`` overrides the synthetic
        stream with real ``(x, y)`` batches (numpy or tensors)."""
        if self.cfg is not None:
            raise NotImplementedError(
                "Study.fit trains image LayeredModels; train transformer "
                "backbones elsewhere and pass params=")
        from repro_torch.training.optimizer import adam_init
        if data_iter is None:
            from repro_torch.data.synthetic import toy_image_iter
            data_iter = toy_image_iter(batch, hw=self.model.input_shape[0],
                                       seed=self.seed,
                                       n_classes=self.model.n_classes)
        params, opt = self.params, adam_init(self.params)
        for _ in range(steps):
            x, y = next(data_iter)
            params, opt, _ = fit_step(
                self.model, params, opt,
                torch.as_tensor(x, dtype=torch.float32, device=self.device),
                torch.as_tensor(y, device=self.device), lr)
        self.params = params
        # trained weights invalidate every derived stage
        self._cs = self._candidates = self._calibration = None
        self._ae_map, self._mode = {}, None
        return self

    def eval_accuracy(self, data=None, n: int = 256) -> float:
        """Top-1 accuracy of the current backbone on ``data`` (default: a
        held-out draw of the toy task for image models, the study's own
        sample batch otherwise)."""
        if data is None:
            if self.cfg is None and len(self.model.input_shape) == 3:
                from repro_torch.data.synthetic import toy_images
                data = toy_images(n, hw=self.model.input_shape[0], seed=777,
                                  n_classes=self.model.n_classes)
            else:
                data = (self._x, self._labels)
        xs, ys = data
        with torch.inference_mode():
            logits = self.model.apply(self.params, tree_map(
                lambda a: torch.as_tensor(a, device=self.device), xs))
            hits = logits.argmax(-1) == torch.as_tensor(ys, device=self.device)
            return float(hits.float().mean())

    # ------------------------------------------------------------ stages ----
    def profile(self, *, layer_idx: Optional[Sequence[int]] = None) -> "Study":
        """Stage 1: the cumulative-saliency (CS) curve over ``layer_idx``
        (default: conv/pool feature ops for CNNs, blocks for transformer
        views) — the paper's accuracy proxy for split-point ranking."""
        if layer_idx is None:
            if any(l.kind == "conv" for l in self.model.layers):
                from repro_torch.models.vgg import feature_index
                layer_idx = feature_index(self.model)
            else:
                layer_idx = list(range(1, len(self.model.layers) - 1))
        self._layer_idx = list(layer_idx)
        self._cs = cumulative_saliency(self.model, self.params, self._x,
                                       self._labels, layer_idx=self._layer_idx)
        self._candidates = None                      # invalidate downstream
        self._mode = None
        return self

    @property
    def cs_curve(self) -> np.ndarray:
        if self._cs is None:
            self.profile()
        return self._cs

    @property
    def layer_idx(self) -> list:
        if self._layer_idx is None:
            self.profile()
        return self._layer_idx

    def candidates(self, *, top_n: int = 3,
                   include_lc_rc: bool = True) -> "Study":
        """Stage 2: CS-ranked design points.  SC cuts are the CS local
        maxima restricted to legal cuts (``core.split.validate_cut`` is
        the legality authority); when the curve has no interior maxima
        (short models), the highest-CS legal cuts stand in.  LC and RC
        bracket the list per the paper."""
        cs, li = self.cs_curve, self.layer_idx
        points = candidate_split_points(self.model, cs, li, top_n=top_n)
        if not points:
            ranked = sorted(legal_split_candidates(self.model, cs, li),
                            key=lambda c: -c.accuracy_proxy)
            points = [c.split_layer for c in ranked[:top_n]]
        cands = Q.rank_candidates(cs, li, points, include_lc_rc=include_lc_rc)
        self._candidates = [replace(c, compression=self.compression)
                            if c.kind == "SC" else c for c in cands]
        self._mode = None
        return self

    @property
    def candidate_list(self) -> list:
        if self._candidates is None:
            self.candidates()
        return self._candidates

    def split_candidates(self) -> list:
        """The SC subset of :attr:`candidate_list` (helper for stages that
        only operate on actual cuts)."""
        return [c for c in self.candidate_list if c.kind == "SC"]

    def bottlenecks(self, *, steps: int = 100, rate: Optional[float] = None,
                    cuts: Optional[Sequence[int]] = None, lr: float = 5e-4,
                    data_iter=None) -> "Study":
        """Optional stage: train a bottleneck AE per SC cut (paper Eq. 3,
        backbone frozen).  Without ``data_iter`` the study's own sample
        batch is cycled — enough for the demo pipelines; pass a real
        iterator for production AEs.  The AE is drawn from a
        ``torch.Generator`` seeded with the study's seed."""
        rate = self.compression if rate is None else rate
        cuts = [c.split_layer for c in self.split_candidates()] \
            if cuts is None else list(cuts)
        if data_iter is None:
            data_iter = itertools.repeat((self._x, self._labels))
        for cut in cuts:
            self._ae_map[cut], _ = B.train_bottleneck(
                self.model, self.params, cut, data_iter, steps=steps,
                lr=lr, rate=rate, seed=self.seed, device=self.device)
        self._mode = None
        return self

    def calibrate(self, *, splits: Optional[Sequence[int]] = None,
                  iters: int = 3, quantize: bool = True,
                  fused: bool = False) -> "Study":
        """Optional stage: execute the real head/tail stages and wire codec
        on the study's device and keep the measured
        :class:`~repro_torch.runtime.calibrate.CalibrationTable`.  Every
        later ``simulate`` (single-link *and* fleet) prices flows from it,
        falling back to the analytic model for uncovered cells.  At a cut
        with an AE the codec kernels run.  ``fused=True`` measures the
        fused-boundary runtime and quotes those costs to the planners."""
        from repro_torch.runtime.calibrate import calibrate as _calibrate
        splits = [c.split_layer for c in self.split_candidates()] \
            if splits is None else list(splits)
        with self._obs.tracer.span("study.calibrate", tid="study",
                                   cat="study") as sp:
            sp.args.update(n_splits=len(splits), iters=iters, fused=fused)
            self._calibration = _calibrate(self.model, self.params, splits,
                                           ae_map=self._ae_map, x=self._x,
                                           iters=iters, quantize=quantize,
                                           fused=fused, device=self.device)
        self._mode = None
        return self

    @property
    def calibration(self):
        return self._calibration

    # ---------------------------------------------------------- simulate ----
    def _netcfg(self, network) -> NetworkConfig:
        if network is None:
            return self.scenario.netcfg()
        if isinstance(network, NetworkConfig):
            return network
        if isinstance(network, Channel):
            return NetworkConfig(self.scenario.protocol, network)
        raise TypeError("network must be a NetworkConfig or Channel")

    @property
    def _measured(self) -> bool:
        """Image data given: accuracies are measured on it."""
        return self._data is not None and self.cfg is None

    def simulate(self, network=None, fleet=None, path=None, *,
                 n_frames: Optional[int] = None, tiers=None,
                 n_micro: int = 4, top_m: int = 8,
                 batch: Optional[int] = None, refine: Optional[int] = None,
                 engine: str = "event",
                 space=None, **space_overrides) -> "Study":
        """Stage 3: communication-aware simulation of every candidate.

        ``network``: a single link (``NetworkConfig`` or ``Channel``;
        default: the study scenario's link) — produces one
        ``SimVerdict`` per candidate.  ``fleet``: ``(trace,
        device_classes)`` — runs the QoS deployment planner over
        split x protocol x batch x replicas instead.  ``path``: a
        multi-hop chain (``netsim.NetworkPath`` or a sequence of
        ``Channel``/``NetworkConfig`` hops) — simulates K-cut candidates
        (K = number of hops), each priced sequentially *and* as an
        ``n_micro``-way pipelined microbatch schedule; the verdict
        latency is the pipelined one.  ``tiers`` names the K+1 platform
        chain for the path mode (default: the scenario's edge, then its
        server for every later stage); ``top_m`` bounds the CS-ranked
        cut lists simulated.  Cost source (analytic vs calibrated) is
        selected uniformly for single-link and fleet modes by the
        preceding :meth:`calibrate` call, per cell; path mode prices
        analytically.

        **Latency unit**: single-link verdicts are per *frame*
        (``batch=1``); path-mode verdicts are the makespan of one
        ``batch``-frame sample (default: the study sample's own batch) —
        pass ``batch=1`` to compare against single-link numbers under one
        QoS budget.

        ``refine`` (fleet mode): screen every (candidate, protocol) leg
        with the closed-form analytic engine and evaluate only the
        per-device Pareto front + ``refine`` fastest legs exactly;
        ``None`` (default) evaluates everything exactly.  ``engine``
        (fleet mode): ``"event"`` (default, exact), ``"vectorized"`` or
        ``"auto"``; the observed deployment run inherits it.

        With image data the single-link accuracies are measured by
        ``ApplicationSimulator`` on the study's device, over the images
        as given (numpy, no copy back from the device).
        """
        n_frames = self.scenario.n_frames if n_frames is None else n_frames
        if fleet is not None:
            return self._simulate_fleet(fleet, n_frames, space,
                                        space_overrides, refine, engine)
        if path is not None:
            return self._simulate_path(path, tiers, n_frames, n_micro,
                                       top_m, batch)
        netcfg = self._netcfg(network)
        verdicts = []
        tracer = self._obs.tracer
        for cand in self.candidate_list:
            scen = cand.scenario(self.scenario.edge, self.scenario.server)
            with tracer.span(f"study.simulate:{cand.label}", tid="study",
                             cat="study") as sp:
                flow = measure_flow(scen, netcfg, self.model, self.params,
                                    self.input_bytes, n_frames=n_frames,
                                    cost=self._calibration,
                                    sample=self._sample)
                sp.args.update(wire_bytes=flow["wire_bytes"],
                               cost_source=flow["cost_source"])
            if self._measured:
                sim = ApplicationSimulator(
                    self.model, self.params, netcfg,
                    ae=self._ae_map.get(cand.split_layer),
                    lc_model=self.lc_model, lc_params=self.lc_params,
                    device=self.device)
                v = sim.simulate(scen, self._xs_np, self._ys_np,
                                 n_frames=n_frames, flow=flow)
                meta = dict(v.meta, cost_source=flow["cost_source"])
                verdicts.append(Q.SimVerdict(cand, v.latency_s, v.accuracy,
                                             meta))
            else:
                verdicts.append(Q.SimVerdict(
                    cand, flow_latency_s(flow), cand.accuracy_proxy,
                    meta={"wire_bytes": flow["wire_bytes"],
                          "cost_source": flow["cost_source"],
                          "edge_s": flow["edge_s"],
                          "server_s": flow["server_s"]}))
        self._verdicts, self._mode = verdicts, "link"
        self._path = None            # a non-path sim owns later deploys
        self._suggested = self._plans = self._tier_best = None
        return self

    def _frame_batch(self) -> int:
        """The study sample's own frame batch — what the multi-tier
        modes price one 'sample' as."""
        return int(tree_leaves(self._sample if self._sample is not None
                               else self._x)[0].shape[0])

    def _simulate_path(self, path, tiers, n_frames, n_micro,
                       top_m, batch=None) -> "Study":
        """Multi-hop link mode: one verdict per K-cut candidate."""
        batch = self._frame_batch() if batch is None else batch
        path = as_path(path, self.scenario.protocol)
        if tiers is not None:
            tiers = tuple(_platform(t) for t in tiers)
        cands = legal_cut_list_candidates(
            self.model, len(path), self.cs_curve, self.layer_idx,
            top_m=top_m)
        if not cands:
            raise ValueError(
                f"{self.model.name!r} has no legal {len(path)}-cut lists "
                f"covered by the CS curve (fewer cuts than hops?)")
        verdicts = []
        for cand in cands:
            cand = replace(cand, compression=self.compression)
            scen = cand.scenario(self.scenario.edge, self.scenario.server)
            flow = measure_flow(scen, path, self.model, self.params,
                                self.input_bytes, n_frames=n_frames,
                                sample=self._sample, tiers=tiers,
                                batch=batch, n_micro=n_micro)
            pipe = flow["pipeline"]
            verdicts.append(Q.SimVerdict(
                cand, pipe.latency_s, cand.accuracy_proxy,
                meta={"sequential_s": flow_latency_s(flow),
                      "speedup": pipe.speedup, "n_micro": n_micro,
                      "batch": batch,
                      "stage_s": flow["stage_s"],
                      "hop_bytes": flow["hop_bytes"],
                      "wire_bytes": flow["wire_bytes"],
                      "cost_source": flow["cost_source"]}))
        self._verdicts, self._mode = verdicts, "link"
        self._path = path
        self._suggested = self._plans = self._tier_best = None
        return self

    def _proxy_accuracy_fn(self):
        proxies = {(c.kind, c.split_layer): c.accuracy_proxy
                   for c in self.candidate_list}

        def accuracy_fn(scenario, netcfg):
            split = getattr(scenario.split_plan, "split_layer", None)
            acc = proxies.get((scenario.kind, split), 0.0)
            if netcfg.protocol == "udp":             # lossy link degrades
                acc -= netcfg.channel.loss_rate
            return acc
        return accuracy_fn

    def _make_planner(self, n_frames):
        from repro_torch.fleet.planner import DeploymentPlanner
        measured = self._measured
        return DeploymentPlanner(
            self.model, self.params, cs_curve=self.cs_curve,
            layer_idx=self.layer_idx, ae_map=self._ae_map,
            eval_data=(self._xs_np, self._ys_np) if measured else None,
            accuracy_fn=None if measured else self._proxy_accuracy_fn(),
            lc_model=self.lc_model, lc_params=self.lc_params,
            server_platform=self.scenario.server,
            input_bytes=self.input_bytes, n_frames=n_frames,
            cost=self._calibration, sample=self._sample,
            obs=self._obs, device=self.device)

    def _make_space(self, space, overrides):
        from repro_torch.fleet.planner import SearchSpace
        if space is not None:
            return space
        sps = tuple(c.split_layer for c in self.split_candidates())
        kw = dict(split_points=sps, include_lc=self.lc_model is not None)
        kw.update(overrides)
        return SearchSpace(**kw)

    def _simulate_fleet(self, fleet, n_frames, space, overrides,
                        refine=None, engine="event") -> "Study":
        trace, devices = fleet
        self._planner = self._make_planner(n_frames)
        space = self._make_space(space, overrides)
        self._fleet, self._space = (trace, devices), space
        self._fleet_engine = engine
        self._points = self._planner.search(trace, devices, space,
                                            refine=refine, engine=engine)
        self._mode = "fleet"
        self._path = None
        self._suggested = self._plans = self._tier_best = None
        return self

    def adapt(self, scenario, *, qos=None, space=None, config=None,
              initial: Optional[str] = None, engine: str = "vectorized",
              n_frames: int = 8, **space_overrides) -> dict:
        """Run the online adaptive replanner over a regime-change
        scenario and race it against the strongest static plan.

        ``scenario`` is a
        :class:`repro_torch.fleet.scenario.RegimeChangeTrace` (phases +
        faults); the controller's candidate grid comes from the same
        planner configuration ``simulate(fleet=...)`` would build.
        Returns ``{"adaptive": AdaptiveRunResult, "static":
        AdaptiveRunResult, "controller": AdaptiveController}`` —
        ``static`` is the *best* fixed plan in the grid run over the same
        scenario, the fair baseline for the adaptive p99.
        """
        from repro_torch.fleet.controller import AdaptiveController
        self._planner = self._make_planner(n_frames)
        space = self._make_space(space, space_overrides)
        controller = AdaptiveController.from_planner(
            self._planner, space, qos=qos, config=config)
        with self._obs.tracer.span("study.adapt", tid="study",
                                   cat="study") as sp:
            adaptive = controller.run(scenario, initial=initial,
                                      engine=engine)
            static = controller.best_static(scenario, engine=engine)
            sp.args.update(
                n_candidates=len(controller.candidates), engine=engine,
                n_switches=adaptive.n_switches,
                adaptive_p99_ms=round(adaptive.p99_s * 1e3, 3),
                static_p99_ms=round(static.p99_s * 1e3, 3))
        return {"adaptive": adaptive, "static": static,
                "controller": controller}

    @property
    def verdicts(self) -> list:
        if self._mode == "fleet":
            # don't silently throw away an expensive fleet search —
            # single-link verdicts would reset the fleet plans
            raise RuntimeError(
                "study is in fleet mode (plan_points / suggest(qos) hold "
                "the results); call simulate() explicitly for single-link "
                "verdicts")
        if self._mode != "link":
            self.simulate()
        return self._verdicts

    @property
    def plan_points(self) -> list:
        if self._mode != "fleet":
            raise RuntimeError("plan_points needs simulate(fleet=...) first")
        return self._points

    @property
    def planner(self):
        """The underlying ``DeploymentPlanner`` of the last fleet
        simulation (for joint validation via
        ``fleet.planner.simulate_deployment``)."""
        if self._planner is None:
            raise RuntimeError("planner needs simulate(fleet=...) first")
        return self._planner

    @property
    def deployment_stats(self):
        """Per-group ``ClusterStats`` from the traced joint validation an
        observed fleet suggestion runs (``observe()`` then
        ``suggest(qos)``); ``None`` when telemetry is off."""
        return self._deployment_stats

    # ------------------------------------------------------------ output ----
    def pareto(self) -> list:
        """The non-dominated set of the last simulation — accuracy/latency
        for a single link, (p99, accuracy, server FLOPs/s) per device
        class for a fleet."""
        if self._mode == "fleet":
            return self._planner.pareto_front(self._points)
        return Q.pareto(self.verdicts)

    def suggest(self, qos, tiers=None, *, n_micro: int = 4,
                batch: Optional[int] = None, refine: Optional[int] = None,
                **tier_kw):
        """Stage 4: the best design meeting ``qos``
        (:class:`~repro_torch.core.qos.QoSRequirements`).  Single-link
        mode returns a ``SimVerdict`` (or None); fleet mode returns
        ``{device_name: PlanPoint | None}``.  Runs any missing stage with
        defaults first.

        ``tiers``: a ``fleet.TierTopology`` (device -> edge -> cloud
        chain) — searches cut-list x stage->tier assignment over it
        (``fleet.plan_tiers``; ``refine`` sizes the exactly priced
        shortlist) and returns the best feasible ``TierPlan`` (or None); a
        later :meth:`deploy` executes that plan's cut list live.
        Tier-plan latencies are makespans of one ``batch``-frame sample
        (default: the study sample's own batch).
        """
        if tiers is not None:
            from repro_torch.fleet.planner import plan_tiers, suggest_tier_plan
            self._tier_topology = tiers
            if refine is not None:
                tier_kw = dict(tier_kw, refine=refine)
            self._tier_plans = plan_tiers(
                self.model, self.params, tiers, n_micro=n_micro,
                cs_curve=self.cs_curve, layer_idx=self.layer_idx,
                compression=self.compression, sample=self._sample,
                batch=self._frame_batch() if batch is None else batch,
                obs=self._obs, **tier_kw)
            self._tier_best = suggest_tier_plan(self._tier_plans, qos)
            self._suggested = self._plans = None     # latest suggestion wins
            return self._tier_best
        self._tier_best = None                       # latest suggestion wins
        if self._mode == "fleet":
            self._plans = self._planner.suggest(qos, self._fleet,
                                                points=self._points)
            if self._recorder is not None and any(
                    p is not None and p.label != "LC"
                    for p in self._plans.values()):
                # the observed fleet run: re-simulate the *chosen* plans
                # jointly (shared clusters, mixed trace) under the
                # recorder — the planner's grid sims stay untraced
                from repro_torch.fleet.planner import simulate_deployment
                trace, devices = self._fleet
                self._deployment_stats = simulate_deployment(
                    self._plans, trace, devices, self._planner,
                    obs=self._recorder, engine=self._fleet_engine)
            return self._plans
        best = Q.suggest(self.verdicts, qos)
        self._suggested = best
        return best

    @property
    def tier_plans(self) -> list:
        """Every evaluated ``TierPlan`` of the last ``suggest(qos,
        tiers=...)`` call, sorted by pipelined latency."""
        if self._tier_plans is None:
            raise RuntimeError("tier_plans needs suggest(qos, tiers=...) "
                               "first")
        return self._tier_plans

    def _chosen_candidate(self, candidate, device) -> tuple:
        """(candidate, wire hops) the deployment should execute.

        ``hops`` is the per-hop pricing argument for ``SplitRuntime``:
        a protocol string (study channel on every hop), a list of
        ``NetworkConfig``\\ s, or ``NetworkPath`` hops.
        """
        if candidate is not None:
            return (SplitCandidate.from_any(candidate).validate(self.model),
                    self.scenario.protocol)
        if self._tier_best is not None:      # multi-tier suggestion
            plan = self._tier_best
            cand = SplitCandidate.sc(plan.splits, plan.accuracy_proxy,
                                     compression=self.compression)
            return cand, plan.runtime_path(self._tier_topology)
        if self._plans is not None:          # fleet suggestion
            plans = {d: p for d, p in self._plans.items() if p is not None}
            if device is None and len(plans) == 1:
                device = next(iter(plans))
            if device not in plans:
                raise ValueError(f"no feasible plan for device {device!r}; "
                                 f"feasible: {sorted(plans)}")
            p = plans[device]
            return (SplitCandidate.from_any((p.label, p.split_layer)),
                    p.protocol or self.scenario.protocol)
        if self._suggested is None:
            raise RuntimeError("deploy() after suggest(qos), or pass "
                               "candidate=")
        cand = SplitCandidate.from_any(self._suggested.candidate)
        if self._path is not None and len(cand.splits) == len(self._path):
            return cand, list(self._path.hops)   # the simulated hop chain
        return cand, self.scenario.protocol

    def deploy(self, candidate=None, *, device=None, serve: bool = False,
               n_slots: int = 4, quantize: bool = True,
               fused: bool = False, faults=None, recovery=None):
        """Stage 5: a ready runtime for the chosen cut (or cut list), on
        the study's device.

        Returns a :class:`~repro_torch.runtime.engine.SplitRuntime`
        executing the suggested SC design live — stage -> int8 wire ->
        stage, one hop per cut, the study scenario's channel (or the
        suggested tier plan's / simulated path's hop chain) pricing each
        hop — or, with ``serve=True``, a
        :class:`~repro_torch.runtime.engine.TailServer` batching many
        clients' tail requests.  ``candidate`` overrides the suggestion
        (``'SC@2+5'`` / a cut tuple name multi-cut designs); ``device``
        picks a fleet plan's device class.  RC/LC designs have no cut to
        execute and raise with guidance.

        There is no ``backend=``: the reference uses it to pick the
        kernel, its interpret mode or the plain path.  The port's codec
        wrappers dispatch on the tensor's device, so on the card an AE hop
        always launches the kernels, and on the CPU it runs their plain
        versions.

        ``faults`` (a :class:`~repro_torch.runtime.faults.FaultPlan`)
        injects the deterministic fault schedule into the returned runtime
        or server; ``recovery`` (a
        :class:`~repro_torch.runtime.faults.RecoveryPolicy`) tunes the
        retry/backoff/degradation machinery.  Both default to off.
        """
        cand, hops = self._chosen_candidate(candidate, device)
        if cand.kind != "SC":
            raise ValueError(
                f"suggested design is {cand.label}: nothing to split — run "
                f"the whole model on the "
                f"{'server' if cand.kind == 'RC' else 'edge'} instead "
                f"(deploy() builds split runtimes; pass candidate='SC@<k>' "
                f"to force a cut)")
        splits = cand.splits
        ae = ({c: self._ae_map[c] for c in splits if c in self._ae_map}
              or None)
        if serve:
            from repro_torch.runtime.engine import TailServer
            from repro_torch.runtime.partition import make_partition
            part = make_partition(self.model, self.params, splits, ae,
                                  device=self.device)
            return TailServer(part, n_slots=n_slots, faults=faults,
                              device=self.device)
        from repro_torch.runtime.engine import SplitRuntime
        if isinstance(hops, str):            # protocol over the study link
            hops = dict(channel=self.scenario.channel, protocol=hops)
        else:
            hops = dict(channel=hops)
        return SplitRuntime(self.model, self.params, splits, ae=ae,
                            quantize=quantize, fused=fused, obs=self._recorder,
                            faults=faults, recovery=recovery,
                            device=self.device, **hops)
