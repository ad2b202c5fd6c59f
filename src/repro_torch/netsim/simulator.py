"""The Split-Et-Impera simulator: supervisor / sensing / transmitter /
netsim / receiver (paper §IV, Fig. 1-ii/iii; twin of
``repro/netsim/simulator.py``).

Inputs, matching the paper's list: (1) test scenario LC/RC/SC, (2-3) the
trained model, (4) the test set, (5) the communication-network modelling
parameters (protocol, channel latency, capacity, interface speed,
saboteur).  Output: per-configuration latency and *measured* accuracy —
under UDP the receiver zeroes the payload chunks of lost datagrams and the
tail network runs on the corrupted tensor, so the accuracy degradation is
real, not modelled.

Everything up to :func:`chunk_mask_from_packets` is numpy and Python on
the discrete-event engine.  :class:`ApplicationSimulator` runs the model
eagerly on its device under ``torch.inference_mode()``: the plain f32
forward, with no wire codec, so no kernel of the port runs on this path.
"""
from __future__ import annotations

import math
import warnings
from collections import deque
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core import bottleneck as B
from repro_torch.core import stats as S
from repro_torch.core.qos import Candidate, SimVerdict
from repro_torch.core.scenarios import (Scenario, scenario_times_and_payload,
                                        stage_times_and_payloads)
from repro_torch.device import resolve_device
from repro_torch.netsim.channel import Channel
from repro_torch.netsim.events import EventQueue
from repro_torch.netsim.protocols import MTU_BYTES, simulate_transfer


@dataclass(frozen=True)
class NetworkConfig:
    protocol: str                  # 'tcp' | 'udp'
    channel: Channel
    mtu: int = MTU_BYTES


@dataclass(frozen=True)
class NetworkPath:
    """An ordered chain of wire hops (device -> edge -> ... -> cloud).

    The multi-tier counterpart of :class:`NetworkConfig`: hop k connects
    tier k to tier k+1 and carries the activation after cut k of a
    K-cut plan.  Hops may be given as ``NetworkConfig`` or bare
    ``Channel`` (priced over ``default_protocol``).
    """
    hops: tuple
    default_protocol: str = "tcp"

    def __post_init__(self):
        norm = tuple(h if isinstance(h, NetworkConfig)
                     else NetworkConfig(self.default_protocol, h)
                     for h in self.hops)
        object.__setattr__(self, "hops", norm)

    def __len__(self):
        return len(self.hops)

    def __iter__(self):
        return iter(self.hops)

    def __getitem__(self, k) -> NetworkConfig:
        return self.hops[k]

    def channels(self) -> list:
        return [h.channel for h in self.hops]


def as_path(net, protocol: str = "tcp") -> NetworkPath:
    """Coerce a NetworkPath / NetworkConfig / Channel / hop sequence."""
    if isinstance(net, NetworkPath):
        return net
    if isinstance(net, (NetworkConfig, Channel)):
        return NetworkPath((net,), default_protocol=protocol)
    return NetworkPath(tuple(net), default_protocol=protocol)


class _LegacyCalibration:
    """Adapter for the deprecated ``calibration=`` argument: the old
    contract was "any object with ``flow_times(kind, split)``" (no
    ``batch`` parameter — the caller rescaled).  This keeps such objects
    working through the ``CostModel`` interface."""

    def __init__(self, table):
        self._table = table
        self.batch = getattr(table, "batch", 0)

    def flow_times(self, kind, split=None, batch=None):
        times = self._table.flow_times(kind, split)
        if times is not None and batch:
            from repro_torch.api.types import scale_flow_times
            times = scale_flow_times(times, self.batch or batch, batch)
        return times

    def server_cost(self, split, platform):
        fn = getattr(self._table, "server_cost", None)
        if fn is not None:
            return fn(split, platform)
        # pre-CostModel planner contract: a ``lookup(kind, split)`` whose
        # entry carries the measured per-cal-batch server wall clock
        lookup = getattr(self._table, "lookup", None)
        if lookup is None:
            return None
        entry = lookup("SC" if split is not None else "RC", split)
        if entry is None:
            return None
        from repro_torch.serving.engine import BatchCostModel
        per_item = entry.server_s / max(1, self.batch or 1)
        return BatchCostModel.from_measured(per_item, platform.flops_per_s)


# ------------------------------------------------- pipelined microbatching ----
@dataclass
class PipelineResult:
    """Makespan of one sample through a K-hop stage chain, microbatched.

    ``latency_s`` is the pipelined makespan (last microbatch leaves the
    last stage); ``sequential_s`` is the no-overlap reference (sum of
    stage times + one full-payload transfer per hop).  The speedup comes
    from hop-k transfer overlapping stage-k+1 compute (and the other
    hops) across microbatches, GPipe-style.
    """
    latency_s: float
    sequential_s: float
    n_micro: int
    stage_s: tuple                   # full-sample stage times the sim used
    hop_bytes: tuple
    micro_done_s: tuple              # per-microbatch exit times

    @property
    def speedup(self) -> float:
        return self.sequential_s / self.latency_s if self.latency_s else 1.0


def simulate_pipeline(stage_s, hop_bytes, path, *, n_micro: int = 4,
                      stream: int = 0,
                      check_closed_form: bool = False) -> PipelineResult:
    """Event-driven microbatched execution of a multi-tier split sample.

    The sample is chopped into ``n_micro`` microbatches; each tier and
    each link is a serial resource (one microbatch at a time, FIFO), so
    hop-k transfer of microbatch m overlaps stage-k+1 compute of
    microbatch m-1 — scheduled on the shared discrete-event engine
    (``netsim.events.EventQueue``), per-microbatch transfer durations
    priced by the transport models on ``ceil(bytes / n_micro)`` payloads.

    ``stage_s``: K+1 full-sample stage compute times (zero entries model
    pass-through tiers); ``hop_bytes``: K full-sample payloads; ``path``:
    the K-hop :class:`NetworkPath`.

    ``check_closed_form``: cross-check this result against the closed
    form in ``netsim.analytic`` (loss-free paths only — with loss the
    closed form is a screen, not a price) and raise ``AssertionError``
    on >1e-9 relative divergence.  The planner's refinement stage runs
    with this on, so the screen can never silently disagree with the
    event engine — which stays the single semantic authority.
    """
    path = as_path(path)
    K = len(path)
    if len(stage_s) != K + 1 or len(hop_bytes) != K:
        raise ValueError(f"{K}-hop path needs {K + 1} stage times and {K} "
                         f"payloads, got {len(stage_s)}/{len(hop_bytes)}")
    if n_micro < 1:
        raise ValueError(f"n_micro must be >= 1, got {n_micro}")
    mb_stage = [s / n_micro for s in stage_s]
    mb_dur = [[simulate_transfer(cfg.protocol,
                                 max(1, math.ceil(b / n_micro)),
                                 cfg.channel, mtu=cfg.mtu,
                                 stream=stream * 977 + 97 * k + m).duration_s
               for m in range(n_micro)]
              for k, (cfg, b) in enumerate(zip(path, hop_bytes))]

    q = EventQueue()
    tier_busy = [False] * (K + 1)
    tier_q = [deque() for _ in range(K + 1)]
    link_busy = [False] * K
    link_q = [deque() for _ in range(K)]
    done = {}

    def maybe_compute(k):
        if tier_busy[k] or not tier_q[k]:
            return
        m = tier_q[k].popleft()
        tier_busy[k] = True
        q.schedule(q.now + mb_stage[k], lambda: stage_done(k, m))

    def stage_done(k, m):
        tier_busy[k] = False
        if k == K:
            done[m] = q.now
        else:
            link_q[k].append(m)
            maybe_send(k)
        maybe_compute(k)

    def maybe_send(k):
        if link_busy[k] or not link_q[k]:
            return
        m = link_q[k].popleft()
        link_busy[k] = True
        dur = mb_dur[k][m]
        # the link is busy for the sender-clocked part of the transfer;
        # the last bit then propagates for one channel latency while the
        # next microbatch may already be serialising behind it
        busy = max(dur - path[k].channel.latency_s, 0.0)

        def freed(k=k):
            link_busy[k] = False
            maybe_send(k)

        def delivered(k=k, m=m):
            tier_q[k + 1].append(m)
            maybe_compute(k + 1)
        q.schedule(q.now + busy, freed)
        q.schedule(q.now + dur, delivered)

    for m in range(n_micro):
        tier_q[0].append(m)
    maybe_compute(0)
    q.run()
    sequential = sum(stage_s) + sum(
        simulate_transfer(cfg.protocol, b, cfg.channel, mtu=cfg.mtu,
                          stream=stream * 977 + 97 * k).duration_s
        for k, (cfg, b) in enumerate(zip(path, hop_bytes)))
    result = PipelineResult(max(done.values()), sequential, n_micro,
                            tuple(stage_s), tuple(hop_bytes),
                            tuple(done[m] for m in range(n_micro)))
    if check_closed_form:
        from repro_torch.netsim import analytic
        if analytic.path_params(path).exact:
            cf_pipe, cf_seq = analytic.closed_form_pipeline(
                stage_s, hop_bytes, path, n_micro=n_micro)
            analytic.assert_event_match("pipelined makespan", cf_pipe,
                                        result.latency_s)
            analytic.assert_event_match("sequential makespan", cf_seq,
                                        result.sequential_s)
    return result


def measure_flow(scenario: Scenario, netcfg, model, params,
                 input_bytes: int, n_frames: int = 8, *,
                 cost=None, calibration=None, batch: int = 1,
                 sample=None, tiers=None, n_micro=None) -> dict:
    """Per-flow latency decomposition of one scenario over one network.

    Returns ``edge_s``/``server_s`` compute times, the wire payload, and
    ``n_frames`` independent :class:`TransferResult` draws (empty for LC).
    ``ApplicationSimulator.simulate`` consumes this for single-link runs.

    ``netcfg`` may also be a :class:`NetworkPath` (or hop sequence): a
    K-cut SC plan is then priced hop by hop — stage k's compute on tier
    k (``tiers``: the K+1 platform chain; default: the scenario's edge
    followed by its server for every later stage), hop k's transfer over
    path entry k.  The returned dict adds per-stage keys (``stage_s``,
    ``hop_bytes``, ``hop_frames``, ``hop_wire_s``) while keeping the flat
    2-tier aggregates (``edge_s`` = stage 0, ``server_s`` = later stages,
    ``wire_s[f]`` = frame f's whole-path transfer), so
    :func:`flow_latency_s` reads as the *sequential* multi-hop latency.
    With ``n_micro``, the pipelined-microbatch makespan is added as
    ``pipeline`` / ``pipeline_s`` — hop-k transfer overlapping stage-k+1
    compute (:func:`simulate_pipeline`), the multi-tier speed win.
    Multi-hop flows are priced analytically (``cost`` sources only cover
    the 2-tier cells).

    ``cost``: any :class:`repro_torch.api.types.CostModel` — a
    ``runtime.calibrate.CalibrationTable`` (measured), an
    ``api.types.AnalyticCost``, or a ``CostStack`` of both.  When it
    prices this scenario's cell, compute times and the wire payload come
    from it (the returned dict's ``cost_source`` says which path produced
    them); cells it can't price fall back to the built-in analytic
    FLOPs/throughput model.  Cost sources quoted at a different batch
    size rescale linearly to ``batch`` (first-order model; re-calibrate
    at the serving batch for exact numbers).

    ``calibration``: deprecated alias of ``cost`` (the signature before the
    cost layer), kept as a shim.

    ``sample``: example input pytree forwarded to the analytic fallback
    for models whose ``input_shape`` cannot describe the input.
    """
    if calibration is not None:
        warnings.warn("measure_flow(calibration=...) is deprecated; pass "
                      "cost=... (any repro_torch.api.types.CostModel)",
                      DeprecationWarning, stacklevel=2)
        if cost is None:
            cost = _LegacyCalibration(calibration)
    plan = scenario.split_plan
    n_cuts = len(getattr(plan, "splits", ()) or ())
    if (isinstance(netcfg, NetworkPath) or n_cuts > 1
            or not isinstance(netcfg, NetworkConfig)):
        if cost is not None:
            warnings.warn(
                "cost sources only price 2-tier cells; this multi-hop "
                "path flow is priced analytically and cost= is ignored",
                stacklevel=2)
        return _measure_path_flow(scenario, as_path(netcfg), model, params,
                                  input_bytes, n_frames, batch=batch,
                                  sample=sample, tiers=tiers,
                                  n_micro=n_micro)
    times = None
    if cost is not None:
        split = getattr(scenario.split_plan, "split_layer", None)
        times = cost.flow_times(scenario.kind, split, batch=batch)
    if times is None:
        times = dict(scenario_times_and_payload(scenario, model, params,
                                                input_bytes=input_bytes,
                                                batch=batch, sample=sample),
                     cost_source="analytic")
    frames = []
    if times["wire_bytes"] > 0:
        frames = [simulate_transfer(netcfg.protocol, times["wire_bytes"],
                                    netcfg.channel, stream=f, mtu=netcfg.mtu)
                  for f in range(n_frames)]
    return {**times, "frames": frames,
            "wire_s": [t.duration_s for t in frames],
            # per-frame retransmit counts: what reliable delivery cost
            # beyond the packet count (0 for UDP — it never resends)
            "retries": [t.n_transmissions - t.n_packets for t in frames]}


def _measure_path_flow(scenario: Scenario, path: NetworkPath, model, params,
                       input_bytes: int, n_frames: int, *, batch: int,
                       sample=None, tiers=None, n_micro=None) -> dict:
    """Multi-hop pricing behind :func:`measure_flow` (SC and RC flows)."""
    plan = scenario.split_plan
    if scenario.kind == "SC":
        cuts = plan.splits
        if len(path) != len(cuts):
            raise ValueError(
                f"{len(cuts)}-cut plan needs a {len(cuts)}-hop path, got "
                f"{len(path)} hops (pass one NetworkConfig per hop)")
        if tiers is None:
            tiers = (scenario.edge,) + (scenario.server,) * len(cuts)
        st = stage_times_and_payloads(model, params, plan, tiers, batch,
                                      sample=sample)
        stage_s, hop_bytes = st["stage_s"], st["hop_bytes"]
    elif scenario.kind == "RC":
        # the raw input traverses the whole path; the last tier computes
        from repro_torch.core.stats import total_flops
        from repro_torch.core.scenarios import _sample_scale
        flops = (total_flops(model, params, batch, sample=sample)
                 * _sample_scale(batch, sample))
        server = (tiers[-1] if tiers else scenario.server)
        stage_s = [0.0] * len(path) + [server.compute_time(flops)]
        hop_bytes = [input_bytes] * len(path)   # 2-tier RC convention
    else:                            # LC never touches the network
        from repro_torch.core.stats import total_flops
        from repro_torch.core.scenarios import _sample_scale
        flops = (total_flops(model, params, batch, sample=sample)
                 * _sample_scale(batch, sample))
        edge = (tiers[0] if tiers else scenario.edge)
        stage_s, hop_bytes, path = [edge.compute_time(flops)], [], as_path(())
    hop_frames = [[simulate_transfer(cfg.protocol, b, cfg.channel,
                                     stream=f * 131 + k, mtu=cfg.mtu)
                   for f in range(n_frames)]
                  for k, (cfg, b) in enumerate(zip(path, hop_bytes))]
    wire_s = [sum(hop_frames[k][f].duration_s for k in range(len(path)))
              for f in range(n_frames)]
    flow = {"edge_s": stage_s[0], "server_s": sum(stage_s[1:]),
            "wire_bytes": sum(hop_bytes), "cost_source": "analytic",
            "stage_s": list(stage_s), "hop_bytes": list(hop_bytes),
            "hop_frames": hop_frames,
            "hop_wire_s": [[t.duration_s for t in hf] for hf in hop_frames],
            "hop_retries": [[t.n_transmissions - t.n_packets for t in hf]
                            for hf in hop_frames],
            "frames": hop_frames[0] if hop_frames else [],
            "wire_s": wire_s,
            "retries": [sum(hop_frames[k][f].n_transmissions
                            - hop_frames[k][f].n_packets
                            for k in range(len(path)))
                        for f in range(n_frames)]}
    if n_micro is not None:
        pipe = simulate_pipeline(stage_s, hop_bytes, path, n_micro=n_micro)
        flow["pipeline"] = pipe
        flow["pipeline_s"] = pipe.latency_s
    return flow


def flow_latency_s(flow: dict) -> float:
    """One-frame latency of a :func:`measure_flow` result:
    edge compute + mean wire transfer + server compute."""
    wire = float(np.mean(flow["wire_s"])) if flow["wire_s"] else 0.0
    return flow["edge_s"] + wire + flow["server_s"]


def chunk_mask_from_packets(n_elems: int, delivered: np.ndarray,
                            elem_bytes: int, mtu: int) -> np.ndarray:
    """Map per-packet delivery to a per-element keep mask (receiver view)."""
    per_pkt = max(1, mtu // elem_bytes)
    mask = np.ones(n_elems, bool)
    for p in np.nonzero(~delivered)[0]:
        mask[p * per_pkt:(p + 1) * per_pkt] = False
    return mask


class ApplicationSimulator:
    """Drives n_frames of the sensing->transmit->receive->infer loop.

    ``params``, ``ae`` and ``lc_params`` must lie on ``device``; images come
    as numpy (N, H, W, C) and go to the device a chunk of 64 at a time, with
    the chunk's loss masks.
    """

    def __init__(self, model, params, netcfg: NetworkConfig, *,
                 ae=None, lc_model=None, lc_params=None, wire_dtype_bytes=4,
                 device="cuda"):
        self.model, self.params = model, params
        self.netcfg = netcfg
        self.ae = ae
        self.lc_model, self.lc_params = lc_model, lc_params
        self.wire_dtype_bytes = wire_dtype_bytes
        self.device = resolve_device(device)

    # -------------------------------------------------------- inference ----
    def wire_shape(self, scenario: Scenario, image_shape: tuple) -> tuple:
        """One image's tensor on the wire: the input for RC, the activation
        after the cut (the AE's latent where there is one) for SC."""
        if scenario.kind == "RC":
            return tuple(image_shape)
        split = scenario.split_plan.split_layer
        shape = S.summary(self.model, self.params, 1)[split].output_shape[1:]
        if self.ae is not None:
            shape = shape[:-1] + (self.ae["enc"]["w"].shape[1],)
        return tuple(shape)

    def loss_masks(self, scenario: Scenario, frames, n_images: int,
                   image_shape: tuple) -> np.ndarray:
        """(n_images, wire elements) f32 keep masks: image i arrives as
        frame ``i % len(frames)`` did."""
        n_elems = int(np.prod(self.wire_shape(scenario, image_shape)))
        return np.stack([
            chunk_mask_from_packets(
                n_elems, frames[i % len(frames)].delivered,
                self.wire_dtype_bytes, self.netcfg.mtu)
            for i in range(n_images)]).astype(np.float32)

    def predict(self, scenario: Scenario, xb: np.ndarray,
                mb: np.ndarray = None) -> np.ndarray:
        """Logits of one chunk of images under ``scenario``; ``mb``: the
        chunk's keep masks (:meth:`loss_masks`), None where every packet
        arrived.  This is the inference :meth:`simulate` runs."""
        with torch.inference_mode():
            x = torch.as_tensor(xb, dtype=torch.float32, device=self.device)
            m = None
            if mb is not None:
                m = torch.as_tensor(mb, device=self.device).reshape(
                    (x.shape[0],) + self.wire_shape(scenario, x.shape[1:]))
            if scenario.kind == "LC":
                model = self.lc_model or self.model
                out = model.apply(self.lc_params or self.params, x)
            elif scenario.kind == "RC":
                out = self.model.apply(self.params, x if m is None else x * m)
            else:
                out = B.split_forward(self.model, self.params, self.ae,
                                      scenario.split_plan.split_layer, x, m)
            return out.cpu().numpy()

    def _apply_batched(self, scenario, xs, masks, batch=64):
        outs = []
        for i in range(0, xs.shape[0], batch):
            mb = None if masks is None else masks[i:i + batch]
            outs.append(self.predict(scenario, xs[i:i + batch], mb))
        return np.concatenate(outs)

    def _accuracy(self, preds: np.ndarray, ys: np.ndarray) -> float:
        return float((preds.argmax(-1) == ys).mean())

    # -------------------------------------------------------- scenarios ----
    def simulate(self, scenario: Scenario, xs: np.ndarray, ys: np.ndarray,
                 n_frames: int = 32, *, flow: dict = None) -> SimVerdict:
        """``flow``: a precomputed :func:`measure_flow` result to reuse
        (a measured one, say); measured fresh when omitted."""
        proto = self.netcfg.protocol
        times = flow if flow is not None else measure_flow(
            scenario, self.netcfg, self.model, self.params,
            input_bytes=int(np.prod(xs.shape[1:])) * 4, n_frames=n_frames)

        if scenario.kind == "LC":
            preds = self._apply_batched(scenario, xs, None)
            total_flops_t = times["edge_s"]
            return SimVerdict(Candidate("LC", None), total_flops_t,
                              self._accuracy(preds, ys),
                              meta={"wire_bytes": 0, "transfers": []})

        # transmission: n_frames transfers with distinct loss draws
        frames = times["frames"]
        lat = (times["edge_s"] + times["server_s"]
               + float(np.mean(times["wire_s"])))

        # accuracy: TCP delivers everything; UDP corrupts the payload
        masks = None
        if proto != "tcp":
            masks = self.loss_masks(scenario, frames, xs.shape[0], xs.shape[1:])
        preds = self._apply_batched(scenario, xs, masks)

        label = scenario.label()
        return SimVerdict(Candidate(label, getattr(scenario.split_plan, "split_layer", None)),
                          lat, self._accuracy(preds, ys),
                          meta={"wire_bytes": times["wire_bytes"],
                                "mean_tx": float(np.mean([t.n_transmissions for t in frames])),
                                "edge_s": times["edge_s"],
                                "server_s": times["server_s"]})
