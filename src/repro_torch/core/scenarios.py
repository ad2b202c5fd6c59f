"""Computation-platform models and the LC / RC / SC scenario definitions
(paper §II-A; twin of ``repro/core/scenarios.py``).

The paper's simulator composes three timing sources: computation on the
edge device, computation on the server, and transmission.  Compute
latencies come from an analytic platform model (FLOPs / effective
throughput) or, through :class:`HILPlatform` and
``runtime.calibrate``, from measurements on the attached card.
Transmission timing comes from ``repro_torch.netsim`` (discrete-event
TCP/UDP).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np

from repro_torch.core import stats as S
from repro_torch.core.split import SplitPlan, hop_payload_bytes
from repro_torch.tree import tree_leaves


@dataclass(frozen=True)
class PlatformProfile:
    """Effective (not peak) throughput of a compute platform."""
    name: str
    flops_per_s: float

    def compute_time(self, flops: float) -> float:
        return flops / self.flops_per_s


# The reference's modelled profiles, kept key for key and number for number
# so that both packages price a flow alike: assumed effective throughputs
# (~30-50% of peak), not measurements of any device.
PLATFORMS = {
    "mcu": PlatformProfile("mcu", 2e9),
    "edge-embedded": PlatformProfile("edge-embedded", 0.5e12),   # Nano-class
    "edge-accelerator": PlatformProfile("edge-accelerator", 5e12),  # Orin-class
    "server-gpu": PlatformProfile("server-gpu", 60e12),
    "tpu-v5e-chip": PlatformProfile("tpu-v5e-chip", 0.4 * 197e12),
}

# Sensing-side platforms a deployed fleet is made of.
EDGE_PLATFORM_NAMES = ("mcu", "edge-embedded", "edge-accelerator")


def edge_platform(name: str) -> PlatformProfile:
    """Resolve an edge platform by name with a diagnosable failure."""
    if name not in PLATFORMS:
        raise KeyError(f"unknown platform {name!r}; known: {sorted(PLATFORMS)}")
    if name not in EDGE_PLATFORM_NAMES:
        raise KeyError(f"{name!r} is a server platform, not an edge device "
                       f"class; edge classes: {EDGE_PLATFORM_NAMES}")
    return PLATFORMS[name]


class HILPlatform:
    """Hardware-in-the-loop platform (paper §IV): instead of the analytic
    FLOPs/throughput model, computation time is *measured* by executing the
    segment on the attached hardware (the card, or the host CPU for CPU
    tensors); on a real deployment the same interface wraps the edge device.

    ``compute_time(flops)`` falls back to the analytic model when no
    measurement has been registered for that segment."""

    def __init__(self, name: str, fallback_flops_per_s: float = 50e9):
        self.name = name
        self.flops_per_s = fallback_flops_per_s
        self._measured = {}

    def measure(self, key: str, fn, *args, iters: int = 3) -> float:
        """One warm call, then the mean wall clock of ``iters`` calls, each
        fenced on the card (kernels launch asynchronously)."""
        from repro_torch.runtime.engine import _fence
        fn(*args)                                  # warm
        _fence()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
            _fence()
        dt = (time.perf_counter() - t0) / iters
        self._measured[key] = dt
        return dt

    def compute_time(self, flops: float, key: str = None) -> float:
        if key is not None and key in self._measured:
            return self._measured[key]
        return flops / self.flops_per_s


@dataclass(frozen=True)
class Scenario:
    """One design point: where does the computation run, what crosses the net."""
    kind: str                      # 'LC' | 'RC' | 'SC'
    split_plan: Optional[SplitPlan] = None   # SC only
    edge: PlatformProfile = PLATFORMS["edge-embedded"]
    server: PlatformProfile = PLATFORMS["server-gpu"]

    def label(self) -> str:
        if self.kind == "SC":
            return f"SC@{self.split_plan.split_layer}"
        return self.kind


def scenario_times_and_payload(scenario: Scenario, model, params,
                               input_bytes: int, batch: int = 1, *,
                               sample=None) -> dict:
    """(edge_time, server_time, wire_bytes) for one inference frame.

    ``sample``: example input (a tensor or a batch dict) for models whose
    ``input_shape`` alone cannot describe the input.  FLOPs are counted
    at the sample's own leading dim and rescaled linearly to ``batch``.
    """
    scale = _sample_scale(batch, sample)
    total_flops = S.total_flops(model, params, batch, sample=sample) * scale
    if scenario.kind == "LC":
        return {"edge_s": scenario.edge.compute_time(total_flops),
                "server_s": 0.0, "wire_bytes": 0}
    if scenario.kind == "RC":
        return {"edge_s": 0.0,
                "server_s": scenario.server.compute_time(total_flops),
                "wire_bytes": input_bytes}
    plan = scenario.split_plan
    tiers = (scenario.edge,) + (scenario.server,) * len(plan.splits)
    st = stage_times_and_payloads(model, params, plan, tiers, batch,
                                  sample=sample)
    return {"edge_s": st["stage_s"][0],
            "server_s": sum(st["stage_s"][1:]),
            "wire_bytes": sum(st["hop_bytes"])}


def cut_payload_bytes_lut(model, params, batch: int = 1, *,
                          compression: float = 0.5,
                          wire_dtype_bytes: int = 4,
                          sample=None) -> np.ndarray:
    """Wire payload (bytes per ``batch`` frames) for a cut after *every*
    layer, as one array indexed by layer — the batched counterpart of
    pricing each cut's activation separately.  Rides the ``stats.summary``
    cache; illegal cuts simply carry the payload their activation would
    have."""
    from repro_torch.core import bottleneck as B
    rows = S.summary(model, params, batch, sample=sample)
    scale = _sample_scale(batch, sample)
    return np.array(
        [int(round(r.output_shape[0] * scale))
         * B.payload_bytes(r.output_shape[1:], compression, wire_dtype_bytes)
         if len(r.output_shape) > 1 else 0.0
         for r in rows], dtype=float)


def _sample_scale(batch: int, sample) -> float:
    """FLOPs are counted at the sample's own leading dim and rescaled
    linearly to ``batch``."""
    if sample is None:
        return 1.0
    return batch / int(tree_leaves(sample)[0].shape[0])


def stage_times_and_payloads(model, params, plan: SplitPlan, tiers,
                             batch: int = 1, *, sample=None) -> dict:
    """Per-stage compute times and per-hop payloads of a K-cut plan.

    ``tiers`` is the K+1 platform chain (device, ..., server) the stages
    run on; hop k carries the (compressed) activation after cut
    ``plan.splits[k]``.  This is the multi-tier generalisation of the
    SC branch of :func:`scenario_times_and_payload`, which delegates here
    with the 2-platform (edge, server) chain — the analytic stage/hop
    numbers ``netsim.simulator.measure_flow`` prices a ``NetworkPath``
    with.
    """
    cuts = plan.splits
    if len(tiers) != len(cuts) + 1:
        raise ValueError(f"{len(cuts)} cuts need {len(cuts) + 1} tiers, "
                         f"got {len(tiers)}")
    scale = _sample_scale(batch, sample)
    stage_f = S.flops_stages(model, params, cuts, batch, sample=sample)
    hop_bytes = hop_payload_bytes(model, params, plan, batch, sample=sample)
    return {"stage_s": [t.compute_time(f * scale)
                        for t, f in zip(tiers, stage_f)],
            "hop_bytes": hop_bytes}
