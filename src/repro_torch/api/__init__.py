"""``repro_torch.api`` — the one-stop facade for the Split-Et-Impera
pipeline on the port (twin of ``repro/api/__init__.py``).

    from repro_torch.api import Study, QoSRequirements, Channel

    study = Study("vgg16", data=(xs, ys), device="cuda")
    verdict = (study.profile()          # CS curve (Grad-CAM saliency)
                    .candidates()       # legal cuts, LC/RC ranked
                    .calibrate()        # optional: measured cost tables
                    .simulate()         # netsim single link (or fleet=...)
                    .suggest(qos))      # Pareto + best QoS match
    runtime = study.deploy()            # ready SplitRuntime for the cut

Everything an end-to-end script needs is re-exported here, the same names
as the reference's.  Every target is a ``repro_torch`` module.

Attribute access is lazy (PEP 562): ``core.qos`` imports
``repro_torch.api.types`` at import time, so this package initialiser must
not eagerly import the facade (which imports ``core.qos`` back).
"""
from __future__ import annotations

_EXPORTS = {
    # the facade
    "Study": ("repro_torch.api.study", "Study"),
    "StudyScenario": ("repro_torch.api.study", "StudyScenario"),
    # the shared type layer
    "SplitCandidate": ("repro_torch.api.types", "SplitCandidate"),
    "CostModel": ("repro_torch.api.types", "CostModel"),
    "AnalyticCost": ("repro_torch.api.types", "AnalyticCost"),
    "CostStack": ("repro_torch.api.types", "CostStack"),
    "legal_split_candidates": ("repro_torch.api.types", "legal_split_candidates"),
    "legal_cut_list_candidates": ("repro_torch.api.types",
                                  "legal_cut_list_candidates"),
    # the vocabulary end-to-end scripts need
    "QoSRequirements": ("repro_torch.core.qos", "QoSRequirements"),
    "SimVerdict": ("repro_torch.core.qos", "SimVerdict"),
    "SplitPlan": ("repro_torch.core.split", "SplitPlan"),
    "validate_cuts": ("repro_torch.core.split", "validate_cuts"),
    "legal_cut_lists": ("repro_torch.core.split", "legal_cut_lists"),
    "Scenario": ("repro_torch.core.scenarios", "Scenario"),
    "PLATFORMS": ("repro_torch.core.scenarios", "PLATFORMS"),
    "Channel": ("repro_torch.netsim.channel", "Channel"),
    "INTERFACES": ("repro_torch.netsim.channel", "INTERFACES"),
    "compose_channels": ("repro_torch.netsim.channel", "compose_channels"),
    "NetworkConfig": ("repro_torch.netsim.simulator", "NetworkConfig"),
    "NetworkPath": ("repro_torch.netsim.simulator", "NetworkPath"),
    "PipelineResult": ("repro_torch.netsim.simulator", "PipelineResult"),
    "simulate_pipeline": ("repro_torch.netsim.simulator", "simulate_pipeline"),
    "DeviceClass": ("repro_torch.fleet.traffic", "DeviceClass"),
    "generate_trace": ("repro_torch.fleet.traffic", "generate_trace"),
    "SearchSpace": ("repro_torch.fleet.planner", "SearchSpace"),
    "DeploymentPlanner": ("repro_torch.fleet.planner", "DeploymentPlanner"),
    "simulate_deployment": ("repro_torch.fleet.planner", "simulate_deployment"),
    "Tier": ("repro_torch.fleet.planner", "Tier"),
    "TierTopology": ("repro_torch.fleet.planner", "TierTopology"),
    "TierPlan": ("repro_torch.fleet.planner", "TierPlan"),
    "plan_tiers": ("repro_torch.fleet.planner", "plan_tiers"),
    "suggest_tier_plan": ("repro_torch.fleet.planner", "suggest_tier_plan"),
    "CalibrationTable": ("repro_torch.runtime.calibrate", "CalibrationTable"),
    "calibrate": ("repro_torch.runtime.calibrate", "calibrate"),
    # telemetry (Study.observe and standalone recorders)
    "Recorder": ("repro_torch.obs", "Recorder"),
    "NullRecorder": ("repro_torch.obs", "NullRecorder"),
    "TelemetryReport": ("repro_torch.obs", "TelemetryReport"),
    # toy data for the runnable walkthroughs
    "toy_images": ("repro_torch.data.synthetic", "toy_images"),
    "toy_image_iter": ("repro_torch.data.synthetic", "toy_image_iter"),
    "SplitRuntime": ("repro_torch.runtime.engine", "SplitRuntime"),
    "TailServer": ("repro_torch.runtime.engine", "TailServer"),
    "run_clients": ("repro_torch.runtime.engine", "run_clients"),
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        module, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module 'repro_torch.api' has no attribute {name!r}")
    import importlib
    value = getattr(importlib.import_module(module), attr)
    globals()[name] = value          # cache for subsequent lookups
    return value


def __dir__():
    return __all__
