# Copied from src/repro/fleet/__init__.py.
"""Fleet-scale simulation and planning: traffic generation over a
heterogeneous device mix, a discrete-event serving cluster, a QoS-aware
deployment planner (which splits for this *population*), and an online
adaptive controller that re-plans splits live when the workload
drifts."""
from .traffic import (ARRIVAL_PATTERNS, DeviceClass, FleetRequest,  # noqa: F401
                      Trace, generate_trace)
from .cluster import ClusterConfig, ClusterSim, ClusterStats        # noqa: F401
from .vectorized import (PCTL_RTOL, StreamingClusterStats,          # noqa: F401
                         VectorClusterStats, VectorizedClusterSim,
                         fluid_cluster_stats, signals_at,
                         simulate_cluster_vectorized)
from .planner import (DeploymentPlanner, PlanPoint, SearchSpace,    # noqa: F401
                      Tier, TierPlan, TierTopology, plan_tiers,
                      simulate_deployment, suggest_tier_plan)
from .scenario import (LinkDegradation, Phase, RegimeChangeTrace,   # noqa: F401
                       ReplicaEvent, schedule_faults)
from .controller import (AdaptiveController, AdaptiveRunResult,     # noqa: F401
                         CandidatePlan, ControllerConfig, EraStats,
                         SwitchRecord)
