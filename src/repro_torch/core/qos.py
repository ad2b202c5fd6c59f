# Copied from src/repro/core/qos.py (the whole file).
"""QoS matching: rank candidate configurations, suggest the best design
(paper §IV outputs i and ii).

Output i  — *suggested configurations*: SC candidates ranked by the CS value
            at their split point (the paper's accuracy proxy), plus LC/RC.
Output ii — *simulation verdicts*: after the netsim simulates the chosen
            subset, pick the best design meeting the application
            constraints (e.g. 20 FPS conveyor belt + accuracy floor).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Sequence

from repro_torch.api.types import SplitCandidate

# Alias kept from the reference: the candidate type lives in
# ``repro_torch.api.types``.
Candidate = SplitCandidate


@dataclass(frozen=True)
class QoSRequirements:
    max_latency_s: float            # e.g. 0.05 (20 FPS conveyor belt, §V-B)
    min_accuracy: float = 0.0


@dataclass
class SimVerdict:
    candidate: Candidate
    latency_s: float
    accuracy: float
    meta: dict = field(default_factory=dict)

    def satisfies(self, qos: QoSRequirements) -> bool:
        return (self.latency_s <= qos.max_latency_s
                and self.accuracy >= qos.min_accuracy)


def rank_candidates(cs_curve, layer_idx: Sequence[int],
                    split_points: Sequence[int],
                    include_lc_rc: bool = True) -> list[SplitCandidate]:
    """Output i: candidates ordered by presumed accuracy (CS at the cut)."""
    pos = {sp: i for i, sp in enumerate(layer_idx)}
    missing = [sp for sp in split_points if sp not in pos]
    if missing:
        raise ValueError(
            f"split points {missing} have no CS value: not in layer_idx "
            f"{sorted(pos)} — pass the layer_idx the curve was computed over")
    cands = [SplitCandidate.sc(sp, float(cs_curve[pos[sp]]))
             for sp in split_points]
    cands.sort(key=lambda c: -c.accuracy_proxy)
    if include_lc_rc:
        # RC preserves full accuracy (proxy 1.0 by definition); LC runs the
        # lightweight local model (proxy below any SC cut).
        cands = [SplitCandidate.rc()] + cands + [SplitCandidate.lc()]
    return cands


def suggest(verdicts: Sequence[SimVerdict], qos: QoSRequirements) -> Optional[SimVerdict]:
    """Output ii: best feasible design — max accuracy, then min latency."""
    ok = [v for v in verdicts if v.satisfies(qos)]
    if not ok:
        return None
    return max(ok, key=lambda v: (v.accuracy, -v.latency_s))


def pareto(verdicts: Sequence[SimVerdict]) -> list:
    """Accuracy/latency Pareto frontier over simulated designs."""
    keyed = [(v, (v.latency_s, -v.accuracy)) for v in verdicts]
    front = [v for v, _ in pareto_nd(keyed)]
    return sorted(front, key=lambda v: v.latency_s)


def pareto_nd(items: Sequence[tuple]) -> list:
    """N-objective Pareto filter over ``(payload, objectives)`` pairs.

    Every objective is minimised (negate the ones you maximise).  An item
    survives unless some other item is <= on every objective and strictly
    < on at least one.  Duplicated objective vectors all survive.
    """
    out = []
    for i, (_, obj) in enumerate(items):
        dominated = False
        for j, (_, other) in enumerate(items):
            if j == i:
                continue
            if (all(o <= s for o, s in zip(other, obj))
                    and any(o < s for o, s in zip(other, obj))):
                dominated = True
                break
        if not dominated:
            out.append(items[i])
    return out
