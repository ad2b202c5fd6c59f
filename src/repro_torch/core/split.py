"""Cut legality, split plans and wire payloads (twin of
``repro/core/split.py:36-183``).

The multi-pod ``shard_map`` pipeline of the reference is not ported yet.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass

from repro_torch.core.bottleneck import payload_bytes
from repro_torch.models.layered import LayeredModel


@dataclass(frozen=True)
class SplitPlan:
    """A concrete SC design point: one or more ordered cuts.

    ``splits`` is the canonical ordered cut list; ``split_layer`` is the
    first (edge-side) cut, so ``SplitPlan(4)`` and
    ``SplitPlan(4, splits=(4,))`` are the same design point.
    """
    split_layer: int              # first cut (after this layer index)
    compression: float = 0.5      # bottleneck rate (paper: 50%)
    wire_dtype_bytes: int = 4
    splits: tuple = None          # full ordered cut list; (split_layer,) if None

    def __post_init__(self):
        if self.splits is None:
            cuts = () if self.split_layer is None else (int(self.split_layer),)
        else:
            cuts = normalize_cuts(self.splits)
        object.__setattr__(self, "splits", cuts)
        if self.split_layer is None and cuts:
            object.__setattr__(self, "split_layer", cuts[0])

    @property
    def n_stages(self) -> int:
        return len(self.splits) + 1

    def describe(self, model: LayeredModel) -> str:
        """Human-readable stage layout of this plan on ``model``."""
        cuts = validate_cuts(model, self.splits)
        if len(cuts) == 1:
            return (f"head=[0..{self.split_layer}] "
                    f"bottleneck(rate={self.compression}) "
                    f"tail=[{self.split_layer + 1}..{len(model.layers) - 1}]")
        bounds = (0,) + tuple(c + 1 for c in cuts) + (len(model.layers),)
        stages = " | ".join(f"stage{i}=[{a}..{b - 1}]"
                            for i, (a, b) in enumerate(zip(bounds, bounds[1:])))
        return f"{stages} bottleneck(rate={self.compression})"


def legal_cuts(model: LayeredModel) -> list[int]:
    """All legal cut indices of ``model`` (ascending layer order)."""
    return model.cut_points()


def validate_cut(model: LayeredModel, split_layer: int) -> int:
    """Check a cut index against the model's legality rule; raises with the
    legal alternatives."""
    cuts = model.cut_points()
    if split_layer not in cuts:
        raise ValueError(
            f"cut after layer {split_layer} is not legal for {model.name!r}; "
            f"legal cuts: {cuts}")
    return split_layer


def normalize_cuts(splits) -> tuple:
    """A scalar cut or an iterable of cuts -> the ascending cut tuple;
    raises unless strictly increasing."""
    if not hasattr(splits, "__iter__"):
        return (int(splits),)
    cuts = tuple(int(s) for s in splits)
    if any(b <= a for a, b in zip(cuts, cuts[1:])):
        raise ValueError(f"cut list {cuts} must be strictly increasing "
                         f"(every stage needs at least one layer)")
    return cuts


def validate_cuts(model: LayeredModel, splits) -> tuple:
    """Check an ordered cut list: non-empty, strictly increasing, every cut
    legal.  Returns the normalised tuple."""
    cuts = normalize_cuts(splits)
    if not cuts:
        raise ValueError(f"need at least one cut for {model.name!r}; "
                         f"legal cuts: {model.cut_points()}")
    for c in cuts:
        validate_cut(model, c)
    return cuts


def legal_cut_lists(model: LayeredModel, n_cuts: int) -> list:
    """Every legal ordered cut list with exactly ``n_cuts`` cuts."""
    if n_cuts < 1:
        raise ValueError(f"n_cuts must be >= 1, got {n_cuts}")
    return list(itertools.combinations(legal_cuts(model), n_cuts))


def wire_payload_bytes(model: LayeredModel, params, plan: SplitPlan,
                       batch: int = 1, *, sample=None) -> int:
    """Bytes crossing the first (edge-side) wire hop per ``batch`` frames
    under ``plan``; see :func:`hop_payload_bytes` for the whole chain.
    ``sample`` as in ``LayeredModel.activation_shapes``."""
    return hop_payload_bytes(model, params, plan, batch, sample=sample)[0]


def hop_payload_bytes(model: LayeredModel, params, plan: SplitPlan,
                      batch: int = 1, *, sample=None) -> list:
    """Per-hop wire payloads (bytes per ``batch`` frames) of a K-cut plan.

    Hop k carries the activation after cut ``plan.splits[k]``, compressed
    at the plan's bottleneck rate (one AE per cut, same rate).
    """
    shapes = model.activation_shapes(params, batch, sample=sample)
    return [batch * payload_bytes(shapes[c][1:], plan.compression,
                                  plan.wire_dtype_bytes)
            for c in plan.splits]
