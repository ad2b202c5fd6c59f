# Copied from src/repro/api/types.py:35-356 (SplitCandidate, legal_split_candidates,
# legal_cut_list_candidates and the cost layer).
"""The design-point type of the split search: one LC / RC / SC candidate,
carried from the CS curve to a ``SplitPlan``, and the cost layer every
cost source implements: :class:`CostModel` (the protocol),
:class:`AnalyticCost` (FLOPs / effective-throughput model),
``runtime.calibrate.CalibrationTable`` (measured) and :class:`CostStack`
(first-match composition).  ``netsim.simulator.measure_flow`` consumes any
of them through the same two methods.

Split legality has one authority, ``core.split.validate_cuts``;
:meth:`SplitCandidate.validate` and :func:`legal_split_candidates` route
through it.  Imports from the rest of the package are lazy (inside
methods): ``core.qos`` imports this module at import time.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Protocol, Sequence, runtime_checkable


@dataclass(frozen=True, eq=False)
class SplitCandidate:
    """One LC / RC / SC design point, end-to-end.

    ``label`` is the display form (``'LC'`` | ``'RC'`` | ``'SC@<layer>'``,
    or ``'SC@<c1>+<c2>+..'`` for a multi-tier cut list) kept as the
    primary field for compatibility with the historical
    ``core.qos.Candidate`` (now an alias of this class).  Tuple
    compatibility (iteration, indexing, equality with
    ``(label, split_layer)``) keeps the planner's legacy call sites and
    tests working unchanged.

    ``splits`` is the canonical ordered cut list (empty for LC/RC); the
    scalar ``split_layer`` stays as the first (edge-side) cut, so 1-cut
    candidates are indistinguishable from the pre-multi-tier shape.

    Identity (``__eq__``/``__hash__``) is the *design point* — label and
    cut list — not the annotations (``accuracy_proxy``, ``compression``):
    two SC@4 candidates with different proxies are the same point, which
    makes equality transitive with the tuple form and lets the planner
    deduplicate candidates in sets/dicts.
    """
    label: str                       # 'LC' | 'RC' | 'SC@<layer>[+<layer>..]'
    split_layer: Optional[int] = None
    accuracy_proxy: float = 0.0      # CS value at the cut (ranking key)
    compression: float = 0.5         # bottleneck rate for the SC plan
    wire_dtype_bytes: int = 4
    splits: Optional[tuple] = None   # ordered cut list; derived when None

    def __post_init__(self):
        if self.kind == "SC":
            if self.splits is None:
                cuts = (() if self.split_layer is None
                        else (int(self.split_layer),))
            else:
                from repro_torch.core.split import normalize_cuts
                cuts = normalize_cuts(self.splits)
            object.__setattr__(self, "splits", cuts)
            if self.split_layer is None and cuts:
                object.__setattr__(self, "split_layer", cuts[0])
        else:
            object.__setattr__(self, "splits", ())

    # ------------------------------------------------------ constructors ----
    @classmethod
    def sc(cls, split, accuracy_proxy: float = 0.0,
           compression: float = 0.5, wire_dtype_bytes: int = 4) -> "SplitCandidate":
        """An SC design point at one cut (int) or a cut list (sequence)."""
        from repro_torch.core.split import normalize_cuts
        cuts = normalize_cuts(split)
        label = "SC@" + "+".join(str(c) for c in cuts)
        return cls(label, cuts[0], accuracy_proxy,
                   compression, wire_dtype_bytes, splits=cuts)

    @classmethod
    def rc(cls, accuracy_proxy: float = 1.0) -> "SplitCandidate":
        """Remote Computation: the server runs the whole model (full accuracy)."""
        return cls("RC", None, accuracy_proxy)

    @classmethod
    def lc(cls, accuracy_proxy: float = 0.0) -> "SplitCandidate":
        """Local Computation: the edge runs a lightweight local model."""
        return cls("LC", None, accuracy_proxy)

    @classmethod
    def from_any(cls, obj) -> "SplitCandidate":
        """Coerce any legacy design-point representation.

        Accepts a :class:`SplitCandidate` (returned as-is), a
        ``core.split.SplitPlan``, a ``(label, split_layer)`` tuple (the
        planner's historical shape), a bare split layer ``int``, or a
        label string (``'RC'``, ``'LC'``, ``'SC@4'``).
        """
        if isinstance(obj, cls):
            return obj
        from repro_torch.core.split import SplitPlan
        if isinstance(obj, SplitPlan):
            return cls.sc(obj.splits, compression=obj.compression,
                          wire_dtype_bytes=obj.wire_dtype_bytes)
        if isinstance(obj, int):
            return cls.sc(obj)
        if isinstance(obj, str):
            kind, _, layer = obj.partition("@")
            if kind == "SC" and layer:
                return cls.sc(tuple(int(c) for c in layer.split("+")))
            if kind in ("RC", "LC") and not layer:
                return cls.rc() if kind == "RC" else cls.lc()
            raise ValueError(f"unparseable candidate label {obj!r}")
        if isinstance(obj, tuple):
            import numbers
            if obj and all(isinstance(c, numbers.Integral) for c in obj):
                return cls.sc(obj)               # a bare ordered cut list
            if len(obj) == 2:
                label, split = obj
                out = cls.from_any(label)
                if out.kind == "SC":
                    from repro_torch.core.split import normalize_cuts
                    if split is None or normalize_cuts(split) != out.splits:
                        raise ValueError(
                            f"label {label!r} disagrees with split {split!r}")
                return out
        raise TypeError(f"cannot interpret {type(obj).__name__} as a SplitCandidate")

    # ------------------------------------------------------------- views ----
    @property
    def kind(self) -> str:
        """'LC' | 'RC' | 'SC' (the scenario family, without the layer)."""
        return self.label.partition("@")[0]

    def plan(self):
        """The executable ``core.split.SplitPlan`` (SC only, else None)."""
        if self.kind != "SC":
            return None
        from repro_torch.core.split import SplitPlan
        return SplitPlan(self.split_layer, self.compression,
                         self.wire_dtype_bytes, splits=self.splits)

    def scenario(self, edge=None, server=None):
        """The ``core.scenarios.Scenario`` this candidate simulates as."""
        from repro_torch.core.scenarios import PLATFORMS, Scenario
        return Scenario(self.kind, self.plan(),
                        edge=edge or PLATFORMS["edge-embedded"],
                        server=server or PLATFORMS["server-gpu"])

    def validate(self, model) -> "SplitCandidate":
        """Legality-check the cut list against ``model`` (SC only; no-op
        for LC/RC).  Routes through ``core.split.validate_cuts`` — the
        single legality authority in the repo."""
        if self.kind == "SC":
            from repro_torch.core.split import validate_cuts
            validate_cuts(model, self.splits)
        return self

    def with_proxy(self, accuracy_proxy: float) -> "SplitCandidate":
        return replace(self, accuracy_proxy=accuracy_proxy)

    # ---------------------------------------------------- tuple protocol ----
    def _as_tuple(self) -> tuple:
        if len(self.splits) > 1:
            return (self.label, self.splits)
        return (self.label, self.split_layer)

    def __iter__(self):
        return iter(self._as_tuple())

    def __getitem__(self, i):
        return self._as_tuple()[i]

    def __eq__(self, other):
        # Design-point identity, shared with the legacy tuple shape.
        # Comparing annotations too (the pre-multi-tier behaviour) made
        # equality non-transitive with the tuple form, which broke
        # set/dict deduplication in the planner.
        if isinstance(other, SplitCandidate):
            return self._as_tuple() == other._as_tuple()
        if isinstance(other, tuple):
            return self._as_tuple() == other
        return NotImplemented

    def __hash__(self):
        return hash(self._as_tuple())


def legal_split_candidates(model, cs_curve=None,
                           layer_idx: Optional[Sequence[int]] = None) -> list:
    """Every legal SC cut of ``model`` as :class:`SplitCandidate`\\ s.

    Legality comes from ``core.split.legal_cuts`` /
    ``core.split.validate_cut`` — callers (the planner's default space,
    the Study facade) use this instead of re-deriving cut sets.  With a
    CS curve and its ``layer_idx``, candidates carry their accuracy
    proxy and only cuts the curve covers are returned.
    """
    from repro_torch.core.split import legal_cuts
    cuts = legal_cuts(model)
    if cs_curve is None:
        return [SplitCandidate.sc(c) for c in cuts]
    pos = {sp: i for i, sp in enumerate(layer_idx)}
    return [SplitCandidate.sc(c, float(cs_curve[pos[c]]))
            for c in cuts if c in pos]


def legal_cut_list_candidates(model, n_cuts: int, cs_curve=None,
                              layer_idx: Optional[Sequence[int]] = None,
                              pool: Optional[Sequence[int]] = None,
                              top_m: Optional[int] = None) -> list:
    """Every legal ``n_cuts``-way cut list of ``model`` as multi-cut
    :class:`SplitCandidate`\\ s — the K-way analogue of
    :func:`legal_split_candidates`.

    ``pool`` restricts the cuts considered (e.g. the CS-ranked shortlist);
    with a CS curve, a list's accuracy proxy is the *minimum* CS over its
    cuts (the weakest stage boundary bounds the chain) and only covered
    cuts are used.  ``top_m`` keeps the highest-proxy lists.
    """
    from repro_torch.core.split import legal_cut_lists
    pos = ({} if cs_curve is None
           else {sp: i for i, sp in enumerate(layer_idx)})
    keep = set(pool) if pool is not None else None
    covered = (lambda c: (keep is None or c in keep)
               and (cs_curve is None or c in pos))
    out = [SplitCandidate.sc(
        combo, min(float(cs_curve[pos[c]]) for c in combo)
        if cs_curve is not None else 0.0)
        for combo in legal_cut_lists(model, n_cuts)
        if all(covered(c) for c in combo)]
    out.sort(key=lambda c: -c.accuracy_proxy)
    return out[:top_m] if top_m else out


# ------------------------------------------------------------ cost layer ----
@runtime_checkable
class CostModel(Protocol):
    """What every cost source looks like to the simulators.

    ``flow_times(kind, split, batch)`` prices one frame-batch of a flow:
    a dict with ``edge_s`` / ``server_s`` / ``wire_bytes`` /
    ``cost_source`` keys, or ``None`` when this source cannot price the
    cell (callers fall through to the next source).  ``server_cost``
    yields the per-replica batched service-time model
    (``serving.engine.BatchCostModel``) for the server-side stage, or
    ``None``.  Implementations: :class:`AnalyticCost` (FLOPs model),
    ``runtime.calibrate.CalibrationTable`` (measured),
    :class:`CostStack` (composition).
    """
    batch: int

    def flow_times(self, kind: str, split: Optional[int] = None,
                   batch: Optional[int] = None) -> Optional[dict]: ...

    def server_cost(self, split: Optional[int], platform): ...


def scale_flow_times(times: dict, src_batch: int, batch: int) -> dict:
    """First-order rescale of a flow-times dict quoted at ``src_batch``
    to ``batch`` frames (linear model; re-measure at the serving batch
    for exact numbers)."""
    if not src_batch or src_batch == batch:
        return times
    s = batch / src_batch
    return {**times,
            "edge_s": times["edge_s"] * s,
            "server_s": times["server_s"] * s,
            "wire_bytes": int(round(times["wire_bytes"] * s))}


@dataclass
class AnalyticCost:
    """The FLOPs / effective-throughput cost model behind one interface.

    Wraps ``core.scenarios.scenario_times_and_payload`` (and
    ``serving.engine.BatchCostModel.for_split``) so the analytic path is
    a :class:`CostModel` like any other.  ``sample`` is an optional
    example input (array or pytree, e.g. a transformer batch dict) used
    to derive activation shapes and FLOPs for models whose
    ``input_shape`` alone cannot describe the input.
    """
    model: object
    params: object
    input_bytes: int
    edge: object = None              # PlatformProfile; defaults in __post_init__
    server: object = None
    batch: int = 1
    compression: float = 0.5
    wire_dtype_bytes: int = 4
    sample: object = None

    def __post_init__(self):
        from repro_torch.core.scenarios import PLATFORMS
        if self.edge is None:
            self.edge = PLATFORMS["edge-embedded"]
        if self.server is None:
            self.server = PLATFORMS["server-gpu"]

    def flow_times(self, kind: str, split: Optional[int] = None,
                   batch: Optional[int] = None) -> Optional[dict]:
        from repro_torch.core.scenarios import Scenario, scenario_times_and_payload
        from repro_torch.core.split import SplitPlan
        plan = (SplitPlan(split, self.compression, self.wire_dtype_bytes)
                if kind == "SC" else None)
        scenario = Scenario(kind, plan, edge=self.edge, server=self.server)
        times = dict(scenario_times_and_payload(
            scenario, self.model, self.params, input_bytes=self.input_bytes,
            batch=self.batch, sample=self.sample), cost_source="analytic")
        return scale_flow_times(times, self.batch,
                                self.batch if batch is None else batch)

    def server_cost(self, split: Optional[int], platform):
        from repro_torch.serving.engine import BatchCostModel
        return BatchCostModel.for_split(self.model, self.params, split,
                                        platform, sample=self.sample)


@dataclass
class CostStack:
    """First-match composition of :class:`CostModel` sources.

    ``CostStack([table, analytic])`` prices a cell from the calibration
    table when it covers it and falls back to the analytic model
    otherwise — the uniform selection rule the Study facade uses for
    ``simulate(...)`` after an optional ``calibrate()``.
    """
    sources: list

    @property
    def batch(self) -> int:
        return self.sources[0].batch if self.sources else 1

    def flow_times(self, kind: str, split: Optional[int] = None,
                   batch: Optional[int] = None) -> Optional[dict]:
        for src in self.sources:
            times = src.flow_times(kind, split, batch=batch)
            if times is not None:
                return times
        return None

    def server_cost(self, split: Optional[int], platform):
        for src in self.sources:
            cost = src.server_cost(split, platform)
            if cost is not None:
                return cost
        return None
