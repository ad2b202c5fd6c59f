"""Measured calibration: run the split runtime over a (config, split)
grid and emit cost tables the simulators consume (twin of
``repro/runtime/calibrate.py``).

The analytic models in ``core.scenarios`` (FLOPs / effective throughput)
are guesses; this module replaces them with *measurements* taken by
executing the real head/tail stages and the real wire codec on the
attached card — the paper §IV hardware-in-the-loop methodology (see
``core.scenarios.HILPlatform``), extended to a whole grid of cuts.  At a
cut with an AE the codec is the ``bottleneck_compress`` and
``bottleneck_decompress`` kernels.

The table implements the :class:`repro_torch.api.types.CostModel`
protocol: ``netsim.simulator.measure_flow(..., cost=table)`` looks entries
up by ``(scenario kind, split layer)`` and falls back to the analytic model
for cells the grid didn't cover.  Its JSON is the reference's, key for key,
so either package reads the other's tables.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.split import validate_cut
from repro_torch.device import resolve_device
from repro_torch.runtime import wire as W
from repro_torch.runtime.engine import timeit_blocked
from repro_torch.runtime.partition import make_partition
from repro_torch.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class CalEntry:
    """Measured costs of one (scenario kind, split) cell.

    Times and bytes are for one forward of the *calibration batch*
    (``CalibrationTable.batch`` frames); consumers that need a different
    batch size scale linearly (``measure_flow`` does this) or divide by
    the table batch for per-frame costs (the planner does).
    """
    head_s: float                    # edge-side stage compute
    tail_s: float                    # server-side stage compute
    wire_bytes: int                  # actual serialized payload size
    encode_s: float = 0.0            # edge-side codec
    decode_s: float = 0.0            # server-side codec
    fused_edge_s: float = 0.0        # fused seg0 + framing (calibrate(fused=True))
    fused_server_s: float = 0.0      # parse + fused decode/tail segment
    use_fused: bool = False          # quote fused costs from edge_s/server_s

    @property
    def edge_s(self) -> float:
        """Edge wall clock as the planner prices it: the fused-boundary
        measurement when ``use_fused`` (one fused leg + framing), else
        head compute + eager codec."""
        if self.use_fused:
            return self.fused_edge_s
        return self.head_s + self.encode_s

    @property
    def server_s(self) -> float:
        if self.use_fused:
            return self.fused_server_s
        return self.decode_s + self.tail_s


@dataclass
class CalibrationTable:
    """(kind, split) -> :class:`CalEntry`, JSON-serialisable."""
    model_name: str
    batch: int
    entries: dict = field(default_factory=dict)
    meta: dict = field(default_factory=dict)

    @staticmethod
    def key(kind: str, split: Optional[int]) -> str:
        return kind if split is None else f"{kind}@{split}"

    def put(self, kind: str, split: Optional[int], entry: CalEntry):
        self.entries[self.key(kind, split)] = entry

    def lookup(self, kind: str, split: Optional[int] = None) -> Optional[CalEntry]:
        return self.entries.get(self.key(kind, split))

    def flow_times(self, kind: str, split: Optional[int] = None,
                   batch: Optional[int] = None) -> Optional[dict]:
        """The measured replacement for
        ``core.scenarios.scenario_times_and_payload`` — same keys, plus the
        provenance marker.  None when the cell wasn't calibrated.

        With ``batch``, times quoted at the table's calibration batch are
        rescaled linearly to ``batch`` frames (first-order model;
        re-calibrate at the serving batch for exact numbers).  This is
        the :class:`repro_torch.api.types.CostModel` flow interface.
        """
        e = self.lookup(kind, split)
        if e is None:
            return None
        if kind == "LC":
            times = {"edge_s": e.head_s, "server_s": 0.0, "wire_bytes": 0,
                     "cost_source": "measured"}
        elif kind == "RC":
            times = {"edge_s": 0.0, "server_s": e.tail_s,
                     "wire_bytes": e.wire_bytes, "cost_source": "measured"}
        else:
            times = {"edge_s": e.edge_s, "server_s": e.server_s,
                     "wire_bytes": e.wire_bytes, "cost_source": "measured"}
        if batch is not None:
            from repro_torch.api.types import scale_flow_times
            times = scale_flow_times(times, self.batch or batch, batch)
        return times

    def server_cost(self, split: Optional[int], platform):
        """Measured per-replica service-time model of the server stage
        (the :class:`repro_torch.api.types.CostModel` server interface): the
        wall clock of the executed tail stage, normalised to one request.
        None when the cell wasn't calibrated.
        """
        from repro_torch.serving.engine import BatchCostModel
        entry = self.lookup("SC" if split is not None else "RC", split)
        if entry is None:
            return None
        per_item = entry.server_s / max(1, self.batch)
        return BatchCostModel.from_measured(per_item, platform.flops_per_s)

    def splits(self) -> list:
        return sorted(int(k.split("@")[1]) for k in self.entries
                      if "@" in k)

    # -------------------------------------------------------- persistence ----
    def to_json(self, path: str):
        doc = {"model_name": self.model_name, "batch": self.batch,
               "meta": self.meta,
               "entries": {k: asdict(e) for k, e in self.entries.items()}}
        with open(path, "w") as fh:
            json.dump(doc, fh, indent=1)

    @classmethod
    def from_json(cls, path: str) -> "CalibrationTable":
        with open(path) as fh:
            doc = json.load(fh)
        t = cls(doc["model_name"], doc["batch"], meta=doc.get("meta", {}))
        for k, e in doc["entries"].items():
            t.entries[k] = CalEntry(**e)
        return t


def calibrate(model, params, splits: Sequence[int], *,
              ae_map: Optional[dict] = None, batch: int = 1,
              x=None, iters: int = 3,
              quantize: bool = True, include_rc: bool = True,
              include_lc: bool = True, fused: bool = False,
              seed: int = 0, device="cuda") -> CalibrationTable:
    """Measure per-stage compute and wire payload over a split grid.

    Runs on ``device`` (HIL: the measured hardware stands in for both edge
    and server — scale or re-measure per platform for heterogeneous
    deployments); ``params`` and the AEs must lie there.  ``ae_map``:
    split -> trained bottleneck AE; splits without an entry ship the raw
    int8 activation.  Each time is the min over ``iters`` fenced calls
    after a warm-up (``runtime.engine.timeit_blocked``).

    ``fused=True`` additionally measures the fused-boundary execution
    (``Partition.fused_segments``: the codec inside the stage segments,
    only framing/parse on the host) and marks the entries ``use_fused``,
    so ``edge_s``/``server_s`` — and every simulator consuming this table
    through the CostModel protocol — price the fused runtime.  The eager
    per-component times are always kept alongside.

    ``x`` may be any input nest the model consumes (numpy or tensors; a
    transformer layered view takes a batch dict); the calibration batch is
    its leading dim.  Without it, ``batch`` standard-normal images are
    drawn from ``numpy.random.default_rng(seed)``, as the reference draws
    them.
    """
    dev = resolve_device(device)
    ae_map = dict(ae_map or {})
    if x is None:
        rng = np.random.default_rng(seed)
        x = rng.standard_normal((batch,) + tuple(model.input_shape)
                                ).astype(np.float32)
    x = tree_map(lambda a: torch.as_tensor(a, device=dev), x)
    leaves = tree_leaves(x)
    batch = int(leaves[0].shape[0])  # the table's batch is x's, always
    table = CalibrationTable(model.name, batch,
                             meta={"iters": iters, "quantize": quantize,
                                   "fused": fused,
                                   "n_splits": len(splits)})

    with torch.inference_mode():
        full_s, _ = timeit_blocked(lambda v: model.apply(params, v), x,
                                   iters=iters)
        if include_lc:
            table.put("LC", None, CalEntry(full_s, 0.0, 0))
        if include_rc:
            input_bytes = sum(leaf.numel() * leaf.element_size()
                              for leaf in leaves)
            table.put("RC", None, CalEntry(0.0, full_s, input_bytes))

        for split in splits:
            validate_cut(model, split)
            ae = ae_map.get(split)
            part = make_partition(model, params, split, ae, device=dev)
            head_s, f = timeit_blocked(part.head, x, iters=iters)
            enc_s, pkt = timeit_blocked(
                lambda v: W.encode_activation(v, ae, quantize=quantize), f,
                iters=iters, warmup=1)
            buf = W.to_bytes(pkt)
            dec_s, f_hat = timeit_blocked(
                lambda b: W.decode_activation(W.from_bytes(b), ae, device=dev),
                buf, iters=iters, warmup=1)
            tail_s, _ = timeit_blocked(part.tail, f_hat, iters=iters)
            extra = {}
            if fused:
                segs = part.fused_segments(quantize=quantize)
                kind = part.wire_kinds(quantize)[0]
                seg0_s, out = timeit_blocked(segs[0], x, iters=iters)
                frame_s, fbuf = timeit_blocked(
                    lambda d, s: W.frame_arrays(kind, d, s), out[0], out[1],
                    iters=iters)
                # the server leg parses per call: parse + decode + tail is
                # one measurement, the wall clock a fused server spends per
                # request
                leg_s, _ = timeit_blocked(
                    lambda b: segs[1](W.parse_arrays(b, device=dev)), fbuf,
                    iters=iters)
                if len(fbuf) != len(buf):
                    raise AssertionError(
                        f"fused wire framing diverged from eager at split "
                        f"{split}: {len(fbuf)} vs {len(buf)} bytes")
                extra = {"fused_edge_s": seg0_s + frame_s,
                         "fused_server_s": leg_s, "use_fused": True}
            table.put("SC", split,
                      CalEntry(head_s, tail_s, len(buf), enc_s, dec_s, **extra))
    return table
