"""Batched serving engine: prefill + greedy decode over the zoo's
``serve_step``, and the per-replica service-time model of the server
stage (twin of ``repro/serving/engine.py``)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.tree import tree_leaves


@dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (S,) int32
    max_new: int = 16
    out: List[int] = field(default_factory=list)


@dataclass(frozen=True)
class BatchCostModel:
    """Analytic per-replica service-time model of the static-batch engine.

    One batch pays a fixed dispatch/prefill overhead, then per-item FLOPs at
    the platform's effective throughput — batching amortises the overhead,
    which is what a fleet's dynamic batching window exploits.
    """
    flops_per_item: float            # server-side FLOPs of one request
    flops_per_s: float               # replica effective throughput
    fixed_overhead_s: float = 2e-4   # dispatch + prefill per batch

    def service_time(self, batch_size: int) -> float:
        assert batch_size >= 1
        return (self.fixed_overhead_s
                + batch_size * self.flops_per_item / self.flops_per_s)

    def throughput(self, batch_size: int) -> float:
        """Requests/s one replica sustains at that batch size."""
        return batch_size / self.service_time(batch_size)

    @classmethod
    def for_split(cls, model, params, split_layer: Optional[int],
                  platform, *, fixed_overhead_s: float = 2e-4,
                  sample=None) -> "BatchCostModel":
        """Server-side cost of one request for a cut after ``split_layer``
        (``None`` = the server runs the whole model, i.e. scenario RC).

        ``sample``: example input (a tensor or a batch dict) for models whose
        ``input_shape`` cannot describe the input; FLOPs counted at its
        batch are normalised back to one request.
        """
        from repro_torch.core import stats as S
        n = 1
        if sample is not None:
            n = int(tree_leaves(sample)[0].shape[0])
        if split_layer is None:
            flops = S.total_flops(model, params, batch=1, sample=sample)
        else:
            _, flops = S.flops_split(model, params, split_layer, batch=1,
                                     sample=sample)
        return cls(float(flops) / n, platform.flops_per_s,
                   fixed_overhead_s=fixed_overhead_s)

    @classmethod
    def from_measured(cls, seconds_per_item: float, flops_per_s: float, *,
                      fixed_overhead_s: float = 2e-4) -> "BatchCostModel":
        """Cost model anchored to a *measured* per-item service time
        (hardware-in-the-loop: the wall clock of the executed tail stage,
        see ``repro_torch.runtime.calibrate``).  ``flops_per_item`` is
        back-derived so FLOPs-rate reporting stays meaningful."""
        assert seconds_per_item > 0
        return cls(seconds_per_item * flops_per_s, flops_per_s,
                   fixed_overhead_s=fixed_overhead_s)


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) -> (B, 1) int32: the first maximum, as ``jnp.argmax``."""
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]


class ServingEngine:
    """Static-batch engine: pad prompts, prefill once, decode greedily.

    ``params`` must lie on ``device``.  As in the reference, prompts are
    left-padded with token 0 and the pads are not masked.

    With a ``mesh`` (the reference's ``shard_fn=``; a ("data", "model")
    ``DeviceMesh``), every rank runs the engine on the same requests with
    ``params`` its blocks under ``rules.param_specs(..., profile=
    "inference")`` (``transformer.init_params(..., mesh=, profile=
    "inference")``): each data shard serves the rows ``batch_specs`` gives
    it, the decode cache is each rank's blocks, and every rank gets the
    whole logits, so every request comes back with its tokens, the same on
    every rank.
    """

    def __init__(self, cfg: ModelConfig, params, *, cache_slots: int = 256, device="cuda",
                 mesh=None):
        self.cfg, self.params = cfg, params
        self.cache_slots = cache_slots
        self.device = resolve_device(device)
        self.mesh = mesh

    def run(self, requests: List[Request]) -> List[Request]:
        cfg = self.cfg
        b = len(requests)
        max_prompt = max(len(r.prompt) for r in requests)
        # left-pad prompts so last token aligns (static batch)
        toks = np.zeros((b, max_prompt), np.int32)
        for i, r in enumerate(requests):
            toks[i, max_prompt - len(r.prompt):] = r.prompt
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        # the stub frontends' inputs, zeros in the config's dtype, as the
        # reference's engine feeds them
        if cfg.family == "vlm":
            batch["patch_embeds"] = torch.zeros((b, cfg.n_patches, cfg.d_frontend),
                                                dtype=cfg.tdtype, device=self.device)
        if cfg.family == "encdec":
            batch["frames"] = torch.zeros((b, cfg.n_frames, cfg.d_frontend),
                                          dtype=cfg.tdtype, device=self.device)
        with torch.inference_mode():
            logits, cache, pos = T.prefill(self.params, cfg, batch, self.cache_slots,
                                           mesh=self.mesh)
            max_new = max(r.max_new for r in requests)
            token = _greedy(logits)
            for step in range(max_new):
                host = token[:, 0].tolist()
                for i, r in enumerate(requests):
                    if step < r.max_new:
                        r.out.append(host[i])
                logits, cache = T.serve_step(self.params, cfg, cache, token, pos + step,
                                             mesh=self.mesh)
                token = _greedy(logits)
        return requests
