"""Batched serving engine: prefill + greedy decode over the zoo's
``serve_step`` (twin of ``repro/serving/engine.py:20-121``; its
``BatchCostModel`` waits for ROADMAP A10)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig


@dataclass
class Request:
    rid: int
    prompt: np.ndarray               # (S,) int32
    max_new: int = 16
    out: List[int] = field(default_factory=list)


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, V) -> (B, 1) int32: the first maximum, as ``jnp.argmax``."""
    return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]


class ServingEngine:
    """Static-batch engine: pad prompts, prefill once, decode greedily.

    ``params`` must lie on ``device``.  As in the reference, prompts are
    left-padded with token 0 and the pads are not masked.
    """

    def __init__(self, cfg: ModelConfig, params, *, cache_slots: int = 256, device="cuda"):
        self.cfg, self.params = cfg, params
        self.cache_slots = cache_slots
        self.device = resolve_device(device)

    def run(self, requests: List[Request]) -> List[Request]:
        cfg = self.cfg
        b = len(requests)
        max_prompt = max(len(r.prompt) for r in requests)
        # left-pad prompts so last token aligns (static batch)
        toks = np.zeros((b, max_prompt), np.int32)
        for i, r in enumerate(requests):
            toks[i, max_prompt - len(r.prompt):] = r.prompt
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        with torch.inference_mode():
            logits, cache, pos = T.prefill(self.params, cfg, batch, self.cache_slots)
            max_new = max(r.max_new for r in requests)
            token = _greedy(logits)
            for step in range(max_new):
                host = token[:, 0].tolist()
                for i, r in enumerate(requests):
                    if step < r.max_new:
                        r.out.append(host[i])
                logits, cache = T.serve_step(self.params, cfg, cache, token, pos + step)
                token = _greedy(logits)
        return requests
