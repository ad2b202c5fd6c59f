"""Adam on nests of tensors (twin of ``repro/training/optimizer.py:21-40``,
the simple f32 Adam of the paper-core experiments; the mixed-precision
``AdamW`` of zoo training waits for ROADMAP A17).

Parameters, gradients and states are nests (``repro_torch.tree``).  Updates
return new tensors and leave their inputs as they were, as
the reference's pure functions do, and keep its order of operations: the
bias corrections ``1 - b ** t`` with t in f32, then ``m / bc1 / (sqrt(v /
bc2) + eps)``, the step taken in f32 and cast back to the parameter's dtype.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map


def adam_init(params) -> dict:
    z = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
    return {"m": tree_map(z, params), "v": tree_map(z, params),
            "t": torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)}


@torch.no_grad()
def adam_update(params, grads, state, lr, b1=0.9, b2=0.999, eps=1e-8) -> tuple:
    t = state["t"] + 1
    m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state["m"], grads)
    v = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(g.float()),
                 state["v"], grads)
    bc1 = 1 - b1 ** t.float()
    bc2 = 1 - b2 ** t.float()
    upd = tree_map(lambda m, v: m / bc1 / (torch.sqrt(v / bc2) + eps), m, v)
    params = tree_map(lambda p, u: (p.float() - lr * u).to(p.dtype), params, upd)
    return params, {"m": m, "v": v, "t": t}
