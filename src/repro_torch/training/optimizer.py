"""Adam and AdamW on nests of tensors (twin of
``repro/training/optimizer.py``).

Two flavours:
  * ``adam_*``  — the simple f32 Adam of the paper-core experiments
                  (VGG and bottleneck training, §V hyperparameters);
  * ``adamw_*`` — the mixed-precision trainer of the zoo: bf16 parameters,
                  moments in ``OptConfig.moment_dtype``, an optional f32
                  master copy, global-norm clipping and weight decay.

Parameters, gradients and states are nests (``repro_torch.tree``).
``adam_update`` returns new tensors and leaves its inputs as they were, as
the reference's pure functions do.  ``adamw_update`` writes its results into
the tensors it is given (see its docstring for why).  Both keep the
reference's order of operations: the bias corrections ``1 - b ** t`` with t
in f32, then ``m / bc1 / (sqrt(v / bc2) + eps)``, the step taken in f32 and
cast back to the parameter's dtype.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from repro_torch.tree import tree_leaves, tree_map


# ------------------------------------------------------------ simple Adam ----
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


# -------------------------------------------------- mixed-precision AdamW ----
@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    moment_dtype: str = "float32"      # "bfloat16" halves the moments' memory
    master_fp32: bool = False          # an f32 master copy of bf16 parameters
    grad_clip: Optional[float] = 1.0


def adamw_init(params, cfg: OptConfig) -> dict:
    md = getattr(torch, cfg.moment_dtype)
    st = {"m": tree_map(lambda p: torch.zeros_like(p, dtype=md), params),
          "v": tree_map(lambda p: torch.zeros_like(p, dtype=md), params),
          "t": torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)}
    if cfg.master_fp32:
        st["master"] = tree_map(lambda p: p.float(), params)
    return st


def global_norm(tree, *, counted=None, reduce=None) -> torch.Tensor:
    """sqrt of the sum over the leaves of each leaf's f32 sum of squares.

    For a tree of blocks sharded over ranks: ``counted`` (a nest of bools
    like ``tree``) keeps the leaves this rank counts, so that a block that
    several ranks hold is counted once, and ``reduce`` sums the 0-d total
    over the ranks before the root is taken."""
    leaves = tree_leaves(tree)
    keep = [True] * len(leaves) if counted is None else tree_leaves(counted)
    total = sum((torch.sum(torch.square(x.float())) for x, k in zip(leaves, keep) if k),
                torch.zeros((), dtype=torch.float32, device=leaves[0].device))
    return torch.sqrt(total if reduce is None else reduce(total))


# elements of a leaf's slice that adamw_update takes at a time: its f32
# temporaries stay a few times 256 MB, where a whole stacked leaf (llama3.2-3b's
# 28 layers of w_gate, 0.7 G elements) would take several GB each
ADAMW_CHUNK = 1 << 26


def _chunks(t: torch.Tensor) -> tuple:
    """Views of ``t`` along its first axis of at most ADAMW_CHUNK elements
    each (``t`` itself where it is smaller or 0-d)."""
    if t.dim() == 0 or t.numel() <= ADAMW_CHUNK:
        return (t,)
    rows = max(1, ADAMW_CHUNK // (t.numel() // t.shape[0]))
    return t.split(rows)


@torch.no_grad()
def adamw_update(params, grads, state, cfg: OptConfig, *, norm=None) -> tuple:
    """One AdamW step, in place: ``state["m"]``, ``state["v"]``, ``state["t"]``,
    ``state["master"]`` (with ``master_fp32``) and ``params`` are written
    leaf by leaf, and ``(params, state)`` returned.  ``grads`` is read only.
    ``norm``: the gradients' global norm for the clip, where ``grads`` are
    one rank's blocks of them (:func:`global_norm`'s ``counted`` and
    ``reduce``); ``global_norm(grads)`` where ``None``.

    The reference's ``adamw_update`` is pure: it builds new moment trees and a
    whole f32 master tree while the old ones are still referenced.  Copied
    literally, llama3.2-3b's step would hold some 87 GB (old and new f32
    moments, 28.9 GB each, 14.4 GB of f32 master, parameters and gradients),
    more than one card has; in place, leaf by leaf as ``torch.optim`` does,
    it holds the 43.3 GB train state and the f32 temporaries of one slice of
    a leaf (``ADAMW_CHUNK`` elements; the update is elementwise, so slicing
    changes no value).

    The arithmetic and its order are the reference's: the clip scale
    ``min(1, clip / (norm + 1e-9))`` cast to each gradient's dtype; the
    moments in f32, cast to ``moment_dtype``; the bias corrections with t in
    f32; weight decay (of the master copy where there is one) added to the
    update; the step from the f32 master copy where there is one, else from
    the parameter in f32.
    """
    scale = None
    if cfg.grad_clip is not None:
        gn = global_norm(grads) if norm is None else norm
        scale = torch.clamp(cfg.grad_clip / (gn + 1e-9), max=1.0)
    state["t"].add_(1)
    tf = state["t"].float()
    bc1, bc2 = 1 - cfg.b1 ** tf, 1 - cfg.b2 ** tf
    masters = tree_leaves(state["master"]) if cfg.master_fp32 else None
    leaves = zip(tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
                 tree_leaves(state["v"]))
    for i, leaf in enumerate(leaves):
        src = masters[i] if masters is not None else leaf[0]
        for p, g, m, v, w in zip(*map(_chunks, leaf + (src,))):
            if scale is not None:
                g = g * scale.to(g.dtype)
            g32 = g.float()
            m.copy_(cfg.b1 * m.float() + (1 - cfg.b1) * g32)
            v.copy_(cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(g32))
            del g, g32
            # the update from the moments as stored (in moment_dtype)
            u = (m.float() / bc1) / (torch.sqrt(v.float() / bc2) + cfg.eps)
            if cfg.weight_decay:
                u = u + cfg.weight_decay * w.float()
            new = w.float() - cfg.lr * u
            del u
            if masters is not None:
                w.copy_(new)
            p.copy_(new)
    return params, state
