"""Train-step factory for the zoo (twin of ``repro/training/train.py``):
loss -> gradients -> AdamW.

The reference's ``shard_fn`` (sharding annotations) has no twin until the
port shards a step over several cards by its sharding rules (ROADMAP A14b);
``launch/train.py`` drives this step on one device.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.training.optimizer import OptConfig, adamw_init, adamw_update
from repro_torch.tree import tree_leaves, tree_map


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: :func:`transformer.loss_fn`, its gradient over every
    parameter leaf by ``torch.autograd.grad``, then :func:`adamw_update`,
    which writes the parameters and the state in place and returns them.
    ``metrics`` holds ``ce``, ``aux`` and ``loss`` as 0-d tensors."""

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        with torch.enable_grad():
            live = [p.detach().requires_grad_() for p in leaves]
            it = iter(live)
            loss, metrics = T.loss_fn(tree_map(lambda _: next(it), params), cfg, batch)
            grads = torch.autograd.grad(loss, live, allow_unused=True)
        del live
        it = iter([torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)])
        del grads
        params, opt_state = adamw_update(params, tree_map(lambda _: next(it), params),
                                         opt_state, opt_cfg)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, dict(metrics, loss=loss.detach())

    return train_step


def init_train_state(seed: int, cfg: ModelConfig, opt_cfg: OptConfig, *,
                     device="cuda") -> tuple:
    """``(params, opt_state)``: :func:`transformer.init_params` from ``seed``
    on ``device``, and its :func:`adamw_init` state."""
    params = T.init_params(seed, cfg, device=device)
    return params, adamw_init(params, opt_cfg)


def train_state_struct(cfg: ModelConfig, opt_cfg: OptConfig) -> tuple:
    """The abstract (no-allocation) train state, as ``meta`` tensors."""
    params = T.param_spec(cfg)
    return params, adamw_init(params, opt_cfg)
