"""Train-step factory for the zoo (twin of ``repro/training/train.py``):
loss -> gradients -> AdamW, on one device or sharded over a mesh.

The reference shards its step by handing ``jax.jit`` parameters placed by
``sharding.rules.param_specs`` and a ``shard_fn``; the port's step on a
mesh keeps each rank's blocks of the parameters and of AdamW's state
(``sharding.blocks``), gathers each group's weights as it runs
(``loss_fn``'s ``gather``) and reduces the gradients back to the blocks.
"""
from __future__ import annotations

import math

import torch

from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig
from repro_torch.sharding import blocks
from repro_torch.sharding import rules as R
from repro_torch.training.optimizer import (OptConfig, adamw_init, adamw_update,
                                            global_norm)
from repro_torch.tree import tree_leaves, tree_map


def _loss_and_grads(params, cfg, batch, weight=1.0, gather=None) -> tuple:
    """``(loss * weight, metrics, gradients)``: :func:`transformer.loss_fn`
    and its gradient over every leaf by ``torch.autograd.grad`` (zeros for
    a leaf the loss does not reach)."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        live = [p.detach().requires_grad_() for p in leaves]
        it = iter(live)
        loss, metrics = T.loss_fn(tree_map(lambda _: next(it), params), cfg, batch,
                                  gather=gather)
        if weight != 1.0:
            loss = loss * weight
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    del live
    it = iter([torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)])
    del grads
    return loss.detach(), metrics, tree_map(lambda _: next(it), params)


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig, *, mesh=None):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: :func:`transformer.loss_fn`, its gradient over every
    parameter leaf, then :func:`adamw_update`, which writes the parameters
    and the state in place and returns them.  ``metrics`` holds ``ce``,
    ``aux`` and ``loss`` as 0-d tensors.

    With a ``mesh`` (a ``DeviceMesh``; every rank calls the step with the
    whole batch): ``params`` and the state are this rank's blocks by
    ``rules.param_specs(..., profile="train")`` (:func:`init_train_state`),
    and the metrics are the global ones (:func:`_sharded_step`)."""
    if mesh is not None:
        return _sharded_step(cfg, opt_cfg, mesh)

    def train_step(params, opt_state, batch):
        loss, metrics, grads = _loss_and_grads(params, cfg, batch)
        params, opt_state = adamw_update(params, grads, opt_state, opt_cfg)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, opt_state, dict(metrics, loss=loss)

    return train_step


def local_rows(batch_size: int, mesh) -> tuple:
    """``(start, stop, copies)``: the batch rows this rank computes and how
    many ranks compute them.  Rows go over ("pod", "data") as
    ``rules.batch_specs`` places them (every rank takes them all where
    they do not divide), then, within a data shard, over "model" where
    they divide."""
    sizes, coords = R.mesh_axis_sizes(mesh), blocks.coordinates(mesh)
    entry = R.batch_specs({"rows": torch.empty((batch_size,), device="meta")}, mesh)["rows"][0]
    idx, n = blocks.block_index(entry, coords, sizes)
    rows = batch_size // n
    start = idx * rows
    model = sizes.get("model", 1)
    if model > 1 and rows % model == 0:
        rows //= model
        start += coords["model"] * rows
    return start, start + rows, math.prod(R.mesh_axes(mesh)[1]) * rows // batch_size


def _sharded_step(cfg: ModelConfig, opt_cfg: OptConfig, mesh):
    """The step on ``mesh``.  Each rank runs ``loss_fn`` on its rows
    (:func:`local_rows`) with every weight gathered as it is used
    (``blocks.Gather``), its loss scaled by rows / (B * copies) so that the
    ranks' losses sum to the mean over the whole batch and every labelled
    token counts once; the gradients come back summed over every rank into
    the blocks (``blocks.GatherBlocks``), the clip's norm is summed over the
    mesh with each block counted once, and AdamW updates the blocks.  The
    returned ``loss``, ``ce`` and ``aux`` are the global ones, all-reduced."""
    if cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: an MoE config under a mesh (ROADMAP A14b2): its aux loss is "
            "bilinear in batch-wide means, so a step that splits rows over ranks must "
            "all-reduce the two E-vectors in every MoE layer, which is not ported yet")
    specs = R.param_specs(T.param_spec(cfg), mesh, profile="train")
    gather = blocks.Gather(specs, mesh)
    counted = tree_map(lambda s: blocks.owns(s, mesh), specs)

    def reduce(total):
        return blocks.all_reduce(total)

    def train_step(params, opt_state, batch):
        b = batch["tokens"].shape[0]
        lo, hi, copies = local_rows(b, mesh)
        weight = (hi - lo) / (b * copies)
        local = {k: v[lo:hi] for k, v in batch.items()}
        loss, metrics, grads = _loss_and_grads(params, cfg, local, weight, gather)
        norm = (global_norm(grads, counted=counted, reduce=reduce)
                if opt_cfg.grad_clip is not None else None)
        params, opt_state = adamw_update(params, grads, opt_state, opt_cfg, norm=norm)
        del grads
        sums = blocks.all_reduce(torch.stack([loss, metrics["ce"].detach() * weight,
                                              metrics["aux"].detach() * weight]))
        return params, opt_state, {"ce": sums[1], "aux": sums[2], "loss": sums[0]}

    return train_step


def init_train_state(seed: int, cfg: ModelConfig, opt_cfg: OptConfig, *,
                     device="cuda", mesh=None) -> tuple:
    """``(params, opt_state)``: :func:`transformer.init_params` from ``seed``
    on ``device``, and its :func:`adamw_init` state.  With a ``mesh`` every
    rank draws the tree from the same seed block by block and keeps its
    blocks (``init_params(..., mesh=)``), so the sharded state is the
    unsharded one cut up, and no rank holds the whole tree."""
    params = T.init_params(seed, cfg, device=device, mesh=mesh, profile="train")
    return params, adamw_init(params, opt_cfg)


def train_state_struct(cfg: ModelConfig, opt_cfg: OptConfig) -> tuple:
    """The abstract (no-allocation) train state, as ``meta`` tensors."""
    params = T.param_spec(cfg)
    return params, adamw_init(params, opt_cfg)
