"""``LayeredModel``: the per-layer view of a network that split computing
operates on (twin of ``repro/models/layered.py``).

Parameters are a list with one dict of tensors per layer, as the JAX
package's pytree is.  Activations at layer boundaries keep the reference's
layout (NHWC for VGG), so wire frames match it byte for byte.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import tree_leaves


@dataclass
class Layer:
    name: str
    kind: str                       # 'conv' | 'relu' | 'pool' | 'linear' | ...
    init: Callable[[torch.Generator, torch.device], dict]
    apply: Callable[[Any, torch.Tensor], torch.Tensor]
    splittable: bool = True         # is a cut *after* this layer legal?
    # optional mult-add counter ``(params, in_shape, out_shape) -> int`` for
    # layers whose cost the conv/linear rules in ``core.stats`` cannot see
    # (transformer blocks close over their params)
    mult_adds: Callable[[Any, tuple, tuple], int] = None


@dataclass
class LayeredModel:
    name: str
    layers: List[Layer]
    input_shape: tuple              # without batch dim
    n_classes: int

    def init(self, seed: int = 0, *, device="cuda") -> list:
        """Random parameters from a ``torch.Generator`` seeded with ``seed``,
        made on ``device``."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        return [l.init(gen, dev) for l in self.layers]

    def apply(self, params: list, x: torch.Tensor) -> torch.Tensor:
        return self.apply_range(params, x, 0, len(self.layers))

    def apply_capture(self, params: list, x: torch.Tensor) -> tuple:
        """Returns (logits, [activation after each layer])."""
        acts = []
        for l, p in zip(self.layers, params):
            x = l.apply(p, x)
            acts.append(x)
        return x, acts

    def apply_with_taps(self, params: list, x, taps: list) -> torch.Tensor:
        """Forward where ``taps[i]`` is added to layer i's output.

        Differentiating w.r.t. zero taps yields d(output)/d(activation_i) for
        every layer in one backward pass (the saliency trick).
        """
        for l, p, t in zip(self.layers, params, taps):
            x = l.apply(p, x) + t
        return x

    def apply_range(self, params: list, x: torch.Tensor, start: int,
                    stop: int) -> torch.Tensor:
        """Run layers [start, stop)."""
        for l, p in zip(self.layers[start:stop], params[start:stop]):
            x = l.apply(p, x)
        return x

    def cut_points(self) -> list[int]:
        """Indices i such that a cut after layer i is legal."""
        return [i for i, l in enumerate(self.layers)
                if l.splittable and i < len(self.layers) - 1]

    def activation_shapes(self, params: list, batch: int = 1, *,
                          sample=None) -> list[tuple]:
        """Per-layer output shapes (leading ``batch`` dim included).

        Without ``sample`` they come from a forward on the ``meta`` device:
        no memory and no arithmetic.  ``sample`` is an example input (a
        tensor or a batch dict) for models whose ``input_shape`` cannot
        describe it; its own leading dim wins over ``batch``, and the forward
        runs for real where it lies (a transformer view's blocks close over
        real parameters, which ``meta`` cannot stand in for).
        """
        if sample is not None:
            with torch.no_grad():
                _, acts = self.apply_capture(params, sample)
            return [tuple(a.shape) for a in acts]
        meta = [{k: torch.empty_like(v, device="meta") for k, v in p.items()}
                for p in params]
        x = torch.empty((batch,) + tuple(self.input_shape), device="meta")
        _, acts = self.apply_capture(meta, x)
        return [tuple(a.shape) for a in acts]


def transformer_as_layered(cfg, params) -> LayeredModel:
    """Per-block LayeredModel view of a zoo model (twin of
    ``repro/models/layered.py:93``), for splitting it.

    Cuts are legal only at block boundaries: never inside a recurrence or
    an attention op.  Layer 0 is the embedding (its input is the batch
    dict; a VLM's patches go before the tokens); the final norm and the
    head are the last layer, which is not a legal cut (a cut there is
    RC-equivalent).  The layers close over ``params``; their own parameter
    entries are empty.  As in the reference (``layered.py:119-122``), the
    blocks get no encoder output: a whisper view skips the encoder and
    every cross-attention.
    """
    from repro_torch.models import transformer as T

    descs, n_groups = T.block_structure(cfg)
    layers = [Layer(name="embed", kind="embed", init=lambda gen, dev: {},
                    apply=lambda p, batch: T.embed_inputs(params, cfg, batch)[0],
                    mult_adds=lambda p, ish, osh: 0)]     # table lookup, no matmul

    def make_block(g, j, desc):
        lp = T._group(params["layers"], g)[f"l{j}"]
        # matmul cost per token ~ the block's weight count (x @ W costs
        # prod(W.shape) mult-adds per token for every 2-D weight)
        w_elems = sum(t.numel() for t in tree_leaves(lp) if t.dim() >= 2)

        def apply(p, x):
            positions = torch.arange(x.shape[1], device=x.device)
            y, _, _ = T.apply_layer_seq(lp, desc, x, cfg, positions, causal=True,
                                        window=cfg.sliding_window)
            return y
        return Layer(name=f"block{g * len(descs) + j}", kind="block",
                     init=lambda gen, dev: {}, apply=apply,
                     mult_adds=lambda p, ish, osh: w_elems * osh[0] * osh[1])

    for g in range(n_groups):
        for j, desc in enumerate(descs):
            layers.append(make_block(g, j, desc))

    def head_apply(p, x):
        return T.logits_from_x(params, cfg, T._apply_norm(params["final_norm"], x, cfg))

    layers.append(Layer(name="head", kind="head", init=lambda gen, dev: {},
                        apply=head_apply, splittable=False,
                        mult_adds=lambda p, ish, osh:
                            cfg.d_model * int(np.prod(osh[:-1])) * osh[-1]))
    return LayeredModel(name=cfg.name, layers=layers, input_shape=(), n_classes=cfg.vocab)
