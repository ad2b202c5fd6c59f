"""Neural-network statistics reports (paper §V-D, Tables I and II; twin of
``repro/core/stats.py``).

Per-layer summary (type, output shape, #params) and model totals (total /
trainable params, total mult-adds, forward/backward pass size, estimated
total size): the torchinfo-style report the paper prints for VGG16.
Shapes come from ``LayeredModel.activation_shapes``, a forward on the
``meta`` device (or on ``sample`` where it lies), in place of the
reference's ``jax.eval_shape``.  Conv weights are OIHW here, HWIO there.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.models.layered import LayeredModel
from repro_torch.tree import tree_leaves


@dataclass
class LayerRow:
    name: str
    kind: str
    output_shape: tuple
    n_params: int
    mult_adds: int


def _layer_mult_adds(layer, p, in_shape, out_shape) -> int:
    if layer.mult_adds is not None:      # layer-provided counter wins
        return int(layer.mult_adds(p, in_shape, out_shape))
    if layer.kind == "conv":
        cout, cin, kh, kw = p["w"].shape
        b, h, w, _ = out_shape
        return b * h * w * kh * kw * cin * cout
    if layer.kind == "linear":
        fin, fout = p["w"].shape
        return int(np.prod(out_shape[:-1])) * fin * fout
    return 0


def _shape_sig(tree) -> tuple:
    """Leaf-shape signature of a nest: what ``summary`` depends on (values
    never matter)."""
    if tree is None:
        return None
    return tuple(tuple(leaf.shape) for leaf in tree_leaves(tree))


def summary(model: LayeredModel, params, batch: int = 16, *,
            sample=None) -> list:
    """Table I: one row per layer.

    ``sample``: example input (a tensor or a batch dict) for models whose
    ``input_shape`` alone cannot describe the input (transformer layered
    views consume a batch dict); its leading dim wins over ``batch``.

    Rows are cached on the model instance per (param shapes, batch, sample
    shapes) key, so treat the returned list as read-only.
    """
    cache = None
    if hasattr(model, "__dict__"):
        cache = model.__dict__.setdefault("_summary_cache", {})
        # batch is shadowed by the sample's own leading dim when given
        key = (_shape_sig(params), None if sample is not None else batch,
               _shape_sig(sample))
        if key in cache:
            return cache[key]
    shapes = model.activation_shapes(params, batch, sample=sample)
    rows = []
    in_shape = None if sample is not None else (batch,) + tuple(model.input_shape)
    for l, p, shape in zip(model.layers, params, shapes):
        n = sum(int(np.prod(leaf.shape)) for leaf in tree_leaves(p))
        rows.append(LayerRow(l.name, l.kind, tuple(shape), n,
                             _layer_mult_adds(l, p, in_shape, shape)))
        in_shape = shape
    if cache is not None:
        cache[key] = rows
    return rows


def totals(model: LayeredModel, params, batch: int = 16,
           param_bytes: int = 4, act_bytes: int = 4) -> dict:
    """Table II: aggregate statistics (torchinfo conventions)."""
    rows = summary(model, params, batch)
    n_params = sum(r.n_params for r in rows)
    mult_adds = sum(r.mult_adds for r in rows)
    # forward/backward pass size, torchinfo convention (sum of layer output
    # bytes)
    fwd_bwd = sum(int(np.prod(r.output_shape)) for r in rows) * act_bytes
    input_size = batch * int(np.prod(model.input_shape)) * act_bytes
    return {
        "total_params": n_params,
        "trainable_params": n_params,
        "mult_adds_G": mult_adds / 1e9,
        "fwd_bwd_MB": fwd_bwd / 2 ** 20,
        "input_MB": input_size / 2 ** 20,
        "params_MB": n_params * param_bytes / 2 ** 20,
        "total_MB": (fwd_bwd + input_size + n_params * param_bytes) / 2 ** 20,
    }


def total_flops(model: LayeredModel, params, batch: int = 1, *,
                sample=None) -> float:
    """Whole-model forward FLOPs (2x mult-adds)."""
    return sum(r.mult_adds
               for r in summary(model, params, batch, sample=sample)) * 2


def flops_split(model: LayeredModel, params, split_layer: int,
                batch: int = 1, *, sample=None) -> tuple:
    """(head_flops, tail_flops) for a cut after ``split_layer`` (2x mult-adds)."""
    head, tail = flops_stages(model, params, (split_layer,), batch,
                              sample=sample)
    return head, tail


def flops_prefix(model: LayeredModel, params, batch: int = 1, *,
                 sample=None) -> np.ndarray:
    """Cumulative forward FLOPs (2x mult-adds) at every layer boundary:
    entry ``i`` is the cost of layers ``[0, i)``, so any stage of any cut
    list prices as one subtraction."""
    rows = summary(model, params, batch, sample=sample)
    return np.concatenate(
        ([0.0], np.cumsum([2.0 * r.mult_adds for r in rows])))


def flops_stages(model: LayeredModel, params, cuts, batch: int = 1, *,
                 sample=None) -> list:
    """Per-stage forward FLOPs for an ordered cut list (2x mult-adds).

    ``cuts = (c1, .., cK)`` yields K+1 stage costs: layers ``[0, c1]``,
    ``(c1, c2]``, ..., ``(cK, end)``.
    """
    rows = summary(model, params, batch, sample=sample)
    bounds = [0] + [c + 1 for c in cuts] + [len(rows)]
    return [sum(r.mult_adds for r in rows[a:b]) * 2
            for a, b in zip(bounds, bounds[1:])]


def format_table(rows: list, max_rows: int = 0) -> str:
    out = [f"{'Layer (type)':<24s}{'Output Shape':<26s}{'Param #':>14s}"]
    shown = rows if not max_rows else rows[:max_rows]
    for r in shown:
        out.append(f"{r.name + ' (' + r.kind + ')':<24s}"
                   f"{str(list(r.output_shape)):<26s}{r.n_params:>14,d}")
    return "\n".join(out)
