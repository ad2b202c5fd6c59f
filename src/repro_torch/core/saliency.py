"""Saliency-based split-point search (paper §III; twin of
``repro/core/saliency.py``).

Generalized Grad-CAM over a :class:`LayeredModel`:

  1. one forward pass capturing every layer activation F^i, with taps[i]
     added to each (the *tap* trick),
  2. one backward pass (``torch.autograd.grad`` w.r.t. the zero taps)
     yielding dy_c/dF^i for every layer at once,
  3. per layer: alpha_ch = mean_spatial(dy_c/dF_ch)   (Eq. 1; "spatial" =
     all non-batch, non-channel dims, so 1-D signals work),
     m_i = sum_ch alpha_ch * F_ch, resized to a common grid,
  4. cumulative map  M_i = ReLU(sum_{k>=i} m_k)  (Eq. 2),
     per-layer scalar CS_i = mean_batch sum(M_i),
  5. average over inputs of all classes, normalise -> the CS curve.

Candidate split points = plateau-tolerant local maxima of CS restricted to
legal cut points.  The backward pass goes through PyTorch's own ops (cuDNN
convolutions, ``addmm``) and, over a zoo view on the card, through the
backward kernels of ``flash_attention``, ``rwkv6_scan`` and (a Mamba
layer's) ``mamba_scan``.  The parameters should not require grad, or the
pass also computes their gradients.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.models.layered import LayeredModel

# F.interpolate's mode for maps with this many spatial dims; with
# align_corners=False and no antialiasing it upsamples as
# jax.image.resize(method="bilinear") does
_RESIZE_MODES = {1: "linear", 2: "bilinear"}


def _spatial_axes(shape) -> tuple:
    """Axes between batch (0) and channel (-1)."""
    return tuple(range(1, len(shape) - 1))


def _weighted_map(act: torch.Tensor, grad: torch.Tensor) -> torch.Tensor:
    """alpha-weighted, channel-summed map m_i: (B, *spatial) (spatial may be ())."""
    sp = _spatial_axes(act.shape)
    alpha = grad.mean(dim=sp) if sp else grad          # (B, C)
    alpha = alpha.reshape(alpha.shape[0], *([1] * len(sp)), alpha.shape[-1])
    return (alpha * act).sum(dim=-1)                   # (B, *spatial)


def _resize_to(m: torch.Tensor, target_spatial: tuple) -> torch.Tensor:
    """Resize a (B, *spatial) map to (B, *target_spatial); scalars broadcast.
    Maps are only upsampled: the target is the largest map's grid."""
    b = m.shape[0]
    if m.dim() == 1:                                    # no spatial dims
        return m.reshape((b,) + (1,) * len(target_spatial)).expand(
            (b,) + tuple(target_spatial))
    if tuple(m.shape[1:]) == tuple(target_spatial):
        return m
    if (m.dim() - 1 != len(target_spatial) or m.dim() - 1 not in _RESIZE_MODES
            or any(s > t for s, t in zip(m.shape[1:], target_spatial))):
        raise ValueError(f"cannot upsample a map of {tuple(m.shape[1:])} to "
                         f"{tuple(target_spatial)}: 1-D or 2-D maps, never shrunk")
    return F.interpolate(m[:, None], size=tuple(target_spatial),
                         mode=_RESIZE_MODES[m.dim() - 1], align_corners=False,
                         antialias=False)[:, 0]


def _device_of(x) -> torch.device:
    """Where an input (a tensor or a batch dict of them) lies."""
    if torch.is_tensor(x):
        return x.device
    return next(v.device for v in x.values() if torch.is_tensor(v))


def layer_saliency_maps(model: LayeredModel, params, x, labels) -> list:
    """Per-layer alpha-weighted maps m_i resized to a common grid.

    ``x`` is a tensor or a model-specific input (the first layer of a
    transformer view consumes a batch dict); ``labels`` are class indices
    (a tensor or an integer array) of the logits' leading shape.  TF32 is
    turned off (``resolve_device``), so the card's convolutions round as
    the CPU's do.
    """
    resolve_device(_device_of(x))
    acts, taps = [], []
    with torch.enable_grad():
        # the tapped forward, each tap made as its layer's output appears
        # (the reference needs a capture pass first for the tap shapes); the
        # activations are the outputs before their zero tap is added
        h = x
        for layer, p in zip(model.layers, params):
            h = layer.apply(p, h)
            acts.append(h.detach())
            taps.append(torch.zeros_like(h, requires_grad=True))
            h = h + taps[-1]
        logits = h
        labels = torch.as_tensor(labels, device=logits.device).long()
        onehot = F.one_hot(labels, logits.shape[-1]).to(logits.dtype)
        grads = torch.autograd.grad(logits, taps, grad_outputs=onehot)

    # common grid = spatial shape of the largest feature map
    spatial_shapes = [tuple(a.shape[1:-1]) for a in acts]
    ranked = sorted((s for s in spatial_shapes if s), key=np.prod, reverse=True)
    target = ranked[0] if ranked else ()
    maps = []
    for a, g in zip(acts, grads):
        m = _weighted_map(a.float(), g.float())
        maps.append(_resize_to(m, target) if target else m)
    return maps


def cumulative_saliency(model: LayeredModel, params, x, labels,
                        layer_idx: Optional[Sequence[int]] = None) -> np.ndarray:
    """The CS curve over ``layer_idx`` (default: all layers).  Computed in
    f32 where the maps lie, then normalised in float64 on the host."""
    maps = layer_saliency_maps(model, params, x, labels)
    if layer_idx is not None:
        maps = [maps[i] for i in layer_idx]
    stack = torch.stack(maps)                           # (L, B, *spatial)
    # cumulative from the back: M_i = sum_{k>=i} m_k
    cum = torch.flip(torch.cumsum(torch.flip(stack, (0,)), dim=0), (0,))
    cs = torch.relu(cum).sum(dim=tuple(range(2, cum.dim()))).mean(dim=1)
    cs = cs.cpu().numpy().astype(np.float64)
    rng = cs.max() - cs.min()
    return (cs - cs.min()) / (rng if rng > 0 else 1.0)


def batched_cs(model: LayeredModel, params, data_iter, n_batches: int,
               layer_idx=None) -> np.ndarray:
    """Average the CS curve over several batches (all classes into play).
    The iterator yields ``(x, labels)``, each already where ``params`` lie."""
    acc = None
    for _ in range(n_batches):
        x, y = next(data_iter)
        cs = cumulative_saliency(model, params, x, y, layer_idx)
        acc = cs if acc is None else acc + cs
    return acc / n_batches


def local_maxima(curve: np.ndarray, *, tol: float = 1e-9) -> list[int]:
    """Plateau-tolerant local maxima indices (endpoints excluded)."""
    peaks = []
    n = len(curve)
    i = 1
    while i < n - 1:
        j = i
        while j + 1 < n and abs(curve[j + 1] - curve[j]) <= tol:
            j += 1  # walk plateaus
        if curve[i] > curve[i - 1] + tol and (j + 1 < n and curve[j] > curve[j + 1] + tol):
            peaks.append((i + j) // 2)
            i = j + 1
        else:
            i += 1
    return peaks


def candidate_split_points(model: LayeredModel, cs: np.ndarray,
                           layer_idx: Sequence[int],
                           top_n: int = 5) -> list[int]:
    """Local CS maxima mapped back to legal model cut points, best first."""
    legal = set(model.cut_points())
    peaks = [layer_idx[p] for p in local_maxima(cs) if layer_idx[p] in legal]
    peaks.sort(key=lambda li: -cs[list(layer_idx).index(li)])
    return peaks[:top_n]
