"""Undercomplete autoencoder bottleneck (paper §III, Eqs. 3-4; twin of
``repro/core/bottleneck.py``).

The encoder (edge side) projects the channels-last activation to ``rate``
of its channels, the decoder (server side) reconstructs it.
``encode_wire`` and ``decode_wire`` go through the kernel wrappers: the CUDA
kernels for tensors on the card, their plain versions on the CPU.

Training, as the reference does it: stage 1 (:func:`train_bottleneck`,
Eq. 3) fits the AE alone to the reconstruction loss with the backbone
frozen; stage 2 (:func:`finetune`, Eq. 4) fine-tunes backbone and AE end to
end on the task loss.  Both run the plain f32 path (``encode``/``decode``,
PyTorch's matmuls): the codec kernels are int8 and forward-only.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels.bottleneck_compress import bottleneck_compress
from repro_torch.kernels.bottleneck_decompress import bottleneck_decompress
from repro_torch.models.layered import LayeredModel
from repro_torch.training.optimizer import adam_init, adam_update
from repro_torch.tree import tree_leaves, tree_map


def latent_channels(c: int, rate: float) -> int:
    return max(1, int(round(c * rate)))


def init_bottleneck(seed: int, feat_shape: tuple, rate: float = 0.5, *,
                    device="cuda") -> dict:
    """feat_shape: activation shape sans batch, channels last."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    c = feat_shape[-1]
    cl = latent_channels(c, rate)
    return {
        "enc": {"w": torch.randn((c, cl), generator=gen, device=dev) / math.sqrt(c),
                "b": torch.zeros((cl,), device=dev)},
        "dec": {"w": torch.randn((cl, c), generator=gen, device=dev) / math.sqrt(cl),
                "b": torch.zeros((c,), device=dev)},
    }


def encode(ae: dict, f: torch.Tensor) -> torch.Tensor:
    return torch.relu(f @ ae["enc"]["w"] + ae["enc"]["b"])


def decode(ae: dict, z: torch.Tensor) -> torch.Tensor:
    return z @ ae["dec"]["w"] + ae["dec"]["b"]


def reconstruct(ae: dict, f: torch.Tensor) -> torch.Tensor:
    return decode(ae, encode(ae, f))


def encode_wire(ae: dict, f: torch.Tensor) -> tuple:
    """Encoder + symmetric per-row int8 (the ``bottleneck_compress`` kernel).
    Returns ``(q int8 (..., L), scales f32 (..., 1))``."""
    lead = tuple(f.shape[:-1])
    q, s = bottleneck_compress(f.float().reshape(-1, f.shape[-1]).contiguous(),
                               ae["enc"]["w"], ae["enc"]["b"])
    return q.reshape(lead + (q.shape[-1],)), s.reshape(lead + (1,))


def decode_wire(ae: dict, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Dequantise + decoder (the ``bottleneck_decompress`` kernel)."""
    lead = tuple(q.shape[:-1])
    f = bottleneck_decompress(q.reshape(-1, q.shape[-1]).contiguous(),
                              s.reshape(-1, 1).float().contiguous(),
                              ae["dec"]["w"], ae["dec"]["b"])
    return f.reshape(lead + (f.shape[-1],))


def ae_loss(ae: dict, feats: torch.Tensor) -> torch.Tensor:
    """L_AE (Eq. 3): mean squared reconstruction error."""
    r = reconstruct(ae, feats.float())
    return torch.mean(torch.square(r - feats.float()))


def payload_bytes(feat_shape: tuple, rate: float, wire_dtype_bytes: int = 4) -> int:
    """Bytes/frame crossing the wire after compression (netsim input)."""
    cl = latent_channels(feat_shape[-1], rate)
    return int(np.prod(feat_shape[:-1])) * cl * wire_dtype_bytes


# -------------------------------------------------- split-model execution ----
def head_forward(model: LayeredModel, params, ae: Optional[dict], split: int,
                 x: torch.Tensor) -> torch.Tensor:
    """Edge side: layers [0, split] then the encoder. Returns the wire z."""
    f = model.apply_range(params, x, 0, split + 1)
    return encode(ae, f) if ae is not None else f


def tail_forward(model: LayeredModel, params, ae: Optional[dict], split: int,
                 z: torch.Tensor) -> torch.Tensor:
    """Server side: decoder then layers (split, end)."""
    f = decode(ae, z) if ae is not None else z
    return model.apply_range(params, f, split + 1, len(model.layers))


def split_forward(model: LayeredModel, params, ae: Optional[dict], split: int,
                  x: torch.Tensor,
                  corrupt_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full SC inference; ``corrupt_mask`` (broadcastable to z, 1=keep
    0=lost) models UDP packet loss zeroing wire chunks."""
    z = head_forward(model, params, ae, split, x)
    if corrupt_mask is not None:
        z = z * corrupt_mask.to(z.dtype)
    return tail_forward(model, params, ae, split, z)


def task_loss(model: LayeredModel, params, ae: Optional[dict], split: int,
              x: torch.Tensor, labels: torch.Tensor, kind: str = "mse") -> torch.Tensor:
    """L_task (Eq. 4). kind='mse' (paper) or 'ce'."""
    logits = (split_forward(model, params, ae, split, x)
              if ae is not None else model.apply(params, x))
    labels = labels.long()
    if kind == "mse":
        onehot = F.one_hot(labels, logits.shape[-1]).float()
        return torch.mean(torch.square(logits.float() - onehot))
    lse = torch.logsumexp(logits.float(), dim=-1)
    gold = torch.take_along_dim(logits.float(), labels[:, None], 1)[:, 0]
    return torch.mean(lse - gold)


# ---------------------------------------------------------------- training ----
def _batch(data_iter, dev) -> tuple:
    """The iterator's next ``(x, labels)`` (numpy or tensors) on ``dev``."""
    x, y = next(data_iter)
    return (torch.as_tensor(x, dtype=torch.float32, device=dev),
            torch.as_tensor(y, device=dev))


def value_and_grad(loss_fn, tree) -> tuple:
    """``loss_fn(tree)`` and its gradient, a nest shaped like ``tree``."""
    leaves = tree_map(lambda t: t.detach().requires_grad_(), tree)
    loss = loss_fn(leaves)
    grads = iter(torch.autograd.grad(loss, tree_leaves(leaves)))
    return loss.detach(), tree_map(lambda _: next(grads), leaves)


def train_bottleneck(model: LayeredModel, params, split: int, data_iter,
                     steps: int, lr: float = 5e-4, rate: float = 0.5,
                     seed: int = 0, *, device="cuda") -> tuple:
    """Stage 1 (Eq. 3): Adam on the AE only, backbone frozen.  The first
    batch only sizes the AE, as in the reference; the AE draws from a
    ``torch.Generator`` (``init_bottleneck``), so its numbers differ from
    the reference's ``jax.random`` draw.  Returns ``(ae, losses)``."""
    dev = resolve_device(device)
    x0, _ = _batch(data_iter, dev)
    with torch.no_grad():
        f0 = model.apply_range(params, x0, 0, split + 1)
    ae = init_bottleneck(seed, tuple(f0.shape[1:]), rate, device=dev)
    return train_bottleneck_from(model, params, split, ae, data_iter, steps, lr,
                                 device=dev)


def train_bottleneck_from(model: LayeredModel, params, split: int, ae: dict,
                          data_iter, steps: int, lr: float = 5e-4, *,
                          device="cuda") -> tuple:
    """:func:`train_bottleneck`'s loop from a given AE: one batch a step.
    Returns ``(ae, losses)``; ``ae`` itself is not written."""
    dev = resolve_device(device)
    opt = adam_init(ae)
    losses = []
    for _ in range(steps):
        x, _ = _batch(data_iter, dev)
        with torch.no_grad():
            feats = model.apply_range(params, x, 0, split + 1)
        loss, g = value_and_grad(lambda a: ae_loss(a, feats), ae)
        ae, opt = adam_update(ae, g, opt, lr)
        losses.append(float(loss))
    return ae, losses


def finetune(model: LayeredModel, params, ae: dict, split: int, data_iter,
             steps: int, lr: float = 5e-4, loss_kind: str = "mse", *,
             device="cuda") -> tuple:
    """Stage 2 (Eq. 4): end-to-end fine-tune of backbone + AE.  Returns
    ``(params, ae, losses)``; the inputs are not written."""
    dev = resolve_device(device)
    state = {"params": params, "ae": ae}
    opt = adam_init(state)
    losses = []
    for _ in range(steps):
        x, y = _batch(data_iter, dev)
        loss, g = value_and_grad(
            lambda st: task_loss(model, st["params"], st["ae"], split, x, y, loss_kind),
            state)
        state, opt = adam_update(state, g, opt, lr)
        losses.append(float(loss))
    return state["params"], state["ae"], losses
