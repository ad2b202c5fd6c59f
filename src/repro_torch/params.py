"""Carry the JAX package's parameters, given as numpy arrays, into the port.

The caller turns a JAX pytree into numpy (``jax.tree.map(np.asarray, p)``);
the port never sees a JAX array.  Conv weights go from HWIO to OIHW in
``channels_last`` memory; linear weights keep their (in, out) layout.  A
zoo model's group-stacked tree crosses leaf by leaf in its own dtype.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.layered import LayeredModel
from repro_torch.models.transformer import param_spec


def _tensor(a, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32), device=dev)


def vgg_params_from_numpy(model: LayeredModel, params_np: list, *,
                          device="cuda") -> list:
    """One dict of tensors per layer of ``model`` from the reference's
    per-layer dicts of numpy arrays."""
    dev = resolve_device(device)
    if len(params_np) != len(model.layers):
        raise ValueError(f"{len(params_np)} parameter entries for "
                         f"{len(model.layers)} layers")
    out = []
    for layer, p in zip(model.layers, params_np):
        if layer.kind == "conv":
            w = _tensor(p["w"], dev).permute(3, 2, 0, 1)
            out.append({"w": w.contiguous(memory_format=torch.channels_last),
                        "b": _tensor(p["b"], dev)})
        else:
            out.append({k: _tensor(v, dev) for k, v in p.items()})
    return out


def ae_from_numpy(ae_np: dict, *, device="cuda") -> dict:
    """``{"enc": {"w", "b"}, "dec": {"w", "b"}}`` of numpy arrays -> tensors."""
    dev = resolve_device(device)
    return {part: {k: _tensor(ae_np[part][k], dev) for k in ("w", "b")}
            for part in ("enc", "dec")}


def _leaf(a, dev) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype.  bfloat16 (``ml_dtypes``,
    which ``torch`` does not take) crosses as its bits, through an int16
    view, so every value arrives exactly.  The tensor owns a copy."""
    a = np.array(a, order="C", copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(dev)
    return torch.from_numpy(a).to(dev)


def transformer_params_from_numpy(cfg, params_np: dict, *, device="cuda") -> dict:
    """The port's parameters for zoo config ``cfg`` from the reference's
    pytree as numpy (``jax.tree.map(np.asarray, params)``).  Each leaf keeps
    its dtype; a tree whose keys, shapes or dtypes differ from what ``cfg``
    makes raises ``ValueError``."""
    dev = resolve_device(device)

    def convert(spec, tree, path):
        if isinstance(spec, dict):
            if not isinstance(tree, dict) or set(tree) != set(spec):
                got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
                raise ValueError(f"{path or 'params'}: want keys {sorted(spec)}, got {got}")
            return {k: convert(spec[k], tree[k], f"{path}/{k}") for k in spec}
        t = _leaf(tree, dev)
        if tuple(t.shape) != tuple(spec.shape) or t.dtype != spec.dtype:
            raise ValueError(f"{path}: want {tuple(spec.shape)} {spec.dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        return t

    return convert(param_spec(cfg), params_np, "")
