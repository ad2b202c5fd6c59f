"""Flat-npz checkpointing for nests of tensors (twin of
``repro/training/checkpoint.py``).

One npz holds ``leaf_{i}`` in the reference's leaf order: a dict's keys
sorted, as ``jax.tree_util`` flattens a dict, lists and tuples in order.
bf16 is saved as f32, as the reference saves it (numpy has no bf16), and
comes back exactly.  A file written by either package restores in the
other: the reference's ``restore`` reads only the leaves, so this module's
``__treedef__`` is its own description of the nest (the leaves' key paths
as JSON), not JAX's treedef string.

A tree of blocks sharded over a mesh (``sharding.blocks``, given with its
``specs`` and ``mesh``) is saved whole, in the same format, by rank 0, and
restored into blocks: a sharded run's checkpoint restores into the
unsharded tree and the other way round.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.sharding import blocks


def _flatten(tree, path=()) -> list:
    """``[(key path, leaf)]`` in the reference's leaf order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _flatten(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree) for kv in _flatten(t, path + (i,))]
    return [(path, tree)]


def _rebuild(like, leaves):
    """A nest shaped like ``like`` from an iterator over its new leaves in
    :func:`_flatten`'s order."""
    if isinstance(like, dict):
        built = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return {k: built[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(t, leaves) for t in like)
    return next(leaves)


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    a = np.asarray(x)
    if a.dtype.kind not in "fiub" or str(a.dtype) == "bfloat16":
        a = a.astype(np.float32)
    return a


def save(path: str, tree, *, specs=None, mesh=None) -> None:
    """Write ``tree`` to ``path`` atomically: into ``path + ".tmp"``, then
    renamed over ``path``.  With a ``mesh``, ``tree`` holds this rank's
    blocks by ``specs``: every rank takes part in gathering each leaf whole
    (one at a time), rank 0 writes, and all return once the file is there."""
    leaves = _flatten(tree)
    if mesh is not None:
        writer, arrays = dist.get_rank() == 0, {}
        for i, ((_, leaf), (_, spec)) in enumerate(zip(leaves, _flatten(specs))):
            whole = blocks.gather_full([leaf], [spec], mesh)[0]
            if writer:
                arrays[f"leaf_{i}"] = _to_numpy(whole)
            del whole
        if writer:
            _write(path, leaves, arrays)
        dist.barrier()
        return
    _write(path, leaves, {f"leaf_{i}": _to_numpy(leaf) for i, (_, leaf) in enumerate(leaves)})


def _write(path: str, leaves: list, arrays: dict) -> None:
    paths = json.dumps([list(p) for p, _ in leaves]).encode()
    arrays["__treedef__"] = np.frombuffer(paths, dtype=np.uint8)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def restore(path: str, like, *, specs=None, mesh=None):
    """The nest saved at ``path``, shaped like ``like``: each leaf's shape
    checked, put in ``like``'s leaf's dtype on its device.  With a
    ``mesh``, ``like`` holds this rank's blocks by ``specs``, and each leaf
    comes back as this rank's block of the saved one."""
    likes = _flatten(like)
    spec_leaves = [s for _, s in _flatten(specs)] if mesh is not None else [None] * len(likes)
    with np.load(path) as data:
        out = []
        for i, ((key, ref), spec) in enumerate(zip(likes, spec_leaves)):
            arr = data[f"leaf_{i}"]
            want = (tuple(ref.shape) if spec is None
                    else blocks.full_shape(ref.shape, spec, mesh))
            if tuple(arr.shape) != want:
                raise ValueError(f"{path}: leaf {i} {'/'.join(map(str, key))} has shape "
                                 f"{tuple(arr.shape)}, want {want}")
            t = torch.from_numpy(arr)
            if spec is not None:
                t = blocks.local_block(t, spec, mesh)
            out.append(t.to(device=ref.device, dtype=ref.dtype))
    return _rebuild(like, iter(out))
