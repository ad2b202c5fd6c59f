"""Blocks of a sharded nest on a ``DeviceMesh``: the port's stand-in for
GSPMD's placement.

Where the reference hands ``jax.jit`` a parameter tree placed by
``rules.param_specs`` and lets XLA insert the collectives, the port keeps
on each rank only its block of every leaf and moves the data itself.  The
placements are ``rules.py``'s: a spec entry cuts its tensor dim into equal
parts over its axes' product, major axis first, and a rank holds the part
at its mesh coordinates.  A group-stacked leaf's leading axis is never cut
(the rules give it ``None``).

* :func:`local_block`, :func:`shard_tree`, :func:`gather_tree`: a leaf's
  block at this rank, and the inverse pair over a whole nest.
* :class:`Cut`: the hook of ``transformer.init_params(mesh=)`` that cuts
  each group's draw into this rank's blocks before the groups are stacked.
* :func:`all_gather`, :func:`all_gather_last`, :func:`sum_f32`,
  :func:`all_to_all`: the activation collectives of the serving path
  (``sharding/parallel.py``), one group of the mesh each.
* :class:`GatherBlocks`: blocks all-gathered into their full leaves, whose
  backward gives each block the sum over every rank of its leaf's gradient
  (a reduce-scatter over the axes that shard the leaf, then an all-reduce
  over the axes that replicate it).  The leaves of one call go together:
  one collective a mesh axis and dtype, whatever the number of leaves.
  :class:`Gather` applies it to a nest by path; it is the ``gather`` hook
  of ``models/transformer.py``.

Under ``nccl`` the collectives take CUDA tensors.  ``gloo`` carries host
tensors only, so there a CUDA operand goes through pinned host buffers and
back (as ``core/split.py``'s wire does); the compute stays on the card.
``traffic`` counts the bytes of each kind of collective's full operand.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.sharding.rules import P, _axes, mesh_axes, mesh_axis_sizes
from repro_torch.tree import tree_leaves, tree_map

# bytes of the full operand of every collective since the last reset: the
# gathered leaf, the gradient reduce-scattered, the tensor all-reduced, the
# tensor each rank sends and receives in an all-to-all
traffic = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0, "all_to_all": 0}


def reset_traffic() -> None:
    for k in traffic:
        traffic[k] = 0


def coordinates(mesh) -> dict:
    """This rank's index on each axis of ``mesh`` (``pod`` 0 where absent)."""
    coords = dict(zip(mesh_axes(mesh)[0], mesh.get_coordinate()))
    coords.setdefault("pod", 0)
    return coords


def block_index(entry, coords: dict, sizes: dict) -> tuple:
    """``(index, parts)``: the part of a dim that spec ``entry`` cuts into
    ``parts`` which this rank holds, its axes taken major first."""
    idx, n = 0, 1
    for a in _axes(entry):
        idx, n = idx * sizes[a] + coords[a], n * sizes[a]
    return idx, n


def local_block(full: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec``: a view."""
    coords, sizes = coordinates(mesh), mesh_axis_sizes(mesh)
    out = full
    for d, entry in enumerate(spec):
        idx, n = block_index(entry, coords, sizes)
        if n > 1:
            size = full.shape[d] // n
            out = out.narrow(d, idx * size, size)
    return out


def full_shape(block_shape, spec, mesh) -> tuple:
    """The shape of the leaf whose blocks under ``spec`` have ``block_shape``."""
    sizes = mesh_axis_sizes(mesh)
    return tuple(s * math.prod(sizes[a] for a in _axes(e))
                 for s, e in zip(block_shape, tuple(spec) + (None,) * len(block_shape)))


def owns(spec, mesh) -> bool:
    """Whether this rank is the one that counts its block of a leaf once
    over the mesh: index 0 on every axis that replicates it."""
    used = {a for e in spec for a in _axes(e)}
    coords = coordinates(mesh)
    return all(coords[a] == 0 for a in mesh_axes(mesh)[0] if a not in used)


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) != "nccl"


def _host(t: torch.Tensor) -> torch.Tensor:
    """A pinned host copy of a CUDA tensor (the copy waits for it)."""
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def _all_gather(flat: torch.Tensor, group, n: int) -> torch.Tensor:
    """The ``n`` ranks' ``flat`` of ``group``, in its rank order: (n, L)."""
    if _staged(flat, group):
        out = torch.empty((n * flat.numel(),), dtype=flat.dtype, pin_memory=True)
        dist.all_gather_into_tensor(out, _host(flat), group=group)
        out = out.to(flat.device)
    else:
        out = flat.new_empty((n * flat.numel(),))
        dist.all_gather_into_tensor(out, flat, group=group)
    traffic["all_gather"] += out.numel() * out.element_size()
    return out.view(n, -1)


def _reduce_scatter(rows: torch.Tensor, group, n: int) -> torch.Tensor:
    """The sum over ``group`` of ``rows`` (n, L): row r to the group's rank r."""
    traffic["reduce_scatter"] += rows.numel() * rows.element_size()
    flat = rows.reshape(-1)
    if _staged(flat, group):
        out = torch.empty((rows.shape[1],), dtype=rows.dtype, pin_memory=True)
        dist.reduce_scatter_tensor(out, _host(flat), group=group)
        return out.to(rows.device)
    out = rows.new_empty((rows.shape[1],))
    dist.reduce_scatter_tensor(out, flat, group=group)
    return out


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` summed over ``group`` (the world where ``None``), in place."""
    traffic["all_reduce"] += t.numel() * t.element_size()
    if _staged(t, group):
        h = _host(t)
        dist.all_reduce(h, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """The ``n`` ranks' ``t`` of ``group``, stacked in its rank order:
    (n, *t.shape)."""
    return _all_gather(t.reshape(-1), group, n).view(n, *t.shape)


def all_gather_last(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """The ``n`` ranks' ``t`` of ``group`` joined on the last dim, in its
    rank order: the whole of a tensor whose last dim the ranks split."""
    if n == 1:
        return t
    parts = all_gather(t, group, n)
    return parts.movedim(0, -2).reshape(*t.shape[:-1], n * t.shape[-1])


def sum_f32(t: torch.Tensor, group, n: int, dtype=None) -> torch.Tensor:
    """``t`` summed over ``group`` in f32, then cast once to ``dtype``
    (``t``'s where ``None``): a row-parallel product's partial sums, each
    rounded only where one product over the whole rows rounds."""
    dtype = dtype or t.dtype
    if n == 1:
        return t.to(dtype)
    return all_reduce(t.float().contiguous(), group).to(dtype)


def all_to_all(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """``t`` (n, ...): part j goes to the group's rank j; returns (n, ...)
    whose part i came from rank i."""
    flat = t.contiguous().reshape(-1)
    traffic["all_to_all"] += flat.numel() * flat.element_size()
    if _staged(flat, group):
        out = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
        dist.all_to_all_single(out, _host(flat), group=group)
        out = out.to(t.device)
    else:
        out = torch.empty_like(flat)
        dist.all_to_all_single(out, flat, group=group)
    return out.view(t.shape)


def _by_dtype(pairs, tensors) -> list:
    """``pairs`` (leaf index first) split by their leaves' dtypes: one
    collective carries one dtype."""
    out = {}
    for pair in pairs:
        out.setdefault(tensors[pair[0]].dtype, []).append(pair)
    return list(out.values())


def _cut(a, specs) -> list:
    """``(leaf, dim)`` for each leaf that axis ``a`` cuts, and the dim."""
    return [(i, d) for i, spec in enumerate(specs) for d, e in enumerate(spec) if a in _axes(e)]


def gather_full(blks: list, specs: list, mesh) -> list:
    """The whole leaves from every rank's blocks: for each mesh axis, minor
    first, one all-gather a dtype over the leaves it cuts (a composite
    entry names its axes in the mesh's order, so its minor axis is
    gathered first)."""
    sizes = mesh_axis_sizes(mesh)
    outs = list(blks)
    for a in reversed(mesh_axes(mesh)[0]):
        n = sizes[a]
        if n == 1:
            continue
        for batch in _by_dtype(_cut(a, specs), outs):
            rows = _all_gather(torch.cat([outs[i].reshape(-1) for i, _ in batch]),
                               mesh.get_group(a), n)
            off = 0
            for i, d in batch:
                shape = list(outs[i].shape)
                part = rows[:, off:off + outs[i].numel()].reshape([n] + shape)
                off += outs[i].numel()
                shape[d] *= n
                outs[i] = part.movedim(0, d).reshape(shape)
    return outs


def reduce_to_block(fulls: list, specs: list, mesh) -> list:
    """This rank's blocks of the sums over every rank of ``fulls``: for each
    mesh axis, major first, one reduce-scatter a dtype over the leaves it
    cuts, then for each axis one all-reduce a dtype over the leaves it does
    not cut."""
    names, sizes = mesh_axes(mesh)[0], mesh_axis_sizes(mesh)
    outs = list(fulls)
    for a in names:
        n = sizes[a]
        if n == 1:
            continue
        for batch in _by_dtype(_cut(a, specs), outs):
            parts = [outs[i].movedim(d, 0) for i, d in batch]
            rows = _reduce_scatter(torch.cat([p.reshape(n, -1) for p in parts], dim=1),
                                   mesh.get_group(a), n)
            off = 0
            for (i, d), p in zip(batch, parts):
                shape = [p.shape[0] // n] + list(p.shape[1:])
                k = math.prod(shape)
                outs[i] = rows[off:off + k].reshape(shape).movedim(0, d)
                off += k
    for a in names:
        if sizes[a] == 1:
            continue
        cut = {i for i, _ in _cut(a, specs)}
        for batch in _by_dtype([(i,) for i in range(len(outs)) if i not in cut], outs):
            flat = all_reduce(torch.cat([outs[i].reshape(-1) for i, in batch]),
                              mesh.get_group(a))
            off = 0
            for i, in batch:
                outs[i] = flat[off:off + outs[i].numel()].view(outs[i].shape)
                off += outs[i].numel()
    return [o.contiguous() for o in outs]


class GatherBlocks(torch.autograd.Function):
    """``GatherBlocks.apply(specs, mesh, *blocks)``: the whole leaves
    (:func:`gather_full`); the backward sends each block the sum over every
    rank of its leaf's gradient (:func:`reduce_to_block`).  Every rank must
    run the same gathers in the same order, forward and backward, as
    collectives do."""

    @staticmethod
    def forward(ctx, specs, mesh, *blks):
        ctx.specs, ctx.mesh = specs, mesh
        outs = gather_full(list(blks), specs, mesh)
        return tuple(o.clone() if o is b else o for o, b in zip(outs, blks))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None) + tuple(reduce_to_block(list(grads), ctx.specs, ctx.mesh))


def specs_at(specs, path: str) -> list:
    """The leaves' specs of the sub-nest at the "/"-joined ``path`` of
    ``specs``.  Under ``layers`` (``layers``, ``enc/layers``,
    ``layers/l0/attn``) the sub-nest is one group's, so its specs lose their
    leading, never cut, group entry."""
    for k in path.split("/"):
        specs = specs[k]
    specs = tree_leaves(specs)
    if "layers" in path.split("/"):
        if any(spec and spec[0] is not None for spec in specs):
            raise ValueError(f"{path}: a group axis is cut by {specs}")
        specs = [P(*tuple(spec)[1:]) for spec in specs]
    return specs


class Cut:
    """The ``cut(tree, path)`` hook of ``transformer.init_params`` on a
    mesh: each leaf of ``tree``, the sub-nest at ``path`` of the parameters
    (one group's under ``layers``), replaced by this rank's block of it
    under ``specs`` as a tensor of its own, so that the drawn leaf is freed
    before the next is drawn and no stacked leaf is ever whole."""

    def __init__(self, specs, mesh):
        self.specs, self.mesh = specs, mesh

    def __call__(self, tree, path: str):
        it = iter(specs_at(self.specs, path))
        return tree_map(lambda t: local_block(t, next(it), self.mesh).clone(), tree)


class Gather:
    """The ``gather(tree, path)`` hook of ``transformer.forward`` and
    ``loss_fn`` on a mesh: the leaves of ``tree``, the sub-nest at the
    "/"-joined ``path`` of the parameters, gathered whole together through
    :class:`GatherBlocks` by their specs in ``specs``.  Under ``layers``
    (``layers``, ``enc/layers``) ``tree`` is one group's views, so its
    specs lose their leading, never cut, group entry."""

    def __init__(self, specs, mesh):
        self.specs, self.mesh = specs, mesh

    def __call__(self, tree, path: str):
        specs = specs_at(self.specs, path)
        it = iter(GatherBlocks.apply(specs, self.mesh, *tree_leaves(tree)))
        return tree_map(lambda _: next(it), tree)


def shard_tree(tree, specs, mesh):
    """Each leaf's block at this rank (:func:`local_block`), as a tensor of
    its own, so that the whole leaf can be freed."""
    return tree_map(lambda t, s: local_block(t, s, mesh).clone(), tree, specs)


def gather_tree(tree, specs, mesh):
    """The whole nest from every rank's blocks (:func:`gather_full`): the
    inverse of :func:`shard_tree`."""
    it = iter(gather_full(tree_leaves(tree), tree_leaves(specs), mesh))
    return tree_map(lambda _: next(it), tree)
