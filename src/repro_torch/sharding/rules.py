"""Logical-axis sharding rules: param/batch/cache nests -> PartitionSpecs
(twin of ``repro/sharding/rules.py``).

Scheme: 2D FSDP-style weight sharding over ("data","model"), experts over
"model", batch over ("pod","data"), sequence-parallel residual stream (seq
over "model"), decode KV caches sharded batch->data / seq->model.  Every
candidate axis is divisibility-checked against the mesh and silently dropped
when it does not divide (whisper-tiny's 6 heads, long_500k's batch=1, ...),
so one rule set serves every config and shape.

The port has no ``jax.sharding``: :class:`PartitionSpec` is its own small
spec (one entry a tensor dim: ``None``, an axis name, or a tuple of names,
major to minor), a mesh is a ``torch.distributed.device_mesh.DeviceMesh``
or anything with ``axis_names`` and ``devices.shape`` (so that specs
resolve without a process group), and :func:`to_shardings` gives DTensor
placements where the reference gives ``NamedSharding``\\ s.  Paths are the
nest's dict keys joined by "/", as the reference's key paths are.
"""
from __future__ import annotations

import re


class PartitionSpec:
    """How a tensor's dims map to mesh axes: one entry a dim, each ``None``
    (replicated), an axis name, or a tuple of names (the dim split over
    their product, the first name major).  Not a tuple, so that the port's
    nest helpers (``repro_torch.tree``) take a spec as a leaf; it iterates,
    indexes and compares as the tuple of its entries."""

    __slots__ = ("_entries",)

    def __init__(self, *entries):
        self._entries = tuple(entries)

    def __iter__(self):
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)

    def __getitem__(self, i):
        return self._entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, (PartitionSpec, tuple)):
            return self._entries == tuple(other)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self._entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{self._entries!r}"


P = PartitionSpec

# (path-regex, spec template). First match wins. Templates are tuples of
# mesh-axis names (or None); group-stacked params get a leading None.
PARAM_RULES = [
    (r"embed$", (None, "model")),
    (r"head$", (None, "model")),
    (r"(attn|cross)/w[qkv]$", ("data", "model")),
    (r"(attn|cross)/wo$", ("model", "data")),
    (r"(attn|cross)/b[qkv]$", ("model",)),
    (r"ffn/router$", (None, None)),
    (r"ffn/w_(gate|up)$", {2: ("data", "model"), 3: ("model", "data", None)}),
    (r"ffn/w_down$", {2: ("model", "data"), 3: ("model", None, "data")}),
    (r"ffn/shared/w_(gate|up)$", ("data", "model")),
    (r"ffn/shared/w_down$", ("model", "data")),
    (r"ffn/(w_in|b_in)$", {2: ("data", "model"), 1: ("model",)}),
    (r"ffn/w_out$", ("model", "data")),
    (r"mamba/in_proj$", ("data", "model")),
    (r"mamba/out_proj$", ("model", "data")),
    (r"mamba/conv$", (None, "model")),
    (r"mamba/conv_b$", ("model",)),
    (r"mamba/x_proj$", ("model", None)),
    (r"mamba/dt_proj$", (None, "model")),
    (r"mamba/(dt_bias|D)$", ("model",)),
    (r"mamba/A_log$", ("model", None)),
    (r"tm/w[rkvg]$", ("data", "model")),
    (r"tm/wo$", ("model", "data")),
    (r"cm/w_k$", ("data", "model")),
    (r"cm/w_v$", ("model", "data")),
    (r"cm/w_r$", ("data", "model")),
    (r"enc/proj$", (None, "model")),
    (r"enc/pos$", (None, "model")),
    (r"projector/w1$", (None, "model")),
    (r"projector/w2$", ("data", "model")),
]

CACHE_RULES = [
    (r"/(k|v)$", (None, "data", "model", None, None)),
    (r"/kv_pos$", (None, "data", "model")),
    (r"/(ck|cv)$", (None, "data", None, "model", None)),
    (r"/conv$", (None, "data", None, "model")),
    (r"/ssm$", (None, "data", "model", None)),
    (r"/(tm_prev|cm_prev)$", (None, "data", "model")),
    (r"/wkv$", (None, "data", "model", None, None)),
]


def _path_str(path) -> str:
    return "/".join(str(k) for k in path)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a nest of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def _axes(entry) -> tuple:
    """The mesh axes of one spec entry, major first (``()`` for ``None``)."""
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def _sanitize(spec: tuple, shape: tuple, axis_sizes: dict) -> P:
    """Drop sharding on axes that do not divide the dim."""
    out = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            out.append(None)
        else:
            n = 1
            for a in _axes(ax):
                n *= axis_sizes[a]
            out.append(ax if dim % n == 0 else None)
    return P(*out)


def _resolve(rules, path: str, shape: tuple, axis_sizes: dict, stacked: bool) -> P:
    for pat, tmpl in rules:
        if re.search(pat, path):
            if isinstance(tmpl, dict):  # select by rank (sans group axis)
                tmpl = tmpl.get(len(shape) - (1 if stacked else 0))
                if tmpl is None:
                    return P()
            spec = ((None,) + tuple(tmpl)) if stacked else tuple(tmpl)
            if len(spec) != len(shape):  # rank mismatch -> replicate
                return P()
            return _sanitize(spec, shape, axis_sizes)
    return P()


def mesh_axes(mesh) -> tuple:
    """``(axis names, sizes)`` of a ``DeviceMesh`` (``mesh_dim_names``,
    ``shape``) or of a stand-in with ``axis_names`` and ``devices.shape``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return tuple(names), tuple(mesh.shape)
    return tuple(mesh.axis_names), tuple(mesh.devices.shape)


def mesh_axis_sizes(mesh) -> dict:
    d = dict(zip(*mesh_axes(mesh)))
    d.setdefault("pod", 1)
    return d


def batch_axes(mesh):
    """The composite data-parallel axis: ("pod","data") on multi-pod."""
    return ("pod", "data") if "pod" in mesh_axes(mesh)[0] else ("data",)


def _dp_entry(mesh):
    dp = batch_axes(mesh)
    return dp[0] if len(dp) == 1 else dp


def param_specs(params_tree, mesh, profile: str = "train"):
    """PartitionSpec nest matching a param (shape-)nest.

    profile="train": 2D FSDP sharding over ("data","model").
    profile="inference": weights sharded over "model" only (replicated
    across "data"), which removes the per-step weight all-gathers of decode
    at the cost of holding ``data`` times the weights.
    """
    sizes = mesh_axis_sizes(mesh)

    def one(path, leaf):
        ps = _path_str(path)
        stacked = ps.startswith("layers/") or "/layers/" in ps
        spec = _resolve(PARAM_RULES, ps, tuple(leaf.shape), sizes, stacked)
        if profile == "inference":
            spec = P(*[None if ax == "data" else ax for ax in spec])
        return spec

    return _map_with_path(one, params_tree)


def cache_specs(cache_tree, mesh):
    sizes = mesh_axis_sizes(mesh)

    def one(path, leaf):
        return _resolve(CACHE_RULES, _path_str(path), tuple(leaf.shape), sizes, False)

    return _map_with_path(one, cache_tree)


def batch_specs(batch_tree, mesh):
    """tokens/labels (B,S) -> batch over ("pod","data"); frontends likewise."""
    sizes = mesh_axis_sizes(mesh)
    dp = _dp_entry(mesh)

    def one(path, leaf):
        spec = (dp,) + (None,) * (len(leaf.shape) - 1)
        return _sanitize(spec, tuple(leaf.shape), sizes)

    return _map_with_path(one, batch_tree)


# Each kind maps to a list of candidate specs; the first whose sharded dims
# all divide is used ("heads" falls back to sequence sharding when the head
# count doesn't divide the model axis: llama3.2-3b's 24 heads, whisper's 6).
ACT_SPECS = {
    "residual": lambda dp: [P(dp, "model", None)],
    "heads": lambda dp: [P(dp, None, "model", None), P(dp, "model", None, None)],
    "ffn_hidden": lambda dp: [P(dp, None, "model")],
    "moe_experts": lambda dp: [P(dp, "model", None, None)],
    "mamba_inner": lambda dp: [P(dp, None, "model")],
    "mamba_state": lambda dp: [P(dp, "model", None)],
    "wkv_state": lambda dp: [P(dp, "model", None, None)],
    "logits": lambda dp: [P(dp, None, "model")],
    "decode_residual": lambda dp: [P("data", None, None)],
    "decode_logits": lambda dp: [P("data", "model")],
    # wire boundary tensors (runtime.partition fused segments): the int8
    # codes (N, L) and their (N, 1) row scales shard over the batch-row
    # axis only, so a row's codes and its scale land on the same shard
    "boundary_codes": lambda dp: [P(dp)],
    "boundary_scales": lambda dp: [P(dp)],
}


def _fits(spec, shape, sizes) -> bool:
    for dim, ax in zip(shape, spec):
        n = 1
        for a in _axes(ax):
            n *= sizes[a]
        if dim % n:
            return False
    return True


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``, one a mesh dim:
    ``Shard(d)`` where the axis shards tensor dim d, else ``Replicate()``.
    DTensor splits a dim that several mesh dims shard in mesh-dim order, so
    a composite entry must name its axes in the mesh's order (JAX's
    major-to-minor order of the entry)."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh_axes(mesh)[0]
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        idx = [names.index(a) for a in axes if a in names]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's axis order {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def make_shard_fn(mesh, *, head_seq_fallback: bool = False):
    """The ``(x, kind) -> x`` hook that pins activation shardings: a DTensor
    is redistributed to the first ``ACT_SPECS`` candidate of ``kind`` that
    fits its shape.  The identity where ``mesh`` is ``None`` or holds one
    rank, where ``x`` is a plain tensor, and for an unknown kind.

    ``head_seq_fallback=True``: when the head count doesn't divide the
    model axis, shard the attention *sequence* dim instead of leaving q/k/v
    effectively replicated (default False, as the reference's).
    """
    if mesh is None or all(n == 1 for n in mesh_axes(mesh)[1]):
        return lambda x, kind: x
    from torch.distributed.tensor import DTensor
    sizes = mesh_axis_sizes(mesh)
    dp = _dp_entry(mesh)

    def shard_fn(x, kind):
        fn = ACT_SPECS.get(kind)
        if fn is None or not isinstance(x, DTensor):
            return x
        candidates = fn(dp)
        if not head_seq_fallback:
            candidates = candidates[:1]
        for spec in candidates:
            if _fits(spec, x.shape, sizes):
                return x.redistribute(mesh, placements(spec, mesh))
        spec = _sanitize(tuple(candidates[0]), tuple(x.shape), sizes)
        return x.redistribute(mesh, placements(spec, mesh))

    return shard_fn


def to_shardings(spec_tree, mesh):
    """Each spec of a nest as its DTensor :func:`placements` on ``mesh``."""
    return _map_with_path(lambda _, s: placements(s, mesh), spec_tree)

