"""Cut legality, split plans, wire payloads and the multi-pod pipeline
(twin of ``repro/core/split.py``).

Two execution mappings of the same split, as in the reference:

* **edge/server** (the paper's): the head on the sensing device, the
  payload over the simulated network (``repro_torch.netsim``), the tail on
  the server; ``repro_torch.core.bottleneck`` holds the pieces.
* **multi-pod pipeline**: the cut becomes the boundary between two stages
  on two groups of ranks (the ``pod`` axis of a ``DeviceMesh``), and
  :func:`multipod_split_step` runs a 2-stage microbatched pipeline whose
  hop between the stages is a ``torch.distributed`` send of the
  bottleneck-compressed activation: the paper's head/AE/tail triple with
  the network replaced by the link between pods.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core import bottleneck as B
from repro_torch.core.bottleneck import payload_bytes
from repro_torch.models import transformer as T
from repro_torch.models.layered import LayeredModel
from repro_torch.tree import tree_leaves, tree_map


@dataclass(frozen=True)
class SplitPlan:
    """A concrete SC design point: one or more ordered cuts.

    ``splits`` is the canonical ordered cut list; ``split_layer`` is the
    first (edge-side) cut, so ``SplitPlan(4)`` and
    ``SplitPlan(4, splits=(4,))`` are the same design point.
    """
    split_layer: int              # first cut (after this layer index)
    compression: float = 0.5      # bottleneck rate (paper: 50%)
    wire_dtype_bytes: int = 4
    splits: tuple = None          # full ordered cut list; (split_layer,) if None

    def __post_init__(self):
        if self.splits is None:
            cuts = () if self.split_layer is None else (int(self.split_layer),)
        else:
            cuts = normalize_cuts(self.splits)
        object.__setattr__(self, "splits", cuts)
        if self.split_layer is None and cuts:
            object.__setattr__(self, "split_layer", cuts[0])

    @property
    def n_stages(self) -> int:
        return len(self.splits) + 1

    def describe(self, model: LayeredModel) -> str:
        """Human-readable stage layout of this plan on ``model``."""
        cuts = validate_cuts(model, self.splits)
        if len(cuts) == 1:
            return (f"head=[0..{self.split_layer}] "
                    f"bottleneck(rate={self.compression}) "
                    f"tail=[{self.split_layer + 1}..{len(model.layers) - 1}]")
        bounds = (0,) + tuple(c + 1 for c in cuts) + (len(model.layers),)
        stages = " | ".join(f"stage{i}=[{a}..{b - 1}]"
                            for i, (a, b) in enumerate(zip(bounds, bounds[1:])))
        return f"{stages} bottleneck(rate={self.compression})"


def legal_cuts(model: LayeredModel) -> list[int]:
    """All legal cut indices of ``model`` (ascending layer order)."""
    return model.cut_points()


def validate_cut(model: LayeredModel, split_layer: int) -> int:
    """Check a cut index against the model's legality rule; raises with the
    legal alternatives."""
    cuts = model.cut_points()
    if split_layer not in cuts:
        raise ValueError(
            f"cut after layer {split_layer} is not legal for {model.name!r}; "
            f"legal cuts: {cuts}")
    return split_layer


def normalize_cuts(splits) -> tuple:
    """A scalar cut or an iterable of cuts -> the ascending cut tuple;
    raises unless strictly increasing."""
    if not hasattr(splits, "__iter__"):
        return (int(splits),)
    cuts = tuple(int(s) for s in splits)
    if any(b <= a for a, b in zip(cuts, cuts[1:])):
        raise ValueError(f"cut list {cuts} must be strictly increasing "
                         f"(every stage needs at least one layer)")
    return cuts


def validate_cuts(model: LayeredModel, splits) -> tuple:
    """Check an ordered cut list: non-empty, strictly increasing, every cut
    legal.  Returns the normalised tuple."""
    cuts = normalize_cuts(splits)
    if not cuts:
        raise ValueError(f"need at least one cut for {model.name!r}; "
                         f"legal cuts: {model.cut_points()}")
    for c in cuts:
        validate_cut(model, c)
    return cuts


def legal_cut_lists(model: LayeredModel, n_cuts: int) -> list:
    """Every legal ordered cut list with exactly ``n_cuts`` cuts."""
    if n_cuts < 1:
        raise ValueError(f"n_cuts must be >= 1, got {n_cuts}")
    return list(itertools.combinations(legal_cuts(model), n_cuts))


def wire_payload_bytes(model: LayeredModel, params, plan: SplitPlan,
                       batch: int = 1, *, sample=None) -> int:
    """Bytes crossing the first (edge-side) wire hop per ``batch`` frames
    under ``plan``; see :func:`hop_payload_bytes` for the whole chain.
    ``sample`` as in ``LayeredModel.activation_shapes``."""
    return hop_payload_bytes(model, params, plan, batch, sample=sample)[0]


def hop_payload_bytes(model: LayeredModel, params, plan: SplitPlan,
                      batch: int = 1, *, sample=None) -> list:
    """Per-hop wire payloads (bytes per ``batch`` frames) of a K-cut plan.

    Hop k carries the activation after cut ``plan.splits[k]``, compressed
    at the plan's bottleneck rate (one AE per cut, same rate).
    """
    shapes = model.activation_shapes(params, batch, sample=sample)
    return [batch * payload_bytes(shapes[c][1:], plan.compression,
                                  plan.wire_dtype_bytes)
            for c in plan.splits]


# ------------------------------------------------ multi-pod pipeline step ----
# what crosses the link: the model-dtype residual stream, the AE's f32
# latent, or its int8 codes with one f32 scale a token
WIRE_MODES = ("raw", "ae_f32", "ae_int8")


def _wire_mode(ae: Optional[dict], quantize_wire: bool = False) -> str:
    """The wire mode of ``(ae, quantize_wire)``; without an AE the residual
    stream crosses whatever ``quantize_wire`` says, as in the reference."""
    if ae is None:
        return "raw"
    return "ae_int8" if quantize_wire else "ae_f32"


def _uniform_stack(cfg) -> tuple:
    """(the one layer kind, n_groups) of a stack the pipeline can halve."""
    descs, n_groups = T.block_structure(cfg)
    if len(descs) != 1:
        raise ValueError(f"{cfg.name}: the pipeline takes uniform stacks only; this one "
                         f"repeats a period of {len(descs)} layers")
    if n_groups % 2:
        raise ValueError(f"{cfg.name}: {n_groups} layer groups do not halve into two stages")
    return descs[0], n_groups


def stage_params(params: dict, cfg, stage: int) -> dict:
    """What pod ``stage`` holds (the twin of ``_stack_stages``, one stage at
    a time): its half of the group-stacked ``layers`` as views; stage 0
    ``embed``, stage 1 ``final_norm`` and ``head`` (``embed`` where the
    embeddings are tied)."""
    _, n_groups = _uniform_stack(cfg)
    if stage not in (0, 1):
        raise ValueError(f"stage {stage}: the pipeline has stages 0 and 1")
    half = n_groups // 2
    out = {"layers": tree_map(lambda t: t[stage * half:(stage + 1) * half], params["layers"])}
    if stage == 0:
        out["embed"] = params["embed"]
    else:
        out["final_norm"] = params["final_norm"]
        head = "embed" if cfg.tie_embeddings else "head"
        out[head] = params[head]
    return out


def _run_layers(stage_tree: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    desc, _ = _uniform_stack(cfg)
    positions = torch.arange(x.shape[1], device=x.device)
    layers = stage_tree["layers"]
    for g in range(tree_leaves(layers)[0].shape[0]):
        p = tree_map(lambda t: t[g], layers)
        x = T.apply_layer_seq(p["l0"], desc, x, cfg, positions, causal=True,
                              window=cfg.sliding_window)[0]
    return x


def head_stage(stage_tree: dict, cfg, tokens: torch.Tensor) -> torch.Tensor:
    """Stage 0 on one microbatch: embed, then the first half of the blocks."""
    return _run_layers(stage_tree, cfg, stage_tree["embed"][tokens.long()])


def tail_stage(stage_tree: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """Stage 1 on one microbatch: the second half of the blocks, the final
    norm and the LM head.  Returns its (mb, S, V) logits."""
    x = T._apply_norm(stage_tree["final_norm"], _run_layers(stage_tree, cfg, x), cfg)
    return T.logits_from_x(stage_tree, cfg, x)


def wire_encode(ae: Optional[dict], y: torch.Tensor, mode: str) -> tuple:
    """The tensors that carry the head's output ``y`` over the link."""
    if mode == "raw":
        return (y.contiguous(),)
    if mode == "ae_f32":
        return (B.encode(ae, y.float()),)
    return B.encode_wire(ae, y.float())            # the bottleneck_compress kernel


def wire_decode(ae: Optional[dict], wire: tuple, mode: str, dtype) -> torch.Tensor:
    """The tail's input from what crossed the link, in the model's dtype."""
    if mode == "raw":
        x = wire[0]
    elif mode == "ae_f32":
        x = B.decode(ae, wire[0])
    else:
        x = B.decode_wire(ae, *wire)               # the bottleneck_decompress kernel
    return x.to(dtype)


def _wire_specs(cfg, ae: Optional[dict], mode: str, mb: int, seq: int) -> list:
    """(shape, dtype) of each wire tensor of one microbatch."""
    if mode == "raw":
        return [((mb, seq, cfg.d_model), cfg.tdtype)]
    latent = ae["dec"]["w"].shape[0]
    if mode == "ae_f32":
        return [((mb, seq, latent), torch.float32)]
    return [((mb, seq, latent), torch.int8), ((mb, seq, 1), torch.float32)]


def _microbatches(batch: dict, n_micro: int) -> tuple:
    tokens = batch["tokens"]
    bsz, seq = tokens.shape
    if n_micro < 1 or bsz % n_micro:
        raise ValueError(f"batch {bsz} does not split into {n_micro} microbatches")
    return tokens, bsz // n_micro, seq


def sequential_split_step(params: dict, cfg, batch: dict, *, ae: Optional[dict],
                          n_micro: int = 4, quantize_wire: bool = False) -> torch.Tensor:
    """The pipeline's work in one process over the whole tree: each
    microbatch through :func:`head_stage`, the wire's encode and decode and
    :func:`tail_stage`, the same operations at the same shapes as
    :func:`multipod_split_step`, one after the other.  Returns the (B, S,
    V) logits."""
    mode = _wire_mode(ae, quantize_wire)
    head, tail = stage_params(params, cfg, 0), stage_params(params, cfg, 1)
    tokens, mb, _ = _microbatches(batch, n_micro)
    out = None
    with torch.no_grad():
        for i in range(n_micro):
            wire = wire_encode(ae, head_stage(head, cfg, tokens[i * mb:(i + 1) * mb]), mode)
            logits = tail_stage(tail, cfg, wire_decode(ae, wire, mode, cfg.tdtype))
            if out is None:
                out = logits.new_empty((tokens.shape[0],) + tuple(logits.shape[1:]))
            out[i * mb:(i + 1) * mb] = logits
    return out


class _Link:
    """One direction of the pod-to-pod hop, as batched point-to-point ops on
    the pod group.  Under ``gloo`` a CUDA wire goes through two sets of
    pinned host buffers in turn (gloo sends host tensors only), so that one
    microbatch's copy can land while the other's transfer is in flight;
    under ``nccl``, or for tensors already on the host, it goes as it is."""

    def __init__(self, group, peer: int, device: torch.device):
        self.group, self.peer, self.device = group, peer, device
        self.staged = dist.get_backend(group) != "nccl" and device.type == "cuda"
        self.ring = [None, None]        # pinned buffers, made at first use
        self.copied = [None, None]      # events: a buffer's copy to the card is done

    def _buffers(self, i: int, specs: list) -> list:
        if self.ring[i % 2] is None:
            self.ring[i % 2] = [torch.empty(s, dtype=d, pin_memory=True) for s, d in specs]
        return self.ring[i % 2]

    def _ops(self, op, i: int, tensors) -> list:
        n = len(tensors)
        return dist.batch_isend_irecv([dist.P2POp(op, t, group=self.group, group_peer=self.peer,
                                                  tag=i * n + k) for k, t in enumerate(tensors)])

    def stage_out(self, i: int, wire: tuple) -> tuple:
        """Start microbatch ``i``'s wire on its way to the host (a no-op
        where nothing is staged).  Returns what :meth:`send` sends."""
        if not self.staged:
            return wire
        bufs = self._buffers(i, [(tuple(t.shape), t.dtype) for t in wire])
        for b, t in zip(bufs, wire):
            b.copy_(t, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        return tuple(bufs), ready

    def send(self, i: int, staged) -> tuple:
        """Send microbatch ``i`` (what :meth:`stage_out` returned); returns
        the works with the tensors they read, for :meth:`wait`."""
        if self.staged:
            staged, ready = staged
            ready.synchronize()
        return self._ops(dist.isend, i, staged), staged

    @staticmethod
    def wait(ops: tuple) -> None:
        """Wait for the works of :meth:`send` or :meth:`post_recv`."""
        for w in ops[0]:
            w.wait()

    def post_recv(self, i: int, specs: list) -> tuple:
        """Post the receive of microbatch ``i``; returns ``(works, buffers)``."""
        if self.staged:
            if self.copied[i % 2] is not None:
                self.copied[i % 2].synchronize()  # the buffer's last copy to the card is done
            bufs = self._buffers(i, specs)
        else:
            bufs = [torch.empty(s, dtype=d, device=self.device) for s, d in specs]
        return self._ops(dist.irecv, i, bufs), bufs

    def arrived(self, i: int, posted: tuple) -> tuple:
        """Wait for a posted receive; returns the wire on this rank's device."""
        self.wait(posted)
        bufs = posted[1]
        if not self.staged:
            return tuple(bufs)
        wire = tuple(b.to(self.device, non_blocking=True) for b in bufs)
        self.copied[i % 2] = torch.cuda.Event()
        self.copied[i % 2].record()
        return wire


def multipod_split_step(stage_tree: dict, cfg, batch: dict, mesh, *, ae: Optional[dict],
                        n_micro: int = 4, quantize_wire: bool = False):
    """2-stage pipelined forward across the ``pod`` axis of ``mesh`` (a
    ``DeviceMesh``; :func:`repro_torch.launch.mesh.make_mesh_compat`).

    Uniform stacks only (a period of one layer), with an even number of
    groups.  Pod 0 embeds, runs the first half of the blocks and encodes
    the residual stream with the bottleneck AE; the wire crosses to pod 1,
    which decodes it and runs the rest and the LM head.  Microbatches keep
    both pods busy, GPipe-style: the head sends microbatch i while it
    computes i + 1, and the tail receives i + 1 while it computes i.  Other
    mesh axes replicate the stage: rank (0, i) sends to rank (1, i).

    ``stage_tree`` is this pod's :func:`stage_params`, not the whole tree:
    splitting a model over cards means that no card holds all of it (the
    reference takes the whole tree because ``shard_map`` shards it).  The
    wire (``ae=None``: the model-dtype residual stream; ``ae``: the f32
    latent; with ``quantize_wire``: int8 codes and f32 row scales from the
    codec kernels) goes by ``dist.batch_isend_irecv`` on the pod group:
    under ``nccl`` from card to card, under ``gloo`` through pinned host
    buffers; the backend is the caller's.  Only head to tail: the
    reference also sends the tail's output back, and runs a drain wave on
    the head and a first wave on the tail whose results it discards.

    Returns the (B, S, V) logits on the tail's ranks and ``None`` on the
    head's.  The reference sums them over the pods so that every pod holds
    them; at llama3-8b's vocabulary, batch 8 and 2048 tokens they are 4.2
    GB in bf16, 125 times the int8 wire's bytes, so the port leaves them
    where they were made.  ``multipod_split_step.wire_bytes[mode]`` counts
    the bytes this rank sent in its last step of that wire mode."""
    _uniform_stack(cfg)
    if "pod" not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh axes {mesh.mesh_dim_names}: the pipeline runs on a 'pod' axis")
    pods = mesh.size(mesh.mesh_dim_names.index("pod"))
    if pods != 2:
        raise ValueError(f"the pipeline has 2 stages; the mesh's pod axis has {pods}")
    tokens, mb, seq = _microbatches(batch, n_micro)
    mode = _wire_mode(ae, quantize_wire)
    stage = mesh.get_local_rank("pod")
    device = tree_leaves(stage_tree["layers"])[0].device
    link = _Link(mesh.get_group("pod"), 1 - stage, device)
    if dist.get_backend(link.group) == "nccl" and device.type != "cuda":
        raise ValueError(f"nccl carries CUDA tensors only; the stage lies on {device}")
    with torch.no_grad():
        if stage == 0:
            tokens = tokens.to(device)
            pending, prev, sent = {}, None, 0
            for i in range(n_micro):
                wire = wire_encode(ae, head_stage(stage_tree, cfg, tokens[i * mb:(i + 1) * mb]),
                                   mode)
                sent += sum(t.numel() * t.element_size() for t in wire)
                if i - 2 in pending:    # microbatch i's buffers were i - 2's
                    link.wait(pending.pop(i - 2))
                staged = link.stage_out(i, wire)
                if not link.staged:
                    pending[i] = link.send(i, staged)
                    continue
                if prev is not None:    # send the last microbatch while this one computes
                    pending[i - 1] = link.send(i - 1, prev)
                prev = staged
            if prev is not None:
                pending[n_micro - 1] = link.send(n_micro - 1, prev)
            for sending in pending.values():
                link.wait(sending)
            multipod_split_step.wire_bytes[mode] = sent
            return None
        specs = _wire_specs(cfg, ae, mode, mb, seq)
        out = None
        posted = link.post_recv(0, specs)
        for i in range(n_micro):
            wire = link.arrived(i, posted)
            if i + 1 < n_micro:         # receive the next microbatch while this one computes
                posted = link.post_recv(i + 1, specs)
            logits = tail_stage(stage_tree, cfg, wire_decode(ae, wire, mode, cfg.tdtype))
            if out is None:
                out = logits.new_empty((tokens.shape[0],) + tuple(logits.shape[1:]))
            out[i * mb:(i + 1) * mb] = logits
        multipod_split_step.wire_bytes[mode] = 0
        return out


# bytes this rank sent in its last step, by wire mode (the head's wire; the
# tail sends nothing)
multipod_split_step.wire_bytes = dict.fromkeys(WIRE_MODES, 0)
