"""Mixture-of-Experts FFN with group-local capacity dispatch (twin of
``repro/models/moe.py``).

Covers the three MoE flavours of the zoo:
  * deepseek-moe-16b : 2 shared + 64 routed, top-6, fine-grained experts
  * qwen3-moe-235b   : 128 routed, top-8, no shared experts
  * jamba-v0.1-52b   : 16 routed, top-2, MoE every 2nd layer

Tokens are routed in groups of at most ``group_chunk``; each expert takes
``group_capacity(chunk)`` tokens of a group and drops the rest, as the
reference does.  Every routing rule is the reference's:

* the router is held and applied in f32, softmax in f32;
* the top k by a stable descending sort, so a tie goes to the lower expert
  index, as ``jax.lax.top_k`` breaks it (``torch.topk`` promises no order);
* the k gates renormalised with the ``1e-9`` floor;
* an expert's capacity positions counted over the group's (token, choice)
  pairs in token-major order, a pair kept where its position is below the
  capacity.

Where the reference builds one-hot dispatch and combine matrices and
contracts them with einsums, the port moves rows by index: each kept pair's
token row is copied into its expert's slot of an ``(E, G*C, D)`` buffer,
each expert weight is one batched product over it (``torch.bmm``), and
each token gathers its k rows back.  A copy by index moves values exactly,
as a product with a 0/1 matrix does, and costs no FLOPs: at deepseek's
prefill the one-hot einsums would cost about as much as the experts.  The
gates are rounded to the model dtype before the combine, which sums a
token's k rows in f32 and rounds once.  A Switch-style load-balance
auxiliary loss is returned alongside the output.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import init_dense, init_swiglu, swiglu

GROUP_CHUNK = 2048  # tokens per dispatch group


def _stack_expert(gen, e: int, fan_in: int, fan_out: int, dtype, device) -> torch.Tensor:
    """``e`` dense weights (E, fan_in, fan_out), each at ``init_dense``'s scale."""
    w = torch.randn((e, fan_in, fan_out), generator=gen, dtype=torch.float32, device=device)
    return (w * (1.0 / math.sqrt(fan_in))).to(dtype)


def init_moe(gen, d_model: int, m, dtype, device) -> dict:
    """The reference's tree: ``router`` (D, E) f32; ``w_gate``, ``w_up``
    (E, D, F) and ``w_down`` (E, F, D) in ``dtype``, ``w_down`` drawn as
    (E, D, F) at 1/sqrt(D) and swapped, as the reference draws it; ``shared``
    (a SwiGLU of width F * n_shared) where the config has shared experts."""
    e = m.n_experts
    p = {
        "router": init_dense(gen, d_model, e, torch.float32, device),
        "w_gate": _stack_expert(gen, e, d_model, m.d_expert, dtype, device),
        "w_up": _stack_expert(gen, e, d_model, m.d_expert, dtype, device),
        "w_down": _stack_expert(gen, e, d_model, m.d_expert, dtype, device)
        .transpose(1, 2).contiguous(),
    }
    if m.n_shared:
        p["shared"] = init_swiglu(gen, d_model, m.d_expert * m.n_shared, dtype, device)
    return p


def group_capacity(tokens_per_group: int, m) -> int:
    return max(1, int(tokens_per_group * m.top_k / m.n_experts * m.capacity_factor))


def groups(x: torch.Tensor, group_chunk: int = GROUP_CHUNK) -> torch.Tensor:
    """x: (B,S,D) -> (G, chunk, D), the dispatch groups: ``chunk`` is the
    largest divisor of S up to ``group_chunk``."""
    b, s, d = x.shape
    chunk = min(group_chunk, s)
    while s % chunk:
        chunk -= 1
    return x.reshape(b * (s // chunk), chunk, d)


class Routing(NamedTuple):
    probs: torch.Tensor     # (G,T,E) f32, the router's softmax
    gates: torch.Tensor     # (G,T,k) f32, renormalised over the k choices
    experts: torch.Tensor   # (G,T,k) int64, by descending prob, ties to the lower index
    slot: torch.Tensor      # (G,T,k) int64, the pair's capacity slot; -1 where dropped


def route(xg: torch.Tensor, router: torch.Tensor, m) -> Routing:
    """Route the groups ``xg`` (G,T,D) at ``group_capacity(T)``."""
    g, t, _ = xg.shape
    e, k = m.n_experts, m.top_k
    probs = torch.softmax(xg.float() @ router, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = vals[..., :k], idx[..., :k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    # an expert's pairs counted in (token, choice) order: the pair's
    # position is the count up to it, less one.  The count runs along the
    # innermost axis, (G, E, T*k): on an H100 a scan along an outer axis
    # took a third of deepseek-moe-16b's bf16 prefill
    flat = experts.reshape(g, 1, t * k)
    onehot = torch.zeros((g, e, t * k), dtype=torch.int32, device=xg.device)
    pos = onehot.scatter_(1, flat, 1).cumsum(2, dtype=torch.int32).gather(1, flat)
    pos = pos.reshape(g, t, k).long() - 1
    slot = torch.where(pos < group_capacity(t, m), pos, -1)
    return Routing(probs, gates, experts, slot)


def dropped_pairs(x: torch.Tensor, p: dict, m, *, group_chunk: int = GROUP_CHUNK) -> torch.Tensor:
    """The (token, expert) pairs ``moe_ffn(x, p, m, group_chunk=...)`` drops
    at capacity, as a 0-d tensor."""
    return (route(groups(x, group_chunk), p["router"], m).slot < 0).sum()


def moe_ffn(x: torch.Tensor, p: dict, m, *,
            group_chunk: int = GROUP_CHUNK) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,D) -> (out (B,S,D), aux_loss f32 scalar)."""
    b, s, d = x.shape
    xg = groups(x, group_chunk)
    g, t, _ = xg.shape
    e, k = m.n_experts, m.top_k
    r = route(xg, p["router"], m)
    cap = group_capacity(t, m)
    rows = g * cap                           # each expert's slots over all groups
    kept = r.slot >= 0
    # each pair's row in the (E * G * C) buffer; a dropped pair goes to a
    # spare row past the end, which no expert reads
    group = torch.arange(g, device=x.device)[:, None, None] * cap
    dest = torch.where(kept, r.experts * rows + group + r.slot, e * rows)
    buf = x.new_zeros((e * rows + 1, d))
    buf[dest.reshape(-1)] = xg[:, :, None, :].expand(g, t, k, d).reshape(-1, d)
    expert_in = buf[:-1].view(e, rows, d)
    h = F.silu(torch.bmm(expert_in, p["w_gate"])) * torch.bmm(expert_in, p["w_up"])
    expert_out = torch.bmm(h, p["w_down"]).reshape(e * rows, d)
    # each token's k rows back, a dropped pair's from a zero row
    picked = torch.cat([expert_out, expert_out.new_zeros((1, d))])[dest]   # (G,T,k,D)
    w = torch.where(kept, r.gates.to(x.dtype), 0).float()
    out = (w[..., None] * picked.float()).sum(2).to(x.dtype).reshape(b, s, d)

    if m.n_shared:
        out = out + swiglu(x, p["shared"])

    # Switch-style load-balance loss: E * sum_e f_e * p_e
    top1 = r.experts[..., 0].reshape(-1)
    counts = torch.zeros((e,), dtype=torch.float32, device=x.device).scatter_add_(
        0, top1, torch.ones_like(top1, dtype=torch.float32))
    mean_probs = r.probs.reshape(-1, e).mean(0)
    aux = e * torch.sum(counts / top1.numel() * mean_probs)
    return out, aux
