"""Shared transformer primitives: RMSNorm, LayerNorm, RoPE, GQA attention,
SwiGLU and GELU MLPs (twin of ``repro/models/layers.py``).

Parameters are plain dicts of tensors in the reference's layouts: dense
weights are (in, out), q/k/v are (B, S, H, D).  Attention over a sequence
(self- and cross-attention) goes through ``ops.attention_op``, the
``flash_attention`` kernel on the card; one-token decode attention stays
plain PyTorch, as the reference computes it outside any Pallas kernel.
Where the reference mixes dtypes (f32 frames or patches fed to a bf16
model), JAX promotes to f32; ``dense`` and ``attention`` do the same, since
``torch`` products refuse mixed operands.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

NEG_INF = -1e30


# ---------------------------------------------------------------- norms ----
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    xc = x - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    return (xc * torch.rsqrt(var + eps) * w.float() + b.float()).to(dt)


# ----------------------------------------------------------------- rope ----
def rope_tables(positions: torch.Tensor, head_dim: int, theta: float) -> tuple:
    """cos/sin tables for the given absolute positions: (..., head_dim//2)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=positions.device) / head_dim
    freqs = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B,S,H,D); cos/sin: (B,S,D/2) or (S,D/2)."""
    dt = x.dtype
    x = x.float()
    x1, x2 = x.chunk(2, dim=-1)
    if cos.dim() == 2:  # (S, D/2) -> broadcast over batch
        cos, sin = cos[None, :, None, :], sin[None, :, None, :]
    else:               # (B, S, D/2)
        cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).to(dt)


# ------------------------------------------------------------ attention ----
def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B,S,K,D) -> (B,S,K*n_rep,D) by repeating each kv head."""
    if n_rep == 1:
        return k
    b, s, kh, d = k.shape
    return k[:, :, :, None, :].expand(b, s, kh, n_rep, d).reshape(b, s, kh * n_rep, d)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool = True,
              window: Optional[int] = None) -> torch.Tensor:
    """Multi-head GQA self-attention over a sequence.

    q: (B,Sq,H,D); k,v: (B,Sk,K,D) with H % K == 0.  Returns (B,Sq,H,D).
    The kernel takes the kv heads as they are (no ``repeat_kv``).  In bf16
    it rounds the softmax weights to bf16 before the P.V product, as the
    reference's chunked path (Sq*Sk > 512**2) does; in f32, and in the
    plain version on the CPU, they stay f32.  As the reference's plain
    path, a single query is not causally masked: it sits at the last key
    position, so the mask would change nothing.  Mixed dtypes (bf16 queries
    over keys from f32 frames) run in the promoted dtype, the output in q's,
    as the reference computes them.
    """
    dt = q.dtype
    if not q.dtype == k.dtype == v.dtype:
        ct = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
        q, k, v = q.to(ct), k.to(ct), v.to(ct)
    out = ops.attention_op(q, k, v, causal=causal and q.shape[1] > 1, window=window)
    return out.to(dt)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     kv_pos: torch.Tensor, q_pos: torch.Tensor,
                     window: Optional[int] = None) -> torch.Tensor:
    """One-token attention against a cache.

    q: (B,1,H,D); caches: (B,S,K,D); kv_pos: (B,S) absolute position of every
    cache slot (-1 for empty; ring buffers permute positions arbitrarily);
    q_pos: (B,) absolute position of the new token.
    """
    b, _, h, d = q.shape
    kh = k_cache.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, kh, g, d).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * scale
    valid = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
    if window is not None:
        valid &= kv_pos > (q_pos[:, None] - window)
    s = s.masked_fill(~valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(b, 1, h, d).to(q.dtype)


def decode_attention_partial(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                             kv_pos: torch.Tensor, q_pos: torch.Tensor,
                             window: Optional[int] = None) -> tuple:
    """:func:`decode_attention` over a part of the cache's slots (a rank's
    block of a slot axis cut over a mesh), unnormalised across parts:
    ``(out, lse)``, out (B,1,H,D) f32 the softmax-weighted values over the
    part's live slots, lse (B,H) f32 the log of its scores' exp-sum.  A
    part with no live slot gives out 0 and lse -inf, not NaN.
    :func:`combine` merges the parts as one softmax over every slot."""
    b, _, h, d = q.shape
    kh = k_cache.shape[2]
    g = h // kh
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, kh, g, d).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float()) * scale
    valid = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
    if window is not None:
        valid &= kv_pos > (q_pos[:, None] - window)
    s = s.masked_fill(~valid[:, None, None, :], -math.inf)
    top = s.amax(dim=-1, keepdim=True)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    p = torch.exp(s - top)
    total = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    out = out / torch.where(total > 0, total, torch.ones_like(total))
    lse = (top + torch.log(total))[..., 0]
    return out.reshape(b, 1, h, d), lse.reshape(b, h)


def combine(outs: torch.Tensor, lses: torch.Tensor) -> torch.Tensor:
    """The parts of :func:`decode_attention_partial` merged: outs (n, ...,
    D) and lses (n, ...) of n parts of the slots, each weighted by its
    share of the exp-sum over all of them; f32.  Parts with lse -inf weigh
    0, so a part must hold a slot once: a slot two parts hold counts twice."""
    top = lses.amax(dim=0)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    w = torch.exp(lses - top)
    total = w.sum(dim=0)
    out = (w[..., None] * outs).sum(dim=0)
    return out / torch.where(total > 0, total, torch.ones_like(total))[..., None]


# ---------------------------------------------------------------- linear ----
def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    if x.dtype != w.dtype:           # JAX promotes a mixed product
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    y = x @ w
    if b is not None:
        y = y + b
    return y


def swiglu(x: torch.Tensor, p: dict) -> torch.Tensor:
    """SwiGLU MLP: p = {w_gate, w_up, w_down}."""
    return dense(F.silu(dense(x, p["w_gate"])) * dense(x, p["w_up"]), p["w_down"])


def gelu_mlp(x: torch.Tensor, p: dict) -> torch.Tensor:
    """GELU MLP (whisper-style): p = {w_in, b_in, w_out, b_out}.  The tanh
    form: ``jax.nn.gelu`` defaults to ``approximate=True``."""
    h = F.gelu(dense(x, p["w_in"], p["b_in"]), approximate="tanh")
    return dense(h, p["w_out"], p["b_out"])


# ------------------------------------------------------------------ init ----
def init_dense(gen, fan_in: int, fan_out: int, dtype, device) -> torch.Tensor:
    std = 1.0 / math.sqrt(fan_in)
    w = torch.randn((fan_in, fan_out), generator=gen, dtype=torch.float32, device=device)
    return (w * std).to(dtype)


def init_attn(gen, cfg, device, with_bias=None, cross=False) -> dict:
    """GQA attention params.  cross=True: whisper's cross-attention, MHA
    (as many kv heads as query heads) in the same layout."""
    d, h, kh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    if cross:
        kh = h
    dt = cfg.tdtype
    p = {
        "wq": init_dense(gen, d, h * hd, dt, device),
        "wk": init_dense(gen, d, kh * hd, dt, device),
        "wv": init_dense(gen, d, kh * hd, dt, device),
        "wo": init_dense(gen, h * hd, d, dt, device),
    }
    bias = cfg.qkv_bias if with_bias is None else with_bias
    if bias:
        p["bq"] = torch.zeros((h * hd,), dtype=dt, device=device)
        p["bk"] = torch.zeros((kh * hd,), dtype=dt, device=device)
        p["bv"] = torch.zeros((kh * hd,), dtype=dt, device=device)
    return p


def init_swiglu(gen, d_model: int, d_ff: int, dtype, device) -> dict:
    return {"w_gate": init_dense(gen, d_model, d_ff, dtype, device),
            "w_up": init_dense(gen, d_model, d_ff, dtype, device),
            "w_down": init_dense(gen, d_ff, d_model, dtype, device)}


def init_gelu_mlp(gen, d_model: int, d_ff: int, dtype, device) -> dict:
    return {"w_in": init_dense(gen, d_model, d_ff, dtype, device),
            "b_in": torch.zeros((d_ff,), dtype=dtype, device=device),
            "w_out": init_dense(gen, d_ff, d_model, dtype, device),
            "b_out": torch.zeros((d_model,), dtype=dtype, device=device)}
