# Copied from src/repro/models/common.py:14-194, with torch dtypes in place of jnp.
"""Model configuration shared by every architecture in the zoo.

A single frozen dataclass describes all six families (dense / moe / ssm /
hybrid / encdec / vlm).  Family-specific fields are simply unused by the
others.  Configs live in ``repro_torch.configs`` and are plain instances of
:class:`ModelConfig`.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts sub-config (deepseek / qwen3 / jamba style)."""

    n_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN hidden dim
    n_shared: int = 0             # always-on shared experts (deepseek)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # load-balance auxiliary loss
    moe_every: int = 1            # apply MoE FFN every k-th layer (jamba: 2)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # one of FAMILIES
    n_layers: int                 # decoder layers
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                     # dense FFN hidden dim (MoE: see moe.d_expert)
    vocab: int
    head_dim: Optional[int] = None
    qkv_bias: bool = False        # qwen2 uses QKV bias
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    # hybrid (jamba): within each period of `attn_period` layers, exactly one
    # attention mixer (at index `attn_index`), the rest Mamba.
    attn_period: int = 0          # 0 => pure attention stack (dense/moe/..)
    attn_index: int = 0
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    # rwkv6
    rwkv_head_dim: int = 64
    rwkv_lora_dim: int = 32
    # encoder-decoder (whisper) / vlm frontends (stubbed per the brief)
    n_enc_layers: int = 0
    n_frames: int = 0             # audio frames delivered by the stub frontend
    n_patches: int = 0            # vision patches delivered by the stub frontend
    d_frontend: int = 0           # stub embedding dim before projector
    # serving variants
    sliding_window: Optional[int] = None  # beyond-paper sliding-window attn
    dtype: str = "bfloat16"
    # reference for where this config comes from (paper / model card)
    source: str = ""

    def __post_init__(self):
        assert self.family in FAMILIES, self.family

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def tdtype(self) -> torch.dtype:
        """The parameter and activation dtype as a torch dtype (the
        reference's ``jdtype``)."""
        return getattr(torch, self.dtype)

    @property
    def attn_free(self) -> bool:
        return self.family == "ssm"

    def is_attn_layer(self, i: int) -> bool:
        """Is decoder layer ``i`` an attention mixer (vs mamba)?"""
        if self.attn_free:
            return False
        if self.attn_period <= 0:
            return True
        return (i % self.attn_period) == self.attn_index

    def is_moe_layer(self, i: int) -> bool:
        if self.moe is None:
            return False
        return (i % self.moe.moe_every) == (self.moe.moe_every - 1)

    # ---- parameter counting (used by roofline MODEL_FLOPS and stats) ----
    def param_counts(self) -> dict:
        """Analytic parameter counts: total and "active" (MoE top-k only)."""
        d, hd = self.d_model, self.hd
        H, K = self.n_heads, self.n_kv_heads
        attn = d * (H * hd) + 2 * d * (K * hd) + (H * hd) * d
        if self.qkv_bias:
            attn += (H + 2 * K) * hd
        dense_ffn = 3 * d * self.d_ff
        per_layer_total = []
        per_layer_active = []
        for i in range(self.n_layers):
            mix = attn if self.is_attn_layer(i) else self._mamba_params()
            if self.family == "ssm":
                mix = self._rwkv_params()
                ffn_t = ffn_a = 2 * d * self.d_ff  # rwkv channel-mix: 2 mats
            elif self.is_moe_layer(i):
                m = self.moe
                ffn_t = 3 * d * m.d_expert * (m.n_experts + m.n_shared) + d * m.n_experts
                ffn_a = 3 * d * m.d_expert * (m.top_k + m.n_shared) + d * m.n_experts
            else:
                ffn_t = ffn_a = dense_ffn
            norms = 2 * d
            per_layer_total.append(mix + ffn_t + norms)
            per_layer_active.append(mix + ffn_a + norms)
        emb = self.vocab * d
        head = 0 if self.tie_embeddings else self.vocab * d
        enc = 0
        if self.family == "encdec":
            # encoder: self-attn + ffn; decoder additionally carries cross-attn
            enc = self.n_enc_layers * (attn + dense_ffn + 2 * d)
            per_layer_total = [p + attn + d for p in per_layer_total]
            per_layer_active = [p + attn + d for p in per_layer_active]
        proj = 2 * self.d_frontend * d if self.family == "vlm" else 0
        total = sum(per_layer_total) + emb + head + enc + proj + d
        active = sum(per_layer_active) + emb + head + enc + proj + d
        return {"total": total, "active": active, "embedding": emb + head}

    def _mamba_params(self) -> int:
        d = self.d_model
        di = self.mamba_expand * d
        ds = self.mamba_d_state
        return (d * 2 * di            # in_proj (x, z)
                + di * self.mamba_d_conv
                + di * (2 * ds + 1)   # B, C, dt data-dependent projections
                + di                  # dt bias
                + di * ds             # A (log)
                + di                  # D skip
                + di * d)             # out_proj

    def _rwkv_params(self) -> int:
        d = self.d_model
        lo = self.rwkv_lora_dim
        # r,k,v,g,o projections + decay/mix loras + per-head params
        return 5 * d * d + 2 * d * lo + 2 * lo * d + 6 * d


@dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A small same-family variant for CPU smoke tests (<=2 layers, d<=512)."""
    d_model = min(cfg.d_model, 128)
    n_heads = min(cfg.n_heads, 4)
    n_kv = max(1, min(cfg.n_kv_heads, n_heads))
    while n_heads % n_kv:
        n_kv -= 1
    small = dict(
        n_layers=2 if cfg.attn_period <= 0 else cfg.attn_period,
        d_model=d_model,
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=d_model // n_heads,
        d_ff=min(cfg.d_ff, 256),
        vocab=min(cfg.vocab, 512),
        n_enc_layers=min(cfg.n_enc_layers, 2),
        n_frames=min(cfg.n_frames, 16) if cfg.n_frames else 0,
        n_patches=min(cfg.n_patches, 8) if cfg.n_patches else 0,
        d_frontend=min(cfg.d_frontend, 64) if cfg.d_frontend else 0,
        name=cfg.name + "-reduced",
    )
    if cfg.moe is not None:
        small["moe"] = dataclasses.replace(
            cfg.moe, n_experts=min(cfg.moe.n_experts, 4),
            top_k=min(cfg.moe.top_k, 2), d_expert=min(cfg.moe.d_expert, 64),
            n_shared=min(cfg.moe.n_shared, 1))
    if cfg.family == "ssm":
        small["rwkv_head_dim"] = 32
        small["rwkv_lora_dim"] = 16
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
