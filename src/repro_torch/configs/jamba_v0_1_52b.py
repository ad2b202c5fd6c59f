# Copied from src/repro/configs/jamba_v0_1_52b.py.
"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2
every 2nd layer [arXiv:2403.19887]."""
from repro_torch.models.common import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    head_dim=128, d_ff=14336, vocab=65536,
    qkv_bias=False, rope_theta=10000.0,
    attn_period=8, attn_index=4,
    mamba_d_state=16, mamba_d_conv=4, mamba_expand=2,
    moe=MoEConfig(n_experts=16, top_k=2, d_expert=14336, moe_every=2),
    source="arXiv:2403.19887",
)
