# Copied from src/repro/configs/qwen3_moe_235b_a22b.py.
"""qwen3-moe-235b-a22b [moe] — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B family]."""
from repro_torch.models.common import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    head_dim=128, d_ff=1536, vocab=151936,
    rope_theta=1000000.0, qkv_bias=False,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=1536),
    source="hf:Qwen/Qwen3-30B-A3B (235B-A22B sibling)",
)
