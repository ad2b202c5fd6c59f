# Copied from src/repro/configs/deepseek_moe_16b.py.
"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6, fine-grained experts
[arXiv:2401.06066].  Deviation: the reference model's first layer is a dense
FFN; we keep all 28 layers MoE for a uniform scan stack (the 2 shared
experts provide the dense path) — noted in DESIGN.md.
"""
from repro_torch.models.common import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    head_dim=128, d_ff=1408, vocab=102400,
    rope_theta=10000.0, qkv_bias=False,
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
    source="arXiv:2401.06066",
)
