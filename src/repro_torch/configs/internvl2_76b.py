# Copied from src/repro/configs/internvl2_76b.py.
"""internvl2-76b [vlm] — InternViT(stub) + InternLM2 backbone [arXiv:2404.16821].

The InternViT-6B vision tower is a stub per the brief: ``input_specs``
delivers pre-extracted patch embeddings (B, 256, 3200); the 2-layer MLP
projector + 80-layer language decoder are fully implemented.
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    head_dim=128, d_ff=28672, vocab=128256,
    rope_theta=1000000.0, qkv_bias=False,
    n_patches=256, d_frontend=3200,
    source="arXiv:2404.16821",
)
