# Copied from src/repro/configs/llama3_8b.py.
"""llama3-8b [dense] — GQA, 128k vocab [arXiv:2407.21783]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama3-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    head_dim=128, d_ff=14336, vocab=128256,
    rope_theta=500000.0, qkv_bias=False,
    source="arXiv:2407.21783",
)
