# Copied from src/repro/configs/qwen2_72b.py.
"""qwen2-72b [dense] — GQA with QKV bias [arXiv:2407.10671]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-72b", family="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    head_dim=128, d_ff=29568, vocab=152064,
    rope_theta=1000000.0, qkv_bias=True,
    source="arXiv:2407.10671",
)
