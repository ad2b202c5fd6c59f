# Copied from src/repro/configs/rwkv6_1_6b.py.
"""rwkv6-1.6b [ssm] — Finch, data-dependent decay, attention-free
[arXiv:2404.05892]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,  # informational
    d_ff=7168, vocab=65536,
    rwkv_head_dim=64, rwkv_lora_dim=32,
    source="arXiv:2404.05892",
)
