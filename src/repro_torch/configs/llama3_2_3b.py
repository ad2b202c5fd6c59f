# Copied from src/repro/configs/llama3_2_3b.py.
"""llama3.2-3b [dense] — small llama3 [hf:meta-llama/Llama-3.2-1B family]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
    head_dim=128, d_ff=8192, vocab=128256,
    rope_theta=500000.0, qkv_bias=False,
    source="hf:meta-llama/Llama-3.2-1B (3B sibling)",
)
