# Copied from src/repro/configs/command_r_35b.py.
"""command-r-35b [dense] — GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01]."""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b", family="dense",
    n_layers=40, d_model=8192, n_heads=64, n_kv_heads=8,
    head_dim=128, d_ff=22528, vocab=256000,
    rope_theta=8000000.0, qkv_bias=False,
    source="hf:CohereForAI/c4ai-command-r-v01",
)
