# Copied from src/repro/configs/whisper_tiny.py.
"""whisper-tiny [audio] — enc-dec, conv frontend stubbed [arXiv:2212.04356].

The mel-spectrogram + conv feature extractor is a stub: ``input_specs``
provides precomputed frame embeddings (B, 1500, 384).  Encoder (4L,
learned positions) + decoder (4L, self-attn KV cache + cross-attn cache)
are fully implemented.  Assigned decode seq-lens exceed Whisper's real
448-token context; the backbone honours them (DESIGN.md §4).
"""
from repro_torch.models.common import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="encdec",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    head_dim=64, d_ff=1536, vocab=51865,
    rope_theta=10000.0, qkv_bias=True,
    n_enc_layers=4, n_frames=1500, d_frontend=384,
    source="arXiv:2212.04356",
)
