"""Config registry (twin of ``repro/configs/__init__.py``):
``get_config("<arch-id>")`` knows the same ten names.

The port serves the ``dense`` and ``ssm`` families; a name of another
family (MoE, hybrid, encoder-decoder, VLM) raises ``NotImplementedError``
until its modules are ported (ROADMAP A13).
"""
from __future__ import annotations

import importlib

ARCHS = {
    "llama3.2-3b": "llama3_2_3b",
    "command-r-35b": "command_r_35b",
    "internvl2-76b": "internvl2_76b",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "whisper-tiny": "whisper_tiny",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "qwen2-72b": "qwen2_72b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "llama3-8b": "llama3_8b",
}
# the family of each name the port does not serve yet
UNPORTED = {
    "internvl2-76b": "vlm",
    "deepseek-moe-16b": "moe",
    "whisper-tiny": "encdec",
    "jamba-v0.1-52b": "hybrid",
    "qwen3-moe-235b-a22b": "moe",
}


def get_config(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    if name in UNPORTED:
        raise NotImplementedError(f"{name} is of the {UNPORTED[name]} family, which the "
                                  "port does not serve yet (ROADMAP A13)")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")
    return mod.CONFIG
