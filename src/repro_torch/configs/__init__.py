"""Config registry (twin of ``repro/configs/__init__.py``):
``get_config("<arch-id>")`` knows the same ten names.

The port serves the ``dense``, ``ssm`` and ``hybrid`` families.  A name of
another family raises ``NotImplementedError`` until its modules are ported:
MoE in ROADMAP A13b, encoder-decoder and VLM in A17.  jamba-v0.1-52b's
config carries its MoE; building it raises at the first MoE layer (A13b),
and the port serves it with the changes in ``SERVED``
(``dataclasses.replace(cfg, moe=None)``, every FFN the dense SwiGLU).
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
    "qwen3-moe-235b-a22b": "moe",
}
# the ROADMAP item that ports each family
ROADMAP_ITEM = {"moe": "A13b", "encdec": "A17", "vlm": "A17"}
# what the port changes in a config to serve it: jamba's MoE layers wait for
# ROADMAP A13b, so every FFN is the dense SwiGLU
SERVED = {"jamba-v0.1-52b": {"moe": None}}


def get_config(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    if name in UNPORTED:
        family = UNPORTED[name]
        raise NotImplementedError(f"{name} is of the {family} family, which the port does "
                                  f"not serve yet (ROADMAP {ROADMAP_ITEM[family]})")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")
    return mod.CONFIG
