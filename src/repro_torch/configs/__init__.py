"""Config registry (twin of ``repro/configs/__init__.py``):
``get_config("<arch-id>")`` knows the same ten names.

The port serves every config of the zoo, in every family: ``dense``,
``moe``, ``ssm``, ``hybrid``, ``encdec`` (whisper-tiny) and ``vlm``
(internvl2-76b).  jamba-v0.1-52b's config carries its MoE and builds with
it; the card serves it whole with the changes in ``SERVED``
(``dataclasses.replace(cfg, moe=None)``, every FFN the dense SwiGLU), and
with its MoE at a depth cut.
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
# what the port changes in a config to serve it whole on one card: jamba
# with its MoE (51.5 B parameters, 103 GB in bf16) does not fit one, so its
# full-depth run makes every FFN the dense SwiGLU; its MoE layers run on the
# card at a depth cut of the config as it stands
SERVED = {"jamba-v0.1-52b": {"moe": None}}


def get_config(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")
    return mod.CONFIG


def all_configs() -> dict:
    return {name: get_config(name) for name in ARCHS}
