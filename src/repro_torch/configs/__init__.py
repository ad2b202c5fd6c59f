"""Config registry (twin of ``repro/configs/__init__.py``):
``get_config("<arch-id>")`` knows the same ten names.

The port serves every family of the zoo: ``dense``, ``moe``, ``ssm``,
``hybrid``, ``encdec`` (whisper-tiny) and ``vlm`` (internvl2-76b).  A name
in ``UNPORTED`` raises ``NotImplementedError`` naming the ROADMAP item that
serves it: qwen3-moe-235b-a22b waits for a depth cut and its attention
shape on the card (A13d).  jamba-v0.1-52b's config carries its MoE and
builds with it; the card serves it with the changes in ``SERVED``
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
# each name the port does not serve yet: (its family, the ROADMAP item)
UNPORTED = {"qwen3-moe-235b-a22b": ("moe", "A13d")}
# what the port changes in a config to serve it on one card: jamba with its
# MoE (51.5 B parameters, 103 GB in bf16) does not fit one, so every FFN is
# the dense SwiGLU until its MoE layers run at a depth cut (ROADMAP A13c)
SERVED = {"jamba-v0.1-52b": {"moe": None}}


def get_config(name: str):
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    if name in UNPORTED:
        family, item = UNPORTED[name]
        raise NotImplementedError(f"{name} (of the {family} family) is not served by the "
                                  f"port yet (ROADMAP {item})")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[name]}")
    return mod.CONFIG
