"""The four assigned input shapes and ``meta``-tensor stand-ins for
dry-runs (twin of ``repro/configs/shapes.py``).

``input_specs`` builds allocation-free inputs for every (arch x shape)
combination: where the reference makes ``jax.ShapeDtypeStruct``s, the port
makes tensors on ``torch.device("meta")``, which carry a shape and a dtype
and no memory.  Decode shapes give the arguments of ``serve_step`` (one
token and a seq_len cache); train and prefill shapes give full-sequence
batches.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig, ShapeConfig

SHAPES = {
    "train_4k": ShapeConfig("train_4k", seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524288, global_batch=1, kind="decode"),
}

# the variant that makes long_500k runnable for the full-attention families:
# ring-buffer sliding-window attention
LONG_CONTEXT_WINDOW = 8192


def variant_for_shape(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """The architecture variant run at this shape: at long_500k every family
    but ``ssm`` (no attention) and ``hybrid`` (full attention on its few
    attention layers) gets the sliding window."""
    if shape.name == "long_500k" and cfg.family not in ("ssm", "hybrid"):
        return dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def text_len(cfg: ModelConfig, seq_len: int) -> int:
    """A VLM splits the sequence budget between patches and text."""
    if cfg.family == "vlm":
        return seq_len - cfg.n_patches
    return seq_len


def batch_struct(cfg: ModelConfig, shape: ShapeConfig, *, with_labels: bool) -> dict:
    b, s = shape.global_batch, shape.seq_len
    st = text_len(cfg, s)
    batch = {"tokens": _meta((b, st), torch.int32)}
    if cfg.family == "vlm":
        batch["patch_embeds"] = _meta((b, cfg.n_patches, cfg.d_frontend), cfg.tdtype)
    if cfg.family == "encdec":
        batch["frames"] = _meta((b, cfg.n_frames, cfg.d_frontend), cfg.tdtype)
    if with_labels:
        batch["labels"] = _meta((b, st), torch.int32)
    return batch


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Abstract inputs for the step function ``shape.kind`` selects.

    train  -> {"batch": {...}}                              (train_step)
    prefill-> {"batch": {...}}                              (prefill)
    decode -> {"cache": ..., "token": ..., "pos": ...}      (serve_step)
    """
    cfg = variant_for_shape(cfg, shape)
    if shape.kind == "train":
        return {"batch": batch_struct(cfg, shape, with_labels=True)}
    if shape.kind == "prefill":
        return {"batch": batch_struct(cfg, shape, with_labels=False)}
    # decode: a cache at seq_len occupancy, one new token
    b = shape.global_batch
    return {
        "cache": T.cache_spec(cfg, b, shape.seq_len),
        "token": _meta((b, 1), torch.int32),
        "pos": _meta((), torch.int32),
    }


def params_struct(cfg: ModelConfig) -> dict:
    """The abstract parameter tree (no allocation)."""
    return T.param_spec(cfg)
