"""The ops the models call (twin of ``repro/kernels/ops.py``).

Each forwards to its kernel's wrapper, which dispatches on the tensor's
device: the plain version for a CPU tensor, the CUDA kernel for a CUDA
tensor.  There is no ``force`` and no platform probe.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.bottleneck_compress import bottleneck_compress
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.kernels.rwkv6_scan import rwkv6_scan


def attention_op(q, k, v, *, causal: bool = True, window: Optional[int] = None):
    return flash_attention(q, k, v, causal=causal, window=window)


def compress_op(f, w, b):
    return bottleneck_compress(f, w, b)


def decompress_op(q, s):
    """Dequantise: ``q * s`` in f32.  As in the reference, no kernel: the
    fused dequantise-and-project kernel is ``bottleneck_decompress``."""
    return ref.bottleneck_decompress_ref(q, s)


def wkv_op(r, k, v, w, u, state=None):
    """WKV-6 from ``state`` (zeros when None, as the reference's op starts)."""
    if state is None:
        b, _, h, d = r.shape
        state = torch.zeros((b, h, d, d), dtype=torch.float32, device=r.device)
    return rwkv6_scan(r, k, v, w, u, state)


def mamba_scan_op(dt, b, c, x, a, state=None):
    """The selective scan from ``state`` (zeros when None, as the
    reference's op starts).  Returns (y, final state)."""
    if state is None:
        bsz, _, di = dt.shape
        state = torch.zeros((bsz, di, b.shape[-1]), dtype=torch.float32, device=dt.device)
    return mamba_scan(dt, b, c, x, a, state)
