"""Plain PyTorch versions of the port's kernels (twin of
``repro/kernels/ref.py``: the bottleneck oracles at ``:33-59``,
``flash_attention_ref`` at ``:11``, ``rwkv6_scan_ref`` at ``:62`` and
``mamba_scan_ref`` at ``:79``).

The kernel wrappers use them for tensors on the CPU, the tests hold them
against the JAX package's Pallas kernels, and ``chip_smoke.py`` holds the
CUDA kernels against them on the card.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

NEG_INF = -1e30


def check_lengths(sq: int, sk: int, causal: bool, window: Optional[int]) -> None:
    """Queries sit at the last Sq of Sk key positions, so Sq > Sk is taken
    only where neither mask reads a position (a cross-attention): under a
    causal or window mask the first Sq - Sk rows would see no key, which the
    TPU kernel writes as 0 (``repro/kernels/flash_attention.py:73, :82``)
    and a plain softmax as the mean of v."""
    if sq > sk and (causal or window is not None):
        raise ValueError(f"queries sit at the last Sq of Sk key positions: Sq {sq} > Sk {sk} "
                         f"takes neither a causal nor a window mask")


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        window: Optional[int] = None) -> torch.Tensor:
    """Plain softmax attention with GQA.

    q: (B, Sq, H, D); k, v: (B, Sk, K, D) with H % K == 0.  Queries sit at
    the last Sq key positions (:func:`check_lengths`).  f32 math, output in
    q's dtype.
    """
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    check_lengths(sq, sk, causal, window)
    g = h // kh
    k = torch.repeat_interleave(k, g, dim=2)
    v = torch.repeat_interleave(v, g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    qp = torch.arange(sq, device=q.device)[:, None] + (sk - sq)   # aligned last positions
    kp = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def flash_edge_probe(b, sq, sk, h, kh, d, *, rising: bool, seed: int = 0,
                     dtype=torch.bfloat16, device="cpu") -> tuple:
    """Inputs (q, k, v) on which attention picks one key a row.

    Every score is +-256 * key position (``rising`` or not), the sum of
    65536 * (position // 256) and 256 * (position % 256), whose factors bf16
    holds exactly, so the f32 dot products are exact for positions below
    65536.  Neighbouring keys' softmax weights then differ by a factor of
    e**(256 / sqrt(d)), over 8e6 at d <= 256: each output row is the v row
    of its last live key (rising: the causal or the key-range edge) or of
    its first (falling: the window's edge), and a key off by one at that
    edge moves the row by the difference of two random v rows, far above
    the bf16 bar of 2e-2.
    """
    sign = 1.0 if rising else -1.0
    q = np.zeros((b, sq, h, d), np.float32)
    q[..., 0], q[..., 1] = sign * 65536.0, sign * 256.0
    pos = np.arange(sk)
    k = np.zeros((b, sk, kh, d), np.float32)
    k[..., 0] = (pos // 256)[None, :, None]
    k[..., 1] = (pos % 256)[None, :, None]
    v = np.random.default_rng(seed).standard_normal((b, sk, kh, d)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device=device, dtype=dtype) for a in (q, k, v))


def rwkv6_scan_ref(r, k, v, w, u, state):
    """Sequential WKV-6 recurrence, a Python loop over time.

    r, k, v, w: (B, S, H, D) f32; u: (H, D); state: (B, H, D, D).
    out_t = r_t . (S + u*k_t v_t^T);  S <- diag(w_t) S + k_t v_t^T.
    Returns (out (B, S, H, D), final state (B, H, D, D)).
    """
    s = state
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]
        kv = kt[..., :, None] * vt[..., None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", rt, s + u[..., None] * kv))
        s = wt[..., None] * s + kv
    return torch.stack(outs, dim=1), s


def mamba_scan_ref(dt, b, c, x, a, state):
    """Sequential Mamba selective scan, a Python loop over time.

    dt, x: (B, S, di) f32; b, c: (B, S, ds) f32; a: (di, ds) f32 (negative);
    state: (B, di, ds) f32.
    h_t = exp(dt_t a) h_{t-1} + (dt_t x_t) b_t;  y_t = h_t . c_t.
    Unlike the reference's oracle, which starts from zero and returns y
    alone, it starts from ``state`` and returns (y (B, S, di), final state).
    """
    h = state
    ys = []
    for t in range(dt.shape[1]):
        dt_t, b_t, c_t, x_t = dt[:, t], b[:, t], c[:, t], x[:, t]
        da = torch.exp(dt_t[..., None] * a)                   # (B, di, ds)
        h = da * h + (dt_t * x_t)[..., None] * b_t[:, None, :]
        ys.append(torch.einsum("bds,bs->bd", h, c_t))
    return torch.stack(ys, dim=1), h


def bottleneck_compress_ref(f, w, b, *, scale: float = 127.0):
    """Encoder projection + ReLU + symmetric per-row int8 quantisation.

    f: (N, C); w: (C, L); b: (L,).  Returns (q int8 (N, L), s f32 (N, 1)).
    ``torch.round`` rounds half to even, as ``jnp.round`` does.
    """
    z = torch.relu(f.float() @ w.float() + b.float())
    amax = z.abs().amax(dim=-1, keepdim=True)
    s = torch.where(amax > 0, amax / scale, torch.ones_like(amax))
    q = torch.clamp(torch.round(z / s), -127, 127).to(torch.int8)
    return q, s.float()


def bottleneck_decompress_ref(q, s):
    return q.float() * s


def bottleneck_decode_ref(q, s, w, b):
    """Dequantisation + AE-decoder projection.

    q: (N, L) int8; s: (N, 1) f32; w: (L, C); b: (C,).  Returns f32 (N, C).
    """
    z = q.float() * s.float()
    return z @ w.float() + b.float()
