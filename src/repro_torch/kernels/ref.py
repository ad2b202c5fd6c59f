"""Plain PyTorch versions of the port's kernels (twin of
``repro/kernels/ref.py``: the bottleneck oracles at ``:33-59``,
``flash_attention_ref`` at ``:11``, ``rwkv6_scan_ref`` at ``:62`` and
``mamba_scan_ref`` at ``:79``), of the row log-sum-exp the flash forward
keeps for its backward (``flash_attention_lse_ref``), and of the three
backward kernels, which have no reference twin: ``flash_attention_bwd_ref``,
``rwkv6_scan_bwd_ref`` and ``mamba_scan_bwd_ref``.

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


def attention_mask(sq, sk, causal, window, device):
    """(Sq, Sk) bool: the keys each query sees, queries at the last Sq keys."""
    qp = torch.arange(sq, device=device)[:, None] + (sk - sq)
    kp = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= kp > qp - window
    return mask


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
    s = s.masked_fill(~attention_mask(sq, sk, causal, window, q.device), NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def flash_attention_lse_ref(q, k, *, causal: bool = True,
                            window: Optional[int] = None) -> torch.Tensor:
    """(B, H, Sq) f32: each query row's natural log-sum-exp of its scaled
    f32 scores ``q.k / sqrt(D)`` over the keys the mask leaves live, what
    the forward kernels keep for the backward."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    check_lengths(sq, sk, causal, window)
    k = torch.repeat_interleave(k, h // kh, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(d)
    s = s.masked_fill(~attention_mask(sq, sk, causal, window, q.device), NEG_INF)
    return torch.logsumexp(s, dim=-1)


def flash_attention_bwd_ref(q, k, v, o, do, *, causal: bool = True,
                            window: Optional[int] = None) -> tuple:
    """The gradient of :func:`flash_attention_ref` with respect to q, k, v,
    from the formulas: P materialised, ``dV = P^T dO``, ``dP = dO V^T``,
    ``dS = P (dP - delta)`` with ``delta = rowsum(dO * O)`` of the given
    forward output ``o``, ``dQ = dS K / sqrt(D)``, ``dK = dS^T Q / sqrt(D)``,
    the kv heads' gradients summed over their query heads.  f32 math,
    gradients in the inputs' dtype."""
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    check_lengths(sq, sk, causal, window)
    g = h // kh
    scale = 1.0 / math.sqrt(d)
    qf, dof = q.float(), do.float()
    kf = torch.repeat_interleave(k.float(), g, dim=2)
    vf = torch.repeat_interleave(v.float(), g, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    s = s.masked_fill(~attention_mask(sq, sk, causal, window, q.device), NEG_INF)
    p = torch.softmax(s, dim=-1)
    del s
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    delta = (dof * o.float()).sum(-1).permute(0, 2, 1)[..., None]     # (B, H, Sq, 1)
    ds = p * (dp - delta)
    del p, dp
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dk = dk.reshape(b, sk, kh, g, d).sum(3)
    dv = dv.reshape(b, sk, kh, g, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


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


def rwkv6_scan_bwd_ref(r, k, v, w, u, state, dout, dstate) -> tuple:
    """The gradient of :func:`rwkv6_scan_ref` with respect to (r, k, v, w,
    u, state), given those of its two outputs, ``dout`` (B, S, H, D) and
    ``dstate`` (B, H, D, D): the states S_0 .. S_{S-1} kept from a forward
    loop, then, with G the gradient of the state after step t, from
    G = dstate backwards::

        dr_t = (S_{t-1} + u k_t v_t^T) dout_t
        dk_t = r_t u (v_t . dout_t) + G v_t
        dv_t = (r_t . (u k_t)) dout_t + G^T k_t
        dw_t = rowsum(G * S_{t-1})
        du  += r_t k_t (v_t . dout_t)
        G   <- diag(w_t) G + r_t dout_t^T

    and the start state's gradient is the last G.
    """
    states = [state]
    for t in range(r.shape[1] - 1):
        kv = k[:, t, ..., :, None] * v[:, t, ..., None, :]
        states.append(w[:, t, ..., None] * states[-1] + kv)
    g = dstate
    du = torch.zeros_like(u)
    grads = {name: torch.empty_like(r) for name in ("r", "k", "v", "w")}
    for t in range(r.shape[1] - 1, -1, -1):
        rt, kt, vt, wt, dt = r[:, t], k[:, t], v[:, t], w[:, t], dout[:, t]
        sp = states[t]
        vd = (vt * dt).sum(-1, keepdim=True)                    # (B, H, 1)
        grads["r"][:, t] = torch.einsum("bhij,bhj->bhi", sp, dt) + u * kt * vd
        grads["k"][:, t] = rt * u * vd + torch.einsum("bhij,bhj->bhi", g, vt)
        grads["v"][:, t] = ((rt * u * kt).sum(-1, keepdim=True) * dt
                            + torch.einsum("bhij,bhi->bhj", g, kt))
        grads["w"][:, t] = (g * sp).sum(-1)
        du = du + (rt * kt * vd).sum(0)
        g = wt[..., None] * g + rt[..., :, None] * dt[..., None, :]
    return grads["r"], grads["k"], grads["v"], grads["w"], du, g


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


def mamba_scan_bwd_ref(dt, b, c, x, a, state, dy, dstate) -> tuple:
    """The gradient of :func:`mamba_scan_ref` with respect to (dt, b, c, x,
    a, state), given those of its two outputs, ``dy`` (B, S, di) and
    ``dstate`` (B, di, ds): the states h_0 .. h_S kept from a forward loop
    (h_0 the given one), then, with a_t = exp(dt_t A) and g the gradient of
    the state after step t, from g = dstate + C_S dy_S backwards::

        dx_t  = dt_t sum_n g B_t
        ddt_t = sum_n g (x_t B_t + A a_t h_{t-1})
        dB_t  = sum_d g dt_t x_t          dC_t = sum_d h_t dy_t
        dA   += sum_b g dt_t a_t h_{t-1}
        g    <- C_{t-1} dy_{t-1} + a_t g

    with steps counted from 1; the start state's gradient is a_1 g_1.
    """
    states = [state]
    for t in range(dt.shape[1]):
        da = torch.exp(dt[:, t, :, None] * a)
        states.append(da * states[-1] + (dt[:, t] * x[:, t])[..., None] * b[:, t, None, :])
    grads = {name: torch.empty_like(t) for name, t in (("dt", dt), ("b", b), ("c", c),
                                                        ("x", x))}
    da_sum = torch.zeros_like(a)
    carry = dstate                                   # dL/dh_t from the steps after t
    for t in range(dt.shape[1] - 1, -1, -1):
        dt_t, b_t, c_t, x_t, dy_t = dt[:, t], b[:, t], c[:, t], x[:, t], dy[:, t]
        at = torch.exp(dt_t[..., None] * a)                          # (B, di, ds)
        g = c_t[:, None, :] * dy_t[..., None] + carry
        gb = (g * b_t[:, None, :]).sum(-1)                           # (B, di)
        gah = g * at * states[t]                                     # g a_t h_{t-1}
        grads["x"][:, t] = dt_t * gb
        grads["dt"][:, t] = x_t * gb + (gah * a).sum(-1)
        grads["b"][:, t] = torch.einsum("bdn,bd->bn", g, dt_t * x_t)
        grads["c"][:, t] = torch.einsum("bdn,bd->bn", states[t + 1], dy_t)
        da_sum = da_sum + (gah * dt_t[..., None]).sum(0)
        carry = at * g
    return grads["dt"], grads["b"], grads["c"], grads["x"], da_sum, carry


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
