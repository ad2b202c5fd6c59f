"""RWKV-6 (Finch) blocks: time-mix with data-dependent decay + channel-mix
(twin of ``repro/models/rwkv.py``).

The WKV recurrence per head (k-dim x v-dim state):

    out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T        w_t = exp(-exp(decay(x_t)))

``wkv_scan`` runs it through ``ops.wkv_op`` from the state it is given:
the ``rwkv6_scan`` kernel on the card, over a whole prompt in prefill and
over one token in each decode step.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import init_dense


def init_time_mix(gen, cfg, device) -> dict:
    d, lo = cfg.d_model, cfg.rwkv_lora_dim
    hd = cfg.rwkv_head_dim
    if d % hd:
        raise ValueError(f"d_model {d} is not a multiple of rwkv_head_dim {hd}")
    dt, f32 = cfg.tdtype, torch.float32

    def full(shape, value):
        return torch.full(shape, value, dtype=f32, device=device)

    def normal(shape, std):
        return torch.randn(shape, generator=gen, dtype=f32, device=device) * std

    return {
        "wr": init_dense(gen, d, d, dt, device),
        "wk": init_dense(gen, d, d, dt, device),
        "wv": init_dense(gen, d, d, dt, device),
        "wg": init_dense(gen, d, d, dt, device),
        "wo": init_dense(gen, d, d, dt, device),
        "maa_x": full((d,), 0.5),
        "maa_base": full((5, d), 0.5),
        "maa_w1": init_dense(gen, d, 5 * lo, f32, device),
        "maa_w2": normal((5, lo, d), 0.01),
        "decay_base": full((d,), -4.0),
        "dec_w1": init_dense(gen, d, lo, f32, device),
        "dec_w2": init_dense(gen, lo, d, f32, device) * 0.1,
        "bonus": normal((d,), 0.1),
        "ln_x": full((d,), 1.0),
    }


def init_channel_mix(gen, cfg, device) -> dict:
    d, dt = cfg.d_model, cfg.tdtype
    return {
        "maa_k": torch.full((d,), 0.5, dtype=torch.float32, device=device),
        "maa_r": torch.full((d,), 0.5, dtype=torch.float32, device=device),
        "w_k": init_dense(gen, d, cfg.d_ff, dt, device),
        "w_v": init_dense(gen, cfg.d_ff, d, dt, device),
        "w_r": init_dense(gen, d, d, dt, device),
    }


def _ddlerp(p, x, x_prev):
    """Data-dependent lerp producing the 5 mixed inputs (w,k,v,r,g)."""
    dx = x_prev - x                                      # (B,S,D) or (B,D)
    xm = x + dx * p["maa_x"]
    lo = p["maa_w1"].shape[1] // 5
    t = torch.tanh(xm.float() @ p["maa_w1"])             # (...,5*lo)
    t = t.reshape(t.shape[:-1] + (5, lo))
    deltas = torch.einsum("...nl,nld->...nd", t, p["maa_w2"])  # (...,5,D)
    mix = p["maa_base"] + deltas                          # (...,5,D)
    out = x[..., None, :] + dx[..., None, :] * mix
    return tuple(out[..., i, :].to(x.dtype) for i in range(5))


def _wkv_inputs(p, x, x_prev, cfg):
    xw, xk, xv, xr, xg = _ddlerp(p, x, x_prev)
    r = xr @ p["wr"]
    k = xk @ p["wk"]
    v = xv @ p["wv"]
    g = F.silu(xg @ p["wg"])
    w = torch.exp(-torch.exp(p["decay_base"]
                             + torch.tanh(xw.float() @ p["dec_w1"]) @ p["dec_w2"]))
    return r, k, v, g, w


def _heads(x, hd):
    return x.reshape(x.shape[:-1] + (x.shape[-1] // hd, hd))


def wkv_scan(r, k, v, w, u, state):
    """Sequence WKV from ``state``. r,k,v,w: (B,S,H,hd) float32; u: (H,hd);
    state: (B,H,hd,hd).  Returns (out (B,S,H,hd), final_state)."""
    return ops.wkv_op(*(a.contiguous() for a in (r, k, v, w, u, state)))


def time_mix(p, x, x_prev, state, cfg):
    """x: (B,S,D); x_prev: (B,D) last token of previous chunk.

    Returns (out (B,S,D), new_x_prev (B,D), new_state).
    """
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    shifted = torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)
    r, k, v, g, w = _wkv_inputs(p, x, shifted, cfg)
    rh, kh, vh = (_heads(a.float(), hd) for a in (r, k, v))
    wh = _heads(w, hd)
    u = p["bonus"].reshape(d // hd, hd)
    out, state = wkv_scan(rh, kh, vh, wh, u, state)
    # per-head groupnorm (ln_x): normalise within each head
    oh = out.reshape(b, s, d // hd, hd)
    oh = ((oh - oh.mean(dim=-1, keepdim=True))
          * torch.rsqrt(oh.var(dim=-1, keepdim=True, unbiased=False) + 1e-5))
    out = oh.reshape(b, s, d) * p["ln_x"]
    out = (out.to(x.dtype) * g) @ p["wo"]
    return out, x[:, -1, :], state


def channel_mix(p, x, x_prev):
    shifted = torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)
    dx = shifted - x
    xk = x + dx * p["maa_k"].to(x.dtype)
    xr = x + dx * p["maa_r"].to(x.dtype)
    k = torch.square(torch.relu(xk @ p["w_k"]))
    return torch.sigmoid(xr @ p["w_r"]) * (k @ p["w_v"]), x[:, -1, :]


def init_state(cfg, batch, dtype, device):
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    return {
        "tm_prev": torch.zeros((batch, d), dtype=dtype, device=device),
        "cm_prev": torch.zeros((batch, d), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, d // hd, hd, hd), dtype=torch.float32, device=device),
    }
