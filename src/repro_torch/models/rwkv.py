"""RWKV-6 (Finch) blocks: time-mix with data-dependent decay + channel-mix
(twin of ``repro/models/rwkv.py``).

The WKV recurrence per head (k-dim x v-dim state):

    out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T        w_t = exp(-exp(decay(x_t)))

``wkv_scan`` runs it through ``ops.wkv_op`` from the state it is given:
the ``rwkv6_scan`` kernel on the card, over a whole prompt in prefill and
over one token in each decode step.

Under a sharded-serving plan (``par``, ``sharding.parallel.Plan``; ``path``
the sub-nest's, ``layers/l{j}/tm`` or ``/cm``) :func:`time_mix` runs on this
rank's heads (``Plan.tm_heads``), or on its leaves all-gathered where its
columns are not whole heads, and :func:`channel_mix` sums its hidden
product over "model".
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


def _wkv_inputs(p, x, x_prev, cfg, lo: int = 0):
    """r, k, v, g, w on the columns ``p``'s ``w[rkvg]`` hold: all of them,
    or a rank's block from column ``lo``, where the replicated decay leaves
    are narrowed to it (``dec_w2``'s columns before the product)."""
    xw, xk, xv, xr, xg = _ddlerp(p, x, x_prev)
    r = xr @ p["wr"]
    k = xk @ p["wk"]
    v = xv @ p["wv"]
    g = F.silu(xg @ p["wg"])
    n = r.shape[-1]
    w = torch.exp(-torch.exp(p["decay_base"].narrow(-1, lo, n)
                             + torch.tanh(xw.float() @ p["dec_w1"])
                             @ p["dec_w2"].narrow(-1, lo, n)))
    return r, k, v, g, w


def _heads(x, hd):
    return x.reshape(x.shape[:-1] + (x.shape[-1] // hd, hd))


def wkv_scan(r, k, v, w, u, state):
    """Sequence WKV from ``state``. r,k,v,w: (B,S,H,hd) float32; u: (H,hd);
    state: (B,H,hd,hd).  Returns (out (B,S,H,hd), final_state)."""
    return ops.wkv_op(*(a.contiguous() for a in (r, k, v, w, u, state)))


def time_mix(p, x, x_prev, state, cfg, par=None, path=""):
    """x: (B,S,D); x_prev: (B,D) last token of previous chunk; state: the
    (B,H,hd,hd) WKV state, or under a plan whose heads split
    (``par.tm_heads(path)``) the whole state or this rank's heads'.

    Returns (out (B,S,D), new_x_prev (B,D), new_state), the state of the
    heads computed (a rank's under a split plan).
    """
    b, s, _ = x.shape
    hd = cfg.rwkv_head_dim
    heads = par is not None and par.tm_heads(path)
    if par is not None and not heads:
        p = par.whole_leaves(p, path)
    n = p["wr"].shape[-1]                      # the columns computed: d, or a rank's
    lo = par.r * n if heads else 0
    shifted = torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)
    r, k, v, g, w = _wkv_inputs(p, x, shifted, cfg, lo)
    rh, kh, vh = (_heads(a.float(), hd) for a in (r, k, v))
    wh = _heads(w, hd)
    u = p["bonus"].narrow(-1, lo, n).reshape(n // hd, hd)
    if state.shape[1] != n // hd:              # the whole zero state of a prefill
        state = state.narrow(1, lo // hd, n // hd)
    out, state = wkv_scan(rh, kh, vh, wh, u, state)
    # per-head groupnorm (ln_x): normalise within each head
    oh = out.reshape(b, s, n // hd, hd)
    oh = ((oh - oh.mean(dim=-1, keepdim=True))
          * torch.rsqrt(oh.var(dim=-1, keepdim=True, unbiased=False) + 1e-5))
    out = (oh.reshape(b, s, n) * p["ln_x"].narrow(-1, lo, n)).to(x.dtype) * g
    out = par.row_sum(out, p["wo"], x.dtype) if heads else out @ p["wo"]
    return out, x[:, -1, :], state


def channel_mix(p, x, x_prev, par=None, path=""):
    """Under a plan ``par``, ``relu(xk @ w_k)² @ w_v`` on this rank's hidden
    units summed over "model", and ``sigmoid(xr @ w_r)`` from ``w_r``'s
    columns all-gathered (or the leaves gathered whole where "model" does
    not split the hidden units)."""
    shifted = torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)
    dx = shifted - x
    xk = x + dx * p["maa_k"].to(x.dtype)
    xr = x + dx * p["maa_r"].to(x.dtype)
    if par is not None and not par.ffn_split(path):
        p, par = par.whole_leaves(p, path), None
    k = torch.square(torch.relu(xk @ p["w_k"]))
    if par is None:
        return torch.sigmoid(xr @ p["w_r"]) * (k @ p["w_v"]), x[:, -1, :]
    gate = torch.sigmoid(par.whole(xr, p["w_r"], None, f"{path}/w_r", ""))
    return gate * par.row_sum(k, p["w_v"], x.dtype), x[:, -1, :]


def init_state(cfg, batch, dtype, device):
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    return {
        "tm_prev": torch.zeros((batch, d), dtype=dtype, device=device),
        "cm_prev": torch.zeros((batch, d), dtype=dtype, device=device),
        "wkv": torch.zeros((batch, d // hd, hd, hd), dtype=torch.float32, device=device),
    }
