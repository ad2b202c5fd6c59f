"""Mamba (S6) selective-state-space mixer, used by the Jamba hybrid (twin of
``repro/models/mamba.py``).

In-proj to (x, z), depthwise causal conv, data-dependent (dt, B, C),
diagonal state update, gated out-proj.  Both modes run the scan through
``ops.mamba_scan_op`` from the state they are given: the ``mamba_scan``
kernel on the card, over a whole prompt in ``mamba_seq`` (where the
reference opens its ``mamba_scan`` scope, ``:102``) and over one token in
each ``mamba_step``.  The D-skip, the gating and the out-projection stay
outside the kernel, as in the reference.

Every cast follows the reference's, so a bf16 model rounds where its
reference does: the conv, its bias and ``silu`` in the model dtype, the
``x_proj`` product in the model dtype and cast to f32 after, ``dt`` and the
scan in f32, ``y`` back in the model dtype before the gate, the conv state
kept in f32.  The reference splits S into chunks; that changes no
arithmetic, so the port scans all of S in one launch.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.layers import init_dense

DT_RANK = 16


def d_inner(cfg) -> int:
    return cfg.mamba_expand * cfg.d_model


def init_mamba(gen, cfg, device) -> dict:
    d = cfg.d_model
    di, ds, dc = d_inner(cfg), cfg.mamba_d_state, cfg.mamba_d_conv
    dt, f32 = cfg.tdtype, torch.float32
    conv = torch.randn((dc, di), generator=gen, dtype=f32, device=device) * 0.1
    return {
        "in_proj": init_dense(gen, d, 2 * di, dt, device),
        "conv": conv.to(dt),
        "conv_b": torch.zeros((di,), dtype=dt, device=device),
        "x_proj": init_dense(gen, di, DT_RANK + 2 * ds, dt, device),
        "dt_proj": init_dense(gen, DT_RANK, di, f32, device),
        "dt_bias": torch.full((di,), math.log(math.expm1(0.01)), dtype=f32, device=device),
        "A_log": torch.log(torch.arange(1, ds + 1, dtype=f32, device=device)).repeat(di, 1),
        "D": torch.ones((di,), dtype=f32, device=device),
        "out_proj": init_dense(gen, di, d, dt, device),
    }


def _ssm_params(p, xc, ds):
    """xc: (..., di) conv output -> dt (..., di), B (..., ds), C (..., ds), f32.

    ``F.softplus`` returns x itself above 20, where ``jax.nn.softplus`` adds
    log1p(exp(-x)); the two differ there by less than 2.1e-9."""
    proj = (xc @ p["x_proj"]).float()
    dt_r, b, c = torch.split(proj, [DT_RANK, ds, ds], dim=-1)
    dt = F.softplus(dt_r @ p["dt_proj"] + p["dt_bias"])
    return dt, b.contiguous(), c.contiguous()


def mamba_seq(p, x, cfg, init_state=None):
    """Full-sequence mamba. x: (B,S,D) -> (y (B,S,D), (conv_state, ssm_state)),
    from ``init_state`` = (conv (B,dc-1,di) f32, ssm (B,di,ds) f32), or zeros."""
    b, s, _ = x.shape
    di, ds, dc = d_inner(cfg), cfg.mamba_d_state, cfg.mamba_d_conv
    xi, z = torch.chunk(x @ p["in_proj"], 2, dim=-1)        # (B,S,di)
    if init_state is not None:
        pad = init_state[0].to(xi.dtype)                    # (B,dc-1,di)
    else:
        pad = torch.zeros((b, dc - 1, di), dtype=xi.dtype, device=x.device)
    xp = torch.cat([pad, xi], dim=1)                        # (B,S+dc-1,di)
    # depthwise causal conv over time, summed tap by tap in the model dtype
    xc = xp[:, 0:s] * p["conv"][0]
    for i in range(1, dc):
        xc = xc + xp[:, i:i + s] * p["conv"][i]
    xc = F.silu(xc + p["conv_b"])
    dt, bm, cm = _ssm_params(p, xc, ds)                     # (B,S,di), (B,S,ds) x2
    a = -torch.exp(p["A_log"])                              # (di,ds)
    h0 = init_state[1] if init_state is not None else None
    xf = xc.float().contiguous()
    y, h = ops.mamba_scan_op(dt, bm, cm, xf, a, h0)
    y = y + p["D"] * xf
    y = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    # a copy: in f32 a view of xp would keep the layer's whole (B, S, di)
    # input alive in the prefill's cache entry
    return y, (xp[:, s:].to(torch.float32, copy=True), h)


def mamba_step(p, x, state, cfg):
    """One-token decode. x: (B,1,D); state = (conv (B,dc-1,di) f32,
    ssm (B,di,ds) f32).  Returns (y (B,1,D), new state); ``state`` is not
    written."""
    ds = cfg.mamba_d_state
    conv_state, h = state
    xi, z = torch.chunk(x[:, 0, :] @ p["in_proj"], 2, dim=-1)   # (B,di)
    win = torch.cat([conv_state.to(xi.dtype), xi[:, None, :]], dim=1)   # (B,dc,di)
    # one product over the window, as the reference: in bf16 it rounds
    # otherwise than mamba_seq's tap-by-tap sum
    xc = F.silu(torch.einsum("bcd,cd->bd", win, p["conv"]) + p["conv_b"])
    dt, bm, cm = _ssm_params(p, xc, ds)
    a = -torch.exp(p["A_log"])
    xf = xc.float().contiguous()
    y, h = ops.mamba_scan_op(dt[:, None], bm[:, None], cm[:, None], xf[:, None], a, h)
    y = y[:, 0] + p["D"] * xf
    y = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    return y[:, None, :], (win[:, 1:, :].float(), h)


def init_state(cfg, batch, device):
    di, ds, dc = d_inner(cfg), cfg.mamba_d_state, cfg.mamba_d_conv
    return (torch.zeros((batch, dc - 1, di), dtype=torch.float32, device=device),
            torch.zeros((batch, di, ds), dtype=torch.float32, device=device))
