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

Under a sharded-serving plan (``par``, ``sharding.parallel.Plan``; ``path``
the mixer's ``layers/l{j}/mamba``) both modes run on this rank's channels
(``Plan.mamba_split``): ``in_proj``'s column block exchanged into the x and
z of those channels (``Plan.mamba_xz``), the conv, dt and the scan on them
from the rank's blocks of the state, ``x_proj``'s and ``out_proj``'s rows
summed over "model"; or on the leaves all-gathered where "model" does not
split the channels.
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


def _ssm_params(p, xc, ds, par=None):
    """xc: (..., di) conv output -> dt (..., di), B (..., ds), C (..., ds), f32.
    Under a split plan ``par``, ``x_proj``'s product over this rank's
    channels is summed over "model" (in f32, rounded once to the model
    dtype as one product is) before the split.

    ``F.softplus`` returns x itself above 20, where ``jax.nn.softplus`` adds
    log1p(exp(-x)); the two differ there by less than 2.1e-9."""
    if par is None:
        proj = (xc @ p["x_proj"]).float()
    else:
        proj = par.row_sum(xc, p["x_proj"], xc.dtype).float()
    dt_r, b, c = torch.split(proj, [DT_RANK, ds, ds], dim=-1)
    dt = F.softplus(dt_r @ p["dt_proj"] + p["dt_bias"])
    return dt, b.contiguous(), c.contiguous()


def _split_plan(p, par, path) -> tuple:
    """``(p, par)``: under a plan that splits the channels, as given; under
    one that does not, the leaves all-gathered and no plan; else as given."""
    if par is not None and not par.mamba_split(path):
        return par.whole_leaves(p, path), None
    return p, par


def _in_proj(p, x, par):
    """(x, z) of the channels computed: all, or this rank's."""
    xz = x @ p["in_proj"]
    return torch.chunk(xz, 2, dim=-1) if par is None else par.mamba_xz(xz)


def _out_proj(p, y, z, dtype, par):
    y = y.to(dtype) * F.silu(z)
    return y @ p["out_proj"] if par is None else par.row_sum(y, p["out_proj"], dtype)


def mamba_seq(p, x, cfg, init_state=None, par=None, path=""):
    """Full-sequence mamba. x: (B,S,D) -> (y (B,S,D), (conv_state, ssm_state)),
    from ``init_state`` = (conv (B,dc-1,di) f32, ssm (B,di,ds) f32), or zeros;
    under a split plan ``par`` every di is this rank's channels'."""
    b, s, _ = x.shape
    ds, dc = cfg.mamba_d_state, cfg.mamba_d_conv
    p, par = _split_plan(p, par, path)
    xi, z = _in_proj(p, x, par)                             # (B,S,di)
    di = xi.shape[-1]
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
    dt, bm, cm = _ssm_params(p, xc, ds, par)                # (B,S,di), (B,S,ds) x2
    a = -torch.exp(p["A_log"])                              # (di,ds)
    h0 = init_state[1] if init_state is not None else None
    xf = xc.float().contiguous()
    y, h = ops.mamba_scan_op(dt, bm, cm, xf, a, h0)
    y = _out_proj(p, y + p["D"] * xf, z, x.dtype, par)
    # a copy: in f32 a view of xp would keep the layer's whole (B, S, di)
    # input alive in the prefill's cache entry
    return y, (xp[:, s:].to(torch.float32, copy=True), h)


def mamba_step(p, x, state, cfg, par=None, path=""):
    """One-token decode. x: (B,1,D); state = (conv (B,dc-1,di) f32,
    ssm (B,di,ds) f32), this rank's channels' under a split plan ``par``.
    Returns (y (B,1,D), new state); ``state`` is not written."""
    ds = cfg.mamba_d_state
    conv_state, h = state
    p, par = _split_plan(p, par, path)
    xi, z = _in_proj(p, x[:, 0, :], par)                    # (B,di)
    win = torch.cat([conv_state.to(xi.dtype), xi[:, None, :]], dim=1)   # (B,dc,di)
    # one product over the window, as the reference: in bf16 it rounds
    # otherwise than mamba_seq's tap-by-tap sum
    xc = F.silu(torch.einsum("bcd,cd->bd", win, p["conv"]) + p["conv_b"])
    dt, bm, cm = _ssm_params(p, xc, ds, par)
    a = -torch.exp(p["A_log"])
    xf = xc.float().contiguous()
    y, h = ops.mamba_scan_op(dt[:, None], bm[:, None], cm[:, None], xf[:, None], a, h)
    y = _out_proj(p, y[:, 0] + p["D"] * xf, z, x.dtype, par)
    return y[:, None, :], (win[:, 1:, :].float(), h)


def init_state(cfg, batch, device):
    di, ds, dc = d_inner(cfg), cfg.mamba_d_state, cfg.mamba_d_conv
    return (torch.zeros((batch, dc - 1, di), dtype=torch.float32, device=device),
            torch.zeros((batch, di, ds), dtype=torch.float32, device=device))
