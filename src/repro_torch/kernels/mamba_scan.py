"""The Mamba (S6) selective scan from a given state.

Replaces the TPU kernel ``mamba_scan`` (``repro/kernels/mamba_scan.py:55``,
``pl.pallas_call`` at ``:73``) with the CUDA C++ kernel in
``csrc/mamba_scan.cu`` for ``sm_90a``.

Bound on an H100: the B*S*di*d_state exponentials on the special-function
units; the bytes of dt, x and y (f32) at 3.35 TB/s take about as long.  Two
lanes per (batch, channel) walk all S steps, each with half of the d_state
floats of state in registers, dA = 2^(dt * A log2 e) by one ``ex2.approx``
an entry; dt, x, B_t and C_t arrive by ``cp.async`` in a ring of chunks that
overlaps the steps.  Unlike the TPU kernel it starts from a given state
(zero reproduces the TPU kernel) and takes any S >= 1, so a decode step
(S = 1) goes through it too.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mamba_scan_ref

# launches of the CUDA kernel (a CPU call launches nothing)
launches = {"chain": 0}

# what the hybrid configuration uses: jamba's d_state
STATE_DIMS = (16,)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "mamba_scan": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
}


def _check_inputs(dt, b, c, x, a, state) -> None:
    if dt.dim() != 3:
        raise ValueError(f"want dt, x (B, S, di); got dt {tuple(dt.shape)}")
    bsz, s, di = dt.shape
    if s < 1:
        raise ValueError("the scan needs at least one step")
    if x.shape != dt.shape:
        raise ValueError(f"shape mismatch: dt {tuple(dt.shape)}, x {tuple(x.shape)}")
    if b.dim() != 3 or b.shape[:2] != (bsz, s):
        raise ValueError(f"want b, c (B, S, ds) with (B, S) = {(bsz, s)}; got b {tuple(b.shape)}")
    ds = b.shape[2]
    if c.shape != b.shape:
        raise ValueError(f"shape mismatch: b {tuple(b.shape)}, c {tuple(c.shape)}")
    if a.shape != (di, ds) or state.shape != (bsz, di, ds):
        raise ValueError(f"want a (di, ds) = {(di, ds)} and state (B, di, ds) = {(bsz, di, ds)}; "
                         f"got {tuple(a.shape)}, {tuple(state.shape)}")
    for name, t in (("dt", dt), ("b", b), ("c", c), ("x", x), ("a", a), ("state", state)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != dt.device:
            raise ValueError(f"{name} is on {t.device}, dt on {dt.device}")


def mamba_scan(dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor, x: torch.Tensor,
               a: torch.Tensor, state: torch.Tensor) -> tuple:
    """dt, x: (B, S, di) f32; b, c: (B, S, ds); a: (di, ds), negative;
    state: (B, di, ds).  Returns (y (B, S, di), final state (B, di, ds));
    ``state`` is not written.

    A CPU tensor goes to :func:`mamba_scan_ref`; a CUDA tensor launches the
    kernel on the current stream, or raises (also where grad mode is on and
    an input requires grad: the kernel has no backward).
    """
    _check_inputs(dt, b, c, x, a, state)
    if dt.device.type == "cpu":
        return mamba_scan_ref(dt, b, c, x, a, state)
    if dt.device.type != "cuda":
        raise ValueError(f"mamba_scan runs on cpu or cuda, not {dt.device}")
    _build.refuse_grad("mamba_scan", "its backward is ROADMAP A17c", dt, b, c, x, a, state)
    bsz, s, di = dt.shape
    ds = b.shape[2]
    if ds not in STATE_DIMS:
        raise ValueError(f"the kernel takes d_state {STATE_DIMS}, not {ds}")
    y = torch.empty_like(dt)
    final = torch.empty_like(state)
    if bsz * di == 0:
        return y, final
    with torch.cuda.device(dt.device):
        lib = _build.load("mamba_scan", _SIGNATURES)
        code = lib.mamba_scan(
            dt.data_ptr(), b.data_ptr(), c.data_ptr(), x.data_ptr(), a.data_ptr(),
            state.data_ptr(), y.data_ptr(), final.data_ptr(), bsz, s, di, ds,
            torch.cuda.current_stream(dt.device).cuda_stream)
        _build.check(lib, code, "mamba_scan")
    launches["chain"] += 1
    return y, final
