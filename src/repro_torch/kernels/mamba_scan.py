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

The backward (``csrc/mamba_scan_bwd.cu``, a library of its own; no TPU
kernel has one) runs where grad mode is on and an input requires grad, as
in a hybrid (jamba) training step or a jamba ``Study.profile``: the forward
then goes through :class:`_Scan`, and its backward launches
:func:`mamba_scan_bwd` for the gradients of dt, B, C, x, A and the start
state from those of y and the final state.  It is chunk-parallel in time:
each 64-step chunk's state and gradient from zero and its decay (a block a
batch row, chunk and 64 channels), a scan over the chunks for each chunk's
boundary state and gradient, then each chunk's backward from those, its
states recomputed 8 steps at a time and never walked back by dividing by
a_t; a last kernel adds the blocks' partials of dB and dC and the chunks'
of dA.  Every sum is in a fixed order: two calls give the same bits.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import mamba_scan_bwd_ref, mamba_scan_ref

# launches of the CUDA kernels: the forward ("chain") and the backward (a
# call runs its four kernels); a CPU call launches nothing
launches = {"chain": 0, "bwd": 0}

# what the hybrid configuration uses: jamba's d_state
STATE_DIMS = (16,)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "mamba_scan": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
}
_BWD_SIGNATURES = {
    "mamba_scan_bwd": ([_P] * 15 + [_I] * 4 + [_P], _I),
    "mamba_scan_bwd_workspace": ([_I, _I, _I], ctypes.c_longlong),
    "mamba_scan_bwd_info": ([_P], _I),
}
# the backward's kernels, in launch order: phases A, B, C and the sums
BWD_KERNELS = ("mamba_bwd_local", "mamba_bwd_carry", "mamba_bwd_chunk", "mamba_bwd_sum")


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


def _check_card(dt, b) -> None:
    """What the kernels take beyond :func:`_check_inputs`: a CUDA tensor and
    d_state ``STATE_DIMS``."""
    if dt.device.type != "cuda":
        raise ValueError(f"mamba_scan runs on cpu or cuda, not {dt.device}")
    if b.shape[2] not in STATE_DIMS:
        raise ValueError(f"the kernel takes d_state {STATE_DIMS}, not {b.shape[2]}")


def _forward(dt, b, c, x, a, state) -> tuple:
    bsz, s, di = dt.shape
    y = torch.empty_like(dt)
    final = torch.empty_like(state)
    if bsz * di == 0:
        return y, final
    with torch.cuda.device(dt.device):
        lib = _build.load("mamba_scan", _SIGNATURES)
        code = lib.mamba_scan(
            dt.data_ptr(), b.data_ptr(), c.data_ptr(), x.data_ptr(), a.data_ptr(),
            state.data_ptr(), y.data_ptr(), final.data_ptr(), bsz, s, di, b.shape[2],
            torch.cuda.current_stream(dt.device).cuda_stream)
        _build.check(lib, code, "mamba_scan")
    launches["chain"] += 1
    return y, final


def mamba_scan_bwd(dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor, x: torch.Tensor,
                   a: torch.Tensor, state: torch.Tensor, dy: torch.Tensor,
                   dstate: torch.Tensor) -> tuple:
    """The gradients (ddt, db, dc, dx, da, dstate0) of :func:`mamba_scan`'s
    inputs, given those of its outputs: ``dy`` (B, S, di) and ``dstate``
    (B, di, ds), f32.  A CPU tensor goes to :func:`mamba_scan_bwd_ref`; a
    CUDA tensor launches the backward kernels on the current stream, or
    raises."""
    _check_inputs(dt, b, c, x, a, state)
    for name, t, want in (("dy", dy, dt), ("dstate", dstate, state)):
        if t.shape != want.shape or t.dtype != torch.float32 or t.device != dt.device:
            raise ValueError(f"{name} must be f32 of shape {tuple(want.shape)} on {dt.device}; "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if dt.device.type == "cpu":
        return mamba_scan_bwd_ref(dt, b, c, x, a, state, dy, dstate)
    _check_card(dt, b)
    bsz, s, di = dt.shape
    state, dy, dstate = _build.aligned(state), dy.contiguous(), _build.aligned(dstate)
    ddt, dx = torch.empty_like(dt), torch.empty_like(x)
    db, dc = torch.empty_like(b), torch.empty_like(c)
    da = torch.empty_like(a)
    dstate0 = torch.empty_like(state)
    if bsz * di == 0:
        return ddt, db.zero_(), dc.zero_(), dx, da.zero_(), dstate0
    with torch.cuda.device(dt.device):
        lib = _build.load("mamba_scan_bwd", _BWD_SIGNATURES)
        work = torch.empty(lib.mamba_scan_bwd_workspace(bsz, s, di), dtype=torch.float32,
                           device=dt.device)
        code = lib.mamba_scan_bwd(
            dt.data_ptr(), b.data_ptr(), c.data_ptr(), x.data_ptr(), a.data_ptr(),
            state.data_ptr(), dy.data_ptr(), dstate.data_ptr(), ddt.data_ptr(), db.data_ptr(),
            dc.data_ptr(), dx.data_ptr(), da.data_ptr(), dstate0.data_ptr(), work.data_ptr(),
            bsz, s, di, b.shape[2], torch.cuda.current_stream(dt.device).cuda_stream)
        _build.check(lib, code, "mamba_scan_bwd")
    launches["bwd"] += 1
    return ddt, db, dc, dx, da, dstate0


def bwd_workspace(b: int, s: int, di: int) -> int:
    """Floats of scratch :func:`mamba_scan_bwd` takes at (B, S, di): each
    chunk's boundary state, gradient and decay (then dA's partials), and
    each block's partials of dB and dC at every step."""
    return _build.load("mamba_scan_bwd", _BWD_SIGNATURES).mamba_scan_bwd_workspace(b, s, di)


def bwd_kernel_info() -> dict:
    """The backward's sizes (steps a chunk and a sub-chunk, channels a
    block, state entries a thread) and, from ``cudaFuncGetAttributes`` and
    the occupancy calculator, each kernel's registers, static and dynamic
    shared memory, local (spilled) bytes, threads, resident blocks and warps
    an SM, on the current device."""
    out = (ctypes.c_int * 28)()
    lib = _build.load("mamba_scan_bwd", _BWD_SIGNATURES)
    _build.check(lib, lib.mamba_scan_bwd_info(out), "mamba_scan_bwd_info")
    return {"sizes": dict(zip(("chunk", "sub_chunk", "block_channels", "thread_entries"),
                              out[:4])),
            "kernels": _build.kernel_attributes(out, BWD_KERNELS)}


class _Scan(torch.autograd.Function):
    """The forward kernel with :func:`mamba_scan_bwd` as its backward."""

    @staticmethod
    def forward(ctx, dt, b, c, x, a, state):
        y, final = _forward(dt, b, c, x, a, state)
        ctx.save_for_backward(dt, b, c, x, a, state)
        return y, final

    @staticmethod
    def backward(ctx, dy, dstate):
        return mamba_scan_bwd(*ctx.saved_tensors, dy, dstate)


def mamba_scan(dt: torch.Tensor, b: torch.Tensor, c: torch.Tensor, x: torch.Tensor,
               a: torch.Tensor, state: torch.Tensor) -> tuple:
    """dt, x: (B, S, di) f32; b, c: (B, S, ds); a: (di, ds), negative;
    state: (B, di, ds).  Returns (y (B, S, di), final state (B, di, ds));
    ``state`` is not written.

    A CPU tensor goes to :func:`mamba_scan_ref`, which autograd
    differentiates; a CUDA tensor launches the kernel on the current stream,
    through :class:`_Scan` where grad mode is on and an input requires grad,
    or raises.
    """
    _check_inputs(dt, b, c, x, a, state)
    if dt.device.type == "cpu":
        return mamba_scan_ref(dt, b, c, x, a, state)
    _check_card(dt, b)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (dt, b, c, x, a, state)):
        return _Scan.apply(dt, b, c, x, a, state)
    return _forward(dt, b, c, x, a, state)
