"""The RWKV-6 (Finch) WKV recurrence from a given state.

Replaces the TPU kernel ``rwkv6_scan`` (``repro/kernels/rwkv6_scan.py:56``,
``pl.pallas_call`` at ``:69``) with the CUDA C++ kernel in
``csrc/rwkv6_scan.cu`` for ``sm_90a``.

Bound on an H100: the bytes of r, k, v, w and out (f32) plus the two
states at 3.35 TB/s; 5 f32 operations a state entry and step at the FMA
pipes' rate take a little less.  What holds the kernel is what shared memory
hands each thread a step: r_i, k_i and w_i of every row it holds.  One block
of 128 threads per (batch, head) walks all S steps with the D x D state in
registers: 4 lanes share 2 columns, 16 rows each, so each value read serves
2 entries, and the lanes' sums of 4 steps are added by 6 shuffles after the
4th.  The bonus u k v enters as one scalar a step, a_t = sum_i r_i u_i k_i,
so an entry costs 3 FP instructions a step.  r, k, v and w arrive by
``cp.async`` in a ring of 16-step chunks that overlaps the steps.  The sums
run in another order than :func:`rwkv6_scan_ref`'s (each lane's rows, then
the lanes' partials pairwise, then ``fma(v_j, a_t, .)``), within 1e-4 of max
|out|.  Unlike the TPU kernel it starts from a given state (zero reproduces
the TPU kernel) and takes any S >= 1, so a decode step (S = 1) goes through
it too.  The kernel copies 16 bytes at a time: r, k, v, w and u must start
on a 16-byte boundary, as every tensor the allocator makes does.

The backward (``csrc/rwkv6_scan_bwd.cu``, a library of its own; no TPU
kernel has one) runs where grad mode is on and an input requires grad: the
forward then goes through :class:`_Scan`, and its backward launches
:func:`rwkv6_scan_bwd` for the gradients of r, k, v, w, u and the start
state from those of out and the final state.  It is chunk-parallel in time:
each chunk of 48 steps gets its own state and gradient from zero and its
rows' decay product (a block a batch row, head and chunk), a scan over the
chunks gives each chunk's boundary state and gradient, and each chunk's
backward runs from those (a block a batch row, head, chunk and 32 state
columns), its states recomputed 8 steps at a time; the two column groups'
sums of dr, dk and dw are added in a thread-block cluster, and a last kernel
adds du's.  Every sum is in a fixed order: two calls give the same bits.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rwkv6_scan_bwd_ref, rwkv6_scan_ref

# launches of the CUDA kernels: the forward ("chain") and the backward (a
# call runs its four kernels); a CPU call launches nothing
launches = {"chain": 0, "bwd": 0}

# what the ssm configuration uses: rwkv6-1.6b's head dim
HEAD_DIMS = (64,)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "rwkv6_scan": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
}
_BWD_SIGNATURES = {
    "rwkv6_scan_bwd": ([_P] * 15 + [_I] * 4 + [_P], _I),
    "rwkv6_scan_bwd_workspace": ([_I, _I, _I], ctypes.c_longlong),
    "rwkv6_scan_bwd_info": ([_P], _I),
}
# the backward's kernels, in launch order: phases A, B, C and du's sum
BWD_KERNELS = ("wkv6_bwd_local", "wkv6_bwd_carry", "wkv6_bwd_chunk", "wkv6_bwd_du")


def _check_inputs(r, k, v, w, u, state) -> None:
    if r.dim() != 4:
        raise ValueError(f"want r, k, v, w (B, S, H, D); got r {tuple(r.shape)}")
    b, s, h, d = r.shape
    if s < 1:
        raise ValueError("the scan needs at least one step")
    for name, t in (("k", k), ("v", v), ("w", w)):
        if t.shape != r.shape:
            raise ValueError(f"shape mismatch: r {tuple(r.shape)}, {name} {tuple(t.shape)}")
    if u.shape != (h, d) or state.shape != (b, h, d, d):
        raise ValueError(f"want u (H, D) = {(h, d)} and state (B, H, D, D) = {(b, h, d, d)}; "
                         f"got {tuple(u.shape)}, {tuple(state.shape)}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u), ("state", state)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != r.device:
            raise ValueError(f"{name} is on {t.device}, r on {r.device}")


def _check_card(r, k, v, w, u) -> None:
    """What the kernels take beyond :func:`_check_inputs`: a CUDA tensor,
    head dims ``HEAD_DIMS``, r, k, v, w and u on 16-byte boundaries."""
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan runs on cpu or cuda, not {r.device}")
    if r.shape[3] not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, not {r.shape[3]}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary for the kernel's "
                             f"16-byte copies; it starts at {t.data_ptr():#x}")


def _forward(r, k, v, w, u, state) -> tuple:
    b, s, h, d = r.shape
    out = torch.empty_like(r)
    final = torch.empty_like(state)
    if b * h == 0:
        return out, final
    with torch.cuda.device(r.device):
        lib = _build.load("rwkv6_scan", _SIGNATURES)
        code = lib.rwkv6_scan(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            state.data_ptr(), out.data_ptr(), final.data_ptr(), b, s, h, d,
            torch.cuda.current_stream(r.device).cuda_stream)
        _build.check(lib, code, "rwkv6_scan")
    launches["chain"] += 1
    return out, final


def rwkv6_scan_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                   u: torch.Tensor, state: torch.Tensor, dout: torch.Tensor,
                   dstate: torch.Tensor) -> tuple:
    """The gradients (dr, dk, dv, dw, du, dstate0) of :func:`rwkv6_scan`'s
    inputs, given those of its outputs: ``dout`` (B, S, H, D) and ``dstate``
    (B, H, D, D), f32.  A CPU tensor goes to :func:`rwkv6_scan_bwd_ref`; a
    CUDA tensor launches the backward kernels on the current stream, or
    raises."""
    _check_inputs(r, k, v, w, u, state)
    for name, t, want in (("dout", dout, r), ("dstate", dstate, state)):
        if t.shape != want.shape or t.dtype != torch.float32 or t.device != r.device:
            raise ValueError(f"{name} must be f32 of shape {tuple(want.shape)} on {r.device}; "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    if r.device.type == "cpu":
        return rwkv6_scan_bwd_ref(r, k, v, w, u, state, dout, dstate)
    _check_card(r, k, v, w, u)
    b, s, h, d = r.shape
    state, dout, dstate = _build.aligned(state), _build.aligned(dout), _build.aligned(dstate)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty_like(u)
    dstate0 = torch.empty_like(state)
    if b * h == 0:
        return dr, dk, dv, dw, du.zero_(), dstate0
    with torch.cuda.device(r.device):
        lib = _build.load("rwkv6_scan_bwd", _BWD_SIGNATURES)
        work = torch.empty(lib.rwkv6_scan_bwd_workspace(b, s, h), dtype=torch.float32,
                           device=r.device)
        code = lib.rwkv6_scan_bwd(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            state.data_ptr(), dout.data_ptr(), dstate.data_ptr(), dr.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), dw.data_ptr(), du.data_ptr(), dstate0.data_ptr(),
            work.data_ptr(), b, s, h, d, torch.cuda.current_stream(r.device).cuda_stream)
        _build.check(lib, code, "rwkv6_scan_bwd")
    launches["bwd"] += 1
    return dr, dk, dv, dw, du, dstate0


def bwd_workspace(b: int, s: int, h: int) -> int:
    """Floats of scratch :func:`rwkv6_scan_bwd` takes at (B, S, H): each
    chunk's boundary state and gradient, its rows' decay product and its
    partial of du."""
    return _build.load("rwkv6_scan_bwd", _BWD_SIGNATURES).rwkv6_scan_bwd_workspace(b, s, h)


def bwd_kernel_info() -> dict:
    """The backward's sizes (steps a chunk and a sub-chunk, state columns a
    block and a thread) and, from ``cudaFuncGetAttributes`` and the occupancy
    calculator, each kernel's registers, static and dynamic shared memory,
    local (spilled) bytes, threads and resident blocks an SM, on the current
    device; ``chunk_clusters``: the chunk kernel's clusters the device holds
    at once."""
    out = (ctypes.c_int * 29)()
    lib = _build.load("rwkv6_scan_bwd", _BWD_SIGNATURES)
    _build.check(lib, lib.rwkv6_scan_bwd_info(out), "rwkv6_scan_bwd_info")
    return {"sizes": dict(zip(("chunk", "sub_chunk", "block_columns", "thread_columns"),
                              out[:4])),
            "kernels": _build.kernel_attributes(out, BWD_KERNELS), "chunk_clusters": out[28]}


class _Scan(torch.autograd.Function):
    """The forward kernel with :func:`rwkv6_scan_bwd` as its backward."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        out, final = _forward(r, k, v, w, u, state)
        ctx.save_for_backward(r, k, v, w, u, state)
        return out, final

    @staticmethod
    def backward(ctx, dout, dstate):
        return rwkv6_scan_bwd(*ctx.saved_tensors, dout, dstate)


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
               u: torch.Tensor, state: torch.Tensor) -> tuple:
    """r, k, v, w: (B, S, H, D) f32; u: (H, D); state: (B, H, D, D) f32.
    Returns (out (B, S, H, D), final state (B, H, D, D)); ``state`` is not
    written.

    A CPU tensor goes to :func:`rwkv6_scan_ref`, which autograd
    differentiates; a CUDA tensor launches the kernel on the current stream,
    through :class:`_Scan` where grad mode is on and an input requires grad,
    or raises.
    """
    _check_inputs(r, k, v, w, u, state)
    if r.device.type == "cpu":
        return rwkv6_scan_ref(r, k, v, w, u, state)
    _check_card(r, k, v, w, u)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, w, u, state)):
        return _Scan.apply(r, k, v, w, u, state)
    return _forward(r, k, v, w, u, state)
