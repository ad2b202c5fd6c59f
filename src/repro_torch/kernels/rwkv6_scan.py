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
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rwkv6_scan_ref

# launches of the CUDA kernel (a CPU call launches nothing)
launches = {"chain": 0}

# what the ssm configuration uses: rwkv6-1.6b's head dim
HEAD_DIMS = (64,)

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "rwkv6_scan": ([_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
}


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


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
               u: torch.Tensor, state: torch.Tensor) -> tuple:
    """r, k, v, w: (B, S, H, D) f32; u: (H, D); state: (B, H, D, D) f32.
    Returns (out (B, S, H, D), final state (B, H, D, D)); ``state`` is not
    written.

    A CPU tensor goes to :func:`rwkv6_scan_ref`; a CUDA tensor launches the
    kernel on the current stream, or raises (also where grad mode is on and
    an input requires grad: the kernel has no backward).
    """
    _check_inputs(r, k, v, w, u, state)
    if r.device.type == "cpu":
        return rwkv6_scan_ref(r, k, v, w, u, state)
    if r.device.type != "cuda":
        raise ValueError(f"rwkv6_scan runs on cpu or cuda, not {r.device}")
    _build.refuse_grad("rwkv6_scan", r, k, v, w, u, state)
    b, s, h, d = r.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, not {d}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary for the kernel's "
                             f"16-byte copies; it starts at {t.data_ptr():#x}")
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
