"""Online-softmax attention: causal and/or sliding window, GQA.

Replaces the TPU kernel ``flash_attention``
(``repro/kernels/flash_attention.py:86``, ``pl.pallas_call`` at ``:106``)
with the CUDA C++ kernels in ``csrc/flash_attention.cu`` for ``sm_90a``, one
route per dtype and no switch between them:

- ``wgmma_bf16``: bf16 inputs on the tensor cores.  TMA loads q, k and v
  into a two-stage ring of 128-key tiles on ``mbarrier``s; Q K^T and P V
  are ``wgmma`` with f32 accumulators, and P is rounded to bf16 for the
  second product, as the JAX model's chunked attention rounds it.  TMA
  needs each tensor's address on a 16-byte boundary.
- ``simt_f32``: f32 inputs in f32 FMA on the CUDA cores, as the TPU kernel
  computes, on register tiles (``csrc/flash_f32.cuh``): one block of 2 D
  threads per (batch * head, 64-query tile), 8 rows x 4 columns of each
  product a thread, float4 reads of operands that stream through a
  ``cp.async`` ring in 32-wide slices.  The copies are 16 bytes, so q, k, v
  (and the backward's dO) must start on 16-byte boundaries; the wrapper
  copies a view that does not.

Bound on an H100: the bytes of q, k, v and the output once at 3.35 TB/s
against ``4*B*H*D*(live query-key pairs)`` operations at 989 TFLOP/s (bf16
inputs) or 67 TFLOP/s (f32 inputs).  Key tiles no query of a block can see
are skipped.  Head dims 64 and 128, the two the TPU kernel names.  Queries
sit at the last Sq of Sk key positions, and the ragged edge is masked.
Sq > Sk (a cross-attention over fewer keys than queries) only without
causal or window masks: under either, a row could see no key, which the
TPU kernel writes as 0 and a plain softmax as the mean of v.

The backward (``csrc/flash_attention_bwd.cu``, a library of its own; no
TPU kernel has one) runs where grad mode is on and an input requires grad:
the forward then goes through :class:`_Attention`, which asks the forward
kernel for each row's log-sum-exp (``lse``, (B, H, Sq) f32, natural log of
the scaled scores) and saves q, k, v, the output and lse; its backward
launches :func:`flash_attention_bwd`, FlashAttention-2's algorithm: delta =
rowsum(dO * O) in one pass, then dK and dV a key tile (the GQA group's
query heads summed in registers) and dQ a query tile.  bf16 inputs run
``flash_bwd_dkdv_wgmma`` and ``flash_bwd_dq_wgmma``: every product on the
tensor cores (``wgmma``) from TMA-loaded bf16 tiles, P and dS rounded to
bf16 before their products; f32 inputs the register-tiled SIMT kernels in
f32 FMA (dK/dV by two halves of a block, one making P^T and dV, the other
dS^T and dK).  Bound
by 10 * B * H * D * (live pairs) operations.  The serving path asks for no
lse and its output is the same either way.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (check_lengths, flash_attention_bwd_ref,
                                     flash_attention_lse_ref, flash_attention_ref)

# launches of the CUDA kernels, forward by route and backward by dtype (a
# backward call runs its three kernels); a CPU call launches nothing
launches = {"wgmma_bf16": 0, "simt_f32": 0, "bwd_bf16": 0, "bwd_f32": 0}

# the head dims the TPU kernel names: 64 (whisper-tiny) and 128 (the dense
# and VLM configurations), in float32 or bfloat16
HEAD_DIMS = (64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {torch.float32: "simt_f32", torch.bfloat16: "wgmma_bf16"}
BWD_ROUTES = {torch.float32: "bwd_f32", torch.bfloat16: "bwd_bf16"}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "flash_attention": ([_P] * 5 + [_I] * 9 + [ctypes.c_float, _P], _I),
    "flash_attention_info": ([_I, _I, _P], _I),
}
_BWD_SIGNATURES = {
    "flash_attention_bwd": ([_P] * 10 + [_I] * 9 + [ctypes.c_float, _P], _I),
    "flash_attention_bwd_info": ([_I, _I, _P], _I),
}
# the backward's kernels a dtype, in the order flash_attention_bwd_info
# reports them
BWD_KERNELS = {torch.bfloat16: ("flash_bwd_dkdv_wgmma", "flash_bwd_dq_wgmma", "flash_bwd_delta"),
               torch.float32: ("flash_bwd_dkdv", "flash_bwd_dq", "flash_bwd_delta")}
FWD_KERNELS = {torch.bfloat16: "flash_fwd_wgmma", torch.float32: "flash_fwd_f32"}
# the rows of every f32 kernel's products (8 row groups of 8), as
# csrc/flash_f32.cuh fixes them; the columns are the head dim
F32_ROWS = 64


def f32_tiles(d: int) -> dict:
    """Threads a block and the rows of its tiles, of each f32 kernel at
    head dim ``d``: the forward and dQ a block of ``F32_ROWS`` queries over
    d-key tiles; dK/dV a block of ``F32_ROWS`` keys over d-query tiles, in
    two halves of 2 d threads."""
    return {"fwd": {"threads": 2 * d, "queries": F32_ROWS, "keys": d},
            "dq": {"threads": 2 * d, "queries": F32_ROWS, "keys": d},
            "dkdv": {"threads": 4 * d, "keys": F32_ROWS, "queries": d}}


def _check_inputs(q, k, v, causal, window) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"want q (B, Sq, H, D), k and v (B, Sk, K, D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}")
    sk, kh = k.shape[1], k.shape[2]
    if kh == 0 or h % kh:
        raise ValueError(f"{h} query heads do not split over {kh} kv heads")
    check_lengths(sq, sk, causal, window)
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"q, k, v must share one of {list(DTYPES)}; {name} is {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def _check_card(q, k, v, do=None) -> None:
    """What the kernels take beyond :func:`_check_inputs`: a CUDA tensor,
    head dims ``HEAD_DIMS``, and for the bf16 kernels' TMA loads q, k, v
    (and the backward's dO) on 16-byte boundaries."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, not {q.shape[3]}")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
            if t is not None and t.data_ptr() % 16:
                raise ValueError(f"{name} must start on a 16-byte boundary for the TMA "
                                 f"loads; it starts at {t.data_ptr():#x}")


def _forward(q, k, v, causal, window, *, want_lse: bool = False):
    """Launch the forward kernel of q's dtype on the current stream.  With
    ``want_lse`` it also writes each query row's log-sum-exp, (B, H, Sq) f32,
    and returns (out, lse); the output is the same either way."""
    q, k, v = (_build.aligned(t) for t in (q, k, v))
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) if want_lse else None
    if out.numel() == 0:
        return (out, lse) if want_lse else out
    with torch.cuda.device(q.device):
        lib = _build.load("flash_attention", _SIGNATURES)
        code = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if want_lse else None, DTYPES[q.dtype],
            b, sq, sk, h, kh, d, int(causal), window or 0, 1.0 / math.sqrt(d),
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(lib, code, "flash_attention")
    launches[ROUTES[q.dtype]] += 1
    return (out, lse) if want_lse else out


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None) -> tuple:
    """(out, lse): the forward of the training route, with each query row's
    natural log-sum-exp of its scaled scores over its live keys, (B, H, Sq)
    f32.  A CPU tensor goes to :func:`flash_attention_ref` and
    :func:`flash_attention_lse_ref`; a CUDA tensor launches its dtype's
    forward kernel (no autograd), or raises."""
    _check_inputs(q, k, v, causal, window)
    if q.device.type == "cpu":
        return (flash_attention_ref(q, k, v, causal=causal, window=window),
                flash_attention_lse_ref(q, k, causal=causal, window=window))
    _check_card(q, k, v)
    return _forward(q, k, v, causal, window, want_lse=True)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor,
                        do: torch.Tensor, lse: Optional[torch.Tensor], *, causal: bool = True,
                        window: Optional[int] = None) -> tuple:
    """(dq, dk, dv) of softmax attention, in the inputs' dtype, given the
    forward's output ``o``, its gradient ``do`` (both (B, Sq, H, D),
    contiguous, in q's dtype) and its row log-sum-exp ``lse`` ((B, H, Sq)
    f32, :func:`flash_attention_lse`).  A CPU tensor goes to
    :func:`flash_attention_bwd_ref`, which needs no lse; a CUDA tensor
    launches the backward kernels on the current stream, or raises, also
    where lse is missing."""
    _check_inputs(q, k, v, causal, window)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must match q: {tuple(t.shape)} {t.dtype} on {t.device}")
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, o, do, causal=causal, window=window)
    _check_card(q, k, v, do=do)
    b, sq, h, d = q.shape
    sk, kh = k.shape[1], k.shape[2]
    if lse is None:
        raise ValueError("the backward kernels read the forward's lse: pass the one "
                         "flash_attention_lse returned")
    if (lse.shape != (b, h, sq) or lse.dtype != torch.float32 or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be contiguous (B, H, Sq) float32 on {q.device}; got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}")
    for name, t in (("o", o), ("do", do)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    q, k, v, do = (_build.aligned(t) for t in (q, k, v, do))
    delta = torch.empty_like(lse)
    with torch.cuda.device(q.device):
        lib = _build.load("flash_attention_bwd", _BWD_SIGNATURES)
        code = lib.flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            DTYPES[q.dtype], b, sq, sk, h, kh, d, int(causal), window or 0,
            1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(lib, code, "flash_attention_bwd")
    launches[BWD_ROUTES[q.dtype]] += 1
    return dq, dk, dv


def kernel_info(dtype: torch.dtype, d: int) -> dict:
    """The forward's tiles and, from ``cudaFuncGetAttributes``, its kernel's
    registers, static and dynamic shared memory and local (spilled) bytes,
    for ``dtype`` at head dim ``d``, on the current device."""
    out = (ctypes.c_int * 7)()
    lib = _build.load("flash_attention", _SIGNATURES)
    _build.check(lib, lib.flash_attention_info(DTYPES[dtype], d, out), "flash_attention_info")
    keys = ("registers", "static_smem", "dynamic_smem", "local_bytes")
    return {"tiles": dict(zip(("queries", "keys", "threads"), out[:3])),
            "kernels": {FWD_KERNELS[dtype]: dict(zip(keys, out[3:7]))}}


def bwd_kernel_info(dtype: torch.dtype, d: int) -> dict:
    """The backward's tiles and, from ``cudaFuncGetAttributes``, each of its
    kernels' registers, static and dynamic shared memory and local
    (spilled) bytes, for ``dtype`` at head dim ``d``, on the current device."""
    out = (ctypes.c_int * 16)()
    lib = _build.load("flash_attention_bwd", _BWD_SIGNATURES)
    _build.check(lib, lib.flash_attention_bwd_info(DTYPES[dtype], d, out),
                 "flash_attention_bwd_info")
    keys = ("registers", "static_smem", "dynamic_smem", "local_bytes")
    return {"tiles": dict(zip(("dkdv_keys", "dkdv_queries", "dq_queries", "dq_keys"), out[:4])),
            "kernels": {name: dict(zip(keys, out[4 + 4 * i:8 + 4 * i]))
                        for i, name in enumerate(BWD_KERNELS[dtype])}}


class _Attention(torch.autograd.Function):
    """The forward kernel with :func:`flash_attention_bwd` as its backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = _forward(q, k, v, causal, window, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        do = dout.contiguous()
        if do.data_ptr() % 16:          # the bf16 kernels' TMA loads
            do = do.clone()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do, lse, causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Sk, K, D) with H % K == 0, and Sq <= Sk
    unless neither mask is on.  Returns (B, Sq, H, D) in q's dtype; scores,
    softmax and sums are f32.

    A CPU tensor goes to :func:`flash_attention_ref`, which autograd
    differentiates; a CUDA tensor launches its dtype's kernel on the current
    stream (``ROUTES``), through :class:`_Attention` where grad mode is on
    and an input requires grad, or raises.
    """
    _check_inputs(q, k, v, causal, window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    _check_card(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _Attention.apply(q, k, v, causal, window)
    return _forward(q, k, v, causal, window)
