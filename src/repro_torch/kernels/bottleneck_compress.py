"""Split-point wire compression: encoder projection + ReLU + per-row int8.

Replaces the TPU kernel ``bottleneck_compress``
(``repro/kernels/bottleneck_compress.py:80``, ``pl.pallas_call`` at ``:94``)
with the CUDA C++ kernel in ``csrc/bottleneck_compress.cu`` for ``sm_90a``.

Bound on an H100: ``2*N*C*L`` float32 operations at 67 TFLOP/s against
``4*(N*C + C*L + L + N) + N*L`` bytes at 3.35 TB/s.  pool16, pool23 and the
llama cut are bound by operations, relu3 and the N = 8 cuts (``flatten``,
``fc0_relu``) by bytes.  One path: the product runs on the shared pipelined
f32 tile (``kernels/tiles.py`` picks it by shape), its epilogue writes
relu(z + b) to a scratch and each row's maximum by an exact ``atomicMax``,
and a second pass quantises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, tiles
from repro_torch.kernels.ref import bottleneck_compress_ref

# launches of the CUDA kernel, by tile (a CPU call launches nothing)
launches = {t: 0 for t in tiles.TILES}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "bottleneck_compress": ([_I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
}


def _check_inputs(f, w, b) -> None:
    if f.dim() != 2 or w.dim() != 2 or b.dim() != 1:
        raise ValueError(f"want f (N, C), w (C, L), b (L,); got {tuple(f.shape)}, "
                         f"{tuple(w.shape)}, {tuple(b.shape)}")
    if w.shape[0] != f.shape[1] or b.shape[0] != w.shape[1]:
        raise ValueError(f"shape mismatch: f {tuple(f.shape)}, w {tuple(w.shape)}, "
                         f"b {tuple(b.shape)}")
    for name, t in (("f", f), ("w", w), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != f.device:
            raise ValueError(f"{name} is on {t.device}, f on {f.device}")


def bottleneck_compress(f: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                        tile: str | None = None) -> tuple:
    """f: (N, C) f32; w: (C, L) f32; b: (L,) f32 -> (q int8 (N, L), s f32 (N, 1)).

    A CPU tensor goes to :func:`bottleneck_compress_ref`; a CUDA tensor
    launches the kernel on the current stream, or raises (also where grad
    mode is on and an input requires grad: the kernel has no backward).
    ``tile`` forces one of ``tiles.TILES`` (for timing and tests; every tile
    gives the same bits); the default is ``tiles.pick_tile``'s.
    """
    _check_inputs(f, w, b)
    tiles.check_name(tile)
    if f.device.type == "cpu":
        return bottleneck_compress_ref(f, w, b)
    if f.device.type != "cuda":
        raise ValueError(f"bottleneck_compress runs on cpu or cuda, not {f.device}")
    _build.refuse_grad("bottleneck_compress", _build.CODEC_NO_GRAD, f, w, b)
    n, c = f.shape
    l = w.shape[1]
    q = torch.empty((n, l), dtype=torch.int8, device=f.device)
    s = torch.empty((n, 1), dtype=torch.float32, device=f.device)
    if n == 0:
        return q, s
    tile = tiles.resolve(tile, n, c, l, f.device)
    with torch.cuda.device(f.device):
        lib = _build.load("bottleneck_compress", _SIGNATURES)
        z = torch.empty((n, l), dtype=torch.float32, device=f.device)
        row_max = torch.zeros((n,), dtype=torch.int32, device=f.device)
        code = lib.bottleneck_compress(
            list(tiles.TILES).index(tile), f.data_ptr(), w.data_ptr(), b.data_ptr(),
            z.data_ptr(), row_max.data_ptr(), q.data_ptr(), s.data_ptr(), n, c, l,
            torch.cuda.current_stream(f.device).cuda_stream)
        _build.check(lib, code, f"bottleneck_compress[{tile}]")
    launches[tile] += 1
    return q, s
