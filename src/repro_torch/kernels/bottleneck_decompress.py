"""Split-point wire decompression: dequantise + AE-decoder projection.

Replaces the TPU kernel ``bottleneck_decompress``
(``repro/kernels/bottleneck_decompress.py:41``, ``pl.pallas_call`` at
``:54``) with the CUDA C++ kernel in ``csrc/bottleneck_decompress.cu`` for
``sm_90a``.

Bound on an H100: ``2*N*L*C`` float32 operations at 67 TFLOP/s against
``N*L + 4*(N + L*C + C + N*C)`` bytes at 3.35 TB/s: operations for pool16,
pool23 and the llama cut, bytes for relu3 and the N = 8 cuts.  The design
is the shared pipelined f32 tile (``kernels/tiles.py`` picks it by shape,
with (N, L, C)) with the codes as its int8 operand, dequantised once per
element as they leave shared memory, so the f32 latent never reaches
device memory.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, tiles
from repro_torch.kernels.ref import bottleneck_decode_ref

# launches of the CUDA kernel, by tile (a CPU call launches nothing)
launches = {t: 0 for t in tiles.TILES}

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "bottleneck_decompress": ([_I, _P, _P, _P, _P, _P, _I, _I, _I, _P], _I),
}


def _check_inputs(q, s, w, b) -> None:
    if q.dim() != 2 or s.dim() != 2 or w.dim() != 2 or b.dim() != 1:
        raise ValueError(f"want q (N, L), s (N, 1), w (L, C), b (C,); got "
                         f"{tuple(q.shape)}, {tuple(s.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    if (s.shape != (q.shape[0], 1) or w.shape[0] != q.shape[1]
            or b.shape[0] != w.shape[1]):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, s {tuple(s.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    if q.dtype != torch.int8:
        raise TypeError(f"q must be int8, got {q.dtype}")
    for name, t in (("q", q), ("s", s), ("w", w), ("b", b)):
        if name != "q" and t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")


def bottleneck_decompress(q: torch.Tensor, s: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor, *, tile: str | None = None) -> torch.Tensor:
    """q: (N, L) int8; s: (N, 1) f32; w: (L, C) f32; b: (C,) f32 -> (N, C) f32.

    A CPU tensor goes to :func:`bottleneck_decode_ref`; a CUDA tensor
    launches the kernel on the current stream, or raises (also where grad
    mode is on and an input requires grad: the kernel has no backward).
    ``tile`` forces one of ``tiles.TILES`` (for timing and tests; every tile
    gives the same bits); the default is ``tiles.pick_tile``'s.
    """
    _check_inputs(q, s, w, b)
    tiles.check_name(tile)
    if q.device.type == "cpu":
        return bottleneck_decode_ref(q, s, w, b)
    if q.device.type != "cuda":
        raise ValueError(f"bottleneck_decompress runs on cpu or cuda, not {q.device}")
    _build.refuse_grad("bottleneck_decompress", _build.CODEC_NO_GRAD, q, s, w, b)
    n, l = q.shape
    c = w.shape[1]
    out = torch.empty((n, c), dtype=torch.float32, device=q.device)
    if n == 0:
        return out
    tile = tiles.resolve(tile, n, l, c, q.device)
    with torch.cuda.device(q.device):
        lib = _build.load("bottleneck_decompress", _SIGNATURES)
        code = lib.bottleneck_decompress(
            list(tiles.TILES).index(tile), q.data_ptr(), s.data_ptr(), w.data_ptr(),
            b.data_ptr(), out.data_ptr(), n, l, c,
            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(lib, code, f"bottleneck_decompress[{tile}]")
    launches[tile] += 1
    return out
