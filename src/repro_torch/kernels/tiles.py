"""The tile configurations of the codec kernels' shared f32 product
(``csrc/sgemm_tile.cuh``) and the pick among them.

Both ``bottleneck_compress`` and ``bottleneck_decompress`` run an (N, K) @
(K, M) product on one of these tiles: compress with (N, C, L), decompress
with (N, L, C).  Every tile sums each output in the same order, so the pick
moves only time.  ``TILES`` lists them in the order of the index the CUDA
launchers take (``sei::with_tile``), each with the (BM, BN) the pick reads;
the rest of each tile's geometry is the header's alone, and a CPU test
holds the two equal.
"""
from __future__ import annotations

import functools

import torch

TILES = {
    "wide": (64, 64),
    "mid": (32, 64),
    "narrow": (64, 32),
    "stream": (8, 32),
}
# N at or below this streams B through the 8-row tile
STREAM_ROWS = 16


def blocks(tile: str, n: int, m: int) -> int:
    """Blocks of ``tile`` over an (N, M) output."""
    bm, bn = TILES[tile]
    return -(-n // bm) * -(-m // bn)


def pick_tile(n: int, k: int, m: int, sms: int) -> str:
    """The tile for an (N, K) @ (K, M) product on a card with ``sms`` SMs.

    N <= 16 streams B through the 8-row tile: its time is the bytes of B.
    Else the 8 x 8 register blocks of ``wide`` where they give every SM at
    least four blocks; else ``mid`` where M is a whole number of its 64
    columns, ``narrow`` (32 columns) where it is not; and where that leaves
    more than half the SMs without a block, the 8-row tile, which spreads
    the rows eight times wider.  Chosen on an H100 from every tile's time
    at the codec's shapes (``chip_smoke.py`` phase 3 prints picked /
    fastest)."""
    del k  # every tile loops over K alike
    if n <= STREAM_ROWS:
        return "stream"
    if m >= 64 and blocks("wide", n, m) >= 4 * sms:
        return "wide"
    tile = "mid" if m % 64 == 0 else "narrow"
    return tile if blocks(tile, n, m) >= sms // 2 else "stream"


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_name(tile: str | None) -> None:
    """``ValueError`` unless ``tile`` is None or names one of ``TILES``."""
    if tile is not None and tile not in TILES:
        raise ValueError(f"unknown tile {tile!r}; use one of {tuple(TILES)}")


def resolve(tile: str | None, n: int, k: int, m: int, device: torch.device) -> str:
    """``tile``, or the pick for the card that holds ``device``."""
    return tile or pick_tile(n, k, m, sm_count(device.index or 0))
