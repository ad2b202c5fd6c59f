"""The port's kernels: hand-written CUDA C++ for ``sm_90a`` with plain
PyTorch versions beside them (``ref``)."""
from repro_torch.kernels import (bottleneck_compress, bottleneck_decompress, flash_attention,
                                 mamba_scan, rwkv6_scan)

_COUNTERS = {"bottleneck_compress": bottleneck_compress.launches,
             "bottleneck_decompress": bottleneck_decompress.launches,
             "flash_attention": flash_attention.launches,
             "rwkv6_scan": rwkv6_scan.launches,
             "mamba_scan": mamba_scan.launches}


def launch_counts() -> dict:
    """``{kernel: {tile or route: launches}}`` since the last :func:`reset_launches`."""
    return {name: dict(counts) for name, counts in _COUNTERS.items()}


def reset_launches() -> None:
    for counts in _COUNTERS.values():
        for k in counts:
            counts[k] = 0
