"""Build and load the port's CUDA kernels at first use.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``.  Libraries
go to ``<checkout>/build/kernels/`` (git-ignored) under a name that hashes
the sources and flags, so an edited source rebuilds and an unchanged one
is reused.  :func:`build` starts one ``nvcc`` per source, all at once.
``--use_fast_math`` stays off: the compress kernel needs IEEE division.
A failed build raises; nothing falls back to the plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("bottleneck_compress", "bottleneck_decompress", "flash_attention",
           "flash_attention_bwd", "mamba_scan", "mamba_scan_bwd", "rwkv6_scan",
           "rwkv6_scan_bwd")
FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
         "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                           "from source and need the CUDA toolkit")
    return nvcc


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` each, in parallel.  Returns ``{name: compiler log}`` (the
    ``-Xptxas -v`` register and shared-memory report) for those built now."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True),
                      tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if need be.

    ``signatures`` maps each C function to ``(argtypes, restype)``; pointers
    and the stream are ``c_void_p``, so ctypes never cuts them to 32 bits."""
    with _lock:
        if name not in _libs:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.kernel_error_string.argtypes = [ctypes.c_int]
            lib.kernel_error_string.restype = ctypes.c_char_p
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return _libs[name]


def check(lib, code: int, what: str) -> None:
    """Raise on a CUDA error code returned by a launcher."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code}: "
                           f"{lib.kernel_error_string(abs(code)).decode()}")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and on a 16-byte boundary (a copy where it is not),
    for a kernel's 16-byte copies."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def kernel_attributes(out, names) -> dict:
    """Each kernel's registers, static and dynamic shared memory, local
    (spilled) bytes, threads, resident blocks and warps an SM, from the six
    ints a kernel that a library's ``*_info`` call wrote after its four sizes
    (``out[4 + 6 m:10 + 6 m]`` for the kernel ``names[m]``)."""
    keys = ("registers", "static_smem", "dynamic_smem", "local_bytes", "threads",
            "ctas_per_sm")
    kernels = {name: dict(zip(keys, out[4 + 6 * m:10 + 6 * m])) for m, name in enumerate(names)}
    for info in kernels.values():
        info["warps_per_sm"] = info["ctas_per_sm"] * info["threads"] // 32
    return kernels


# why the codec kernels have no backward
CODEC_NO_GRAD = "the codec is not differentiated: a bottleneck trains on the f32 latent"


def refuse_grad(what: str, why: str, *tensors) -> None:
    """Raise where grad mode is on and an input requires grad.  A kernel
    with no backward returns a fresh tensor with no ``grad_fn``, so a
    gradient through it would come back as zero, with no error.  ``why``
    says why the kernel has none."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what}: an input requires grad, and the CUDA kernel has no "
                           f"backward ({why}); run it under torch.no_grad(), or on the CPU, "
                           "whose plain version differentiates")
