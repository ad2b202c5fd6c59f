#!/usr/bin/env python3
"""Time variants of the rwkv6_scan backward (``csrc/rwkv6_scan_bwd.cu``) on
one NVIDIA card.

Each variant is the source with some of its sizes rewritten: steps a chunk
(T) and a sub-chunk (L), state columns a block (CW) and a thread (EC) of
phase C, and chunks in flight in phase B (U).  Every variant
is built with the port's nvcc flags (one nvcc each, all at once), held to the
plain backward (``ref.rwkv6_scan_bwd_ref``) at 1e-4 of each gradient's max,
and timed by CUDA-graph replay at ``chip_smoke.py``'s Z5b shapes and inputs.
``--source PATH`` (repeated) times other copies of the source with the same C
entry points beside them (an earlier commit's, say), each under its file name.

    python3 tools/rwkv_bwd_sweep.py [--source PATH ...] [--out results/rwkv_bwd_sweep.json]

Prints the card's name and power limit, then one JSON line a variant (its
registers, spills, and each kernel's shared memory and resident warps an SM)
and one a variant and shape: the error, whether two calls agree bit for bit,
the workspace, the call's time and each kernel's in one profiled call.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import rwkv6_scan as RS  # noqa: E402

# each variant's sizes over the shipped source's; the first is that source
VARIANTS = [{}, {"T": 64}, {"T": 40}, {"T": 32}, {"CW": 16}, {"EC": 4, "L": 16},
            {"CW": 16, "EC": 4, "L": 16}, {"T": 64, "CW": 16, "EC": 4, "L": 16}, {"U": 8}]
# chip_smoke.py's RWKV_BWD_SHAPES: (label, B, S, H, served decays)
SHAPES = [("rwkv_prefill", 4, 1000, 32, False), ("rwkv_train", 1, 4096, 32, True)]
BAR = 1e-4


def variant_source(sizes: dict) -> str:
    src = (_build.CSRC / "rwkv6_scan_bwd.cu").read_text()
    for name, value in sizes.items():
        src, n = re.subn(rf"constexpr int {name} = \d+;", f"constexpr int {name} = {value};", src)
        assert n == 1, name
    return src


def build(sources: dict) -> dict:
    """{tag: (library path or None, ptxas log)}, one nvcc a source, all at
    once; None where nvcc failed."""
    out_dir = _build.BUILD_DIR / "rwkv_bwd_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for tag, src in sources.items():
        cu = out_dir / f"{tag}.cu"
        cu.write_text(src)
        lib = out_dir / f"lib{tag}.so"
        cmd = [_build._nvcc(), *_build.FLAGS, "-I", str(_build.CSRC), "-o", str(lib), str(cu)]
        jobs[tag] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True), lib)
    built = {}
    for tag, (proc, lib) in jobs.items():
        log = proc.communicate()[0]
        built[tag] = (None if proc.returncode else lib, log)
    return built


def load(path):
    lib = ctypes.CDLL(str(path))
    for fn, (argtypes, restype) in RS._BWD_SIGNATURES.items():
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes, getattr(lib, fn).restype = argtypes, restype
    lib.kernel_error_string.argtypes, lib.kernel_error_string.restype = [ctypes.c_int], \
        ctypes.c_char_p
    return lib


def graph_ms(fn, reps: int = 3, replays: int = 5) -> float:
    """Device time of one call: ``reps`` calls in a CUDA graph, replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * reps)


def inputs(b, s, h, served_w, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    r, k, v = (0.5 * randn(b, s, h, 64) for _ in range(3))
    if served_w:
        w = torch.exp(-torch.exp(-4.0 + 0.5 * randn(b, s, h, 64)))
        u = 0.1 * randn(h, 64)
    else:
        w = torch.exp(-torch.exp(randn(b, s, h, 64) - 1.0))
        u = 0.3 * randn(h, 64)
    return (r, k, v, w, u, 0.2 * randn(b, h, 64, 64)), randn(b, s, h, 64), randn(b, h, 64, 64)


def run_one(lib, tag, ins, dout, dst, want):
    r = ins[0]
    b, s, h, d = r.shape
    outs = [torch.empty_like(r) for _ in range(4)] + [torch.empty_like(ins[4]),
                                                       torch.empty_like(ins[5])]
    work = torch.empty(lib.rwkv6_scan_bwd_workspace(b, s, h), dtype=torch.float32,
                       device="cuda")

    def call():
        code = lib.rwkv6_scan_bwd(*(t.data_ptr() for t in (*ins, dout, dst, *outs, work)),
                                  b, s, h, d, torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"{tag}: CUDA error {code}: "
                               f"{lib.kernel_error_string(code).decode()}")
    call()
    torch.cuda.synchronize()
    first = [o.clone() for o in outs]
    call()
    torch.cuda.synchronize()
    gaps = [float((g - w_).abs().max()) / float(w_.abs().max()) for g, w_ in zip(outs, want)]
    return {"rel_err": max(gaps), "equal_bits": all(torch.equal(a, o) for a, o in
                                                     zip(first, outs)),
            "workspace_mb": work.numel() * 4 / 1e6, "ms": graph_ms(call),
            "kernel_ms": kernel_ms(call)}


def kernel_ms(fn) -> dict:
    """Device time of each kernel function in one run of ``fn``, by
    ``torch.profiler``, under the function's bare name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.zeros(1, device="cuda")  # the window's first kernel can go unrecorded
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            m = re.search(r"(\w+)\(", e.name)
            name = m.group(1) if m else e.name
            out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path, action="append", default=[],
                    help="another rwkv6_scan_bwd.cu to time beside (repeatable)")
    ap.add_argument("--out", type=Path, help="write the rows here as JSON")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("rwkv_bwd_sweep: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    sources = {"_".join(f"{k}{v}" for k, v in sizes.items()) or "shipped": variant_source(sizes)
               for sizes in VARIANTS}
    for path in args.source:
        sources[path.stem] = path.read_text()
    built = build(sources)
    libs, rows, failed = {}, [], []
    for tag, (path, log) in built.items():
        if path is None:
            print(json.dumps({"variant": tag, "nvcc_failed": log[-2000:]}), flush=True)
            failed.append(tag)
            continue
        lib = libs[tag] = load(path)
        regs = [int(x) for x in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(x) for x in re.findall(r"(\d+) bytes spill stores", log))
        row = {"variant": tag, "registers": regs, "spill_bytes": spills}
        if hasattr(lib, "rwkv6_scan_bwd_info"):
            out = (ctypes.c_int * 29)()
            if lib.rwkv6_scan_bwd_info(out) == 0:
                row["kernels"] = {name: {"registers": out[4 + 6 * m],
                                         "dynamic_smem": out[6 + 6 * m],
                                         "local_bytes": out[7 + 6 * m],
                                         "warps_per_sm": out[9 + 6 * m] * out[8 + 6 * m] // 32}
                                  for m, name in enumerate(RS.BWD_KERNELS)}
                row["chunk_clusters"] = out[28]
        print(json.dumps(row), flush=True)
        rows.append(row)
    for label, b, s, h, served_w in SHAPES:
        ins, dout, dst = inputs(b, s, h, served_w, seed=3)
        want = ref.rwkv6_scan_bwd_ref(*ins, dout, dst)
        for tag, lib in libs.items():
            try:
                row = {"variant": tag, "shape": label,
                       **run_one(lib, tag, ins, dout, dst, want)}
            except RuntimeError as err:
                row = {"variant": tag, "shape": label, "error": str(err)}
            print(json.dumps(row), flush=True)
            rows.append(row)
            if "error" in row or row["rel_err"] > BAR or not row["equal_bits"]:
                failed.append(f"{tag} at {label}")
        del ins, dout, dst, want
        torch.cuda.empty_cache()
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    if failed:
        print(f"failed (nvcc, a CUDA error, off the plain backward by more than {BAR}, or "
              f"two calls differ): {failed}", file=sys.stderr)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
