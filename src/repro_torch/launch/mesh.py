"""Meshes over the ranks of ``torch.distributed`` (twin of
``repro/launch/mesh.py``).

Functions, not module-level constants: importing this module touches no
device and no process group.  Where JAX builds a mesh over the devices it
sees, a torch mesh is laid over the ranks of a process group, so the port
also needs to start one: :func:`start_process_group` does, from an explicit
backend, rank, world size and rendezvous address, and :func:`spawn_ranks`
runs a function in that many local processes.
"""
from __future__ import annotations

import math
import os
import queue
import socket
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.device import resolve_device

BACKENDS = ("gloo", "nccl")


def refuse_shared_devices(backend: str, placements: list) -> None:
    """``ValueError`` where ``nccl`` would put two ranks on one device, or a
    rank off the card.  ``placements[r]`` is rank r's ``"host/device"``.
    NCCL takes one rank a card; ``gloo`` takes any placement, since the
    port stages its wire through host memory."""
    if backend != "nccl":
        return
    seen = {}
    for rank, where in enumerate(placements):
        if where in seen:
            host, device = where.split("/", 1)
            raise ValueError(f"nccl needs each rank on a card of its own: ranks {seen[where]} "
                             f"and {rank} are both on {device} of {host}; start the group with "
                             f"backend='gloo' to share one card")
        seen[where] = rank
    for rank, where in enumerate(placements):
        if not where.split("/", 1)[1].startswith("cuda"):
            raise ValueError(f"nccl carries CUDA tensors only: rank {rank} is on {where}")


def start_process_group(backend: str, rank: int, world_size: int, init_method: str, *,
                        device="cuda", timeout_s: float = 300.0) -> torch.device:
    """Start this process's default group and return its device.

    ``init_method`` is a rendezvous address (``file://`` or
    ``tcp://localhost:<port>``).  The ranks first trade their host and
    device through the rendezvous store (:func:`refuse_shared_devices`),
    then start the group; a rank that does not arrive within ``timeout_s``
    makes the others raise instead of waiting, and every collective of the
    group keeps that timeout.  A CUDA ``device`` becomes this process's
    current device, so that a mesh built later keeps it."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; use one of {BACKENDS}")
    dev = resolve_device(device)
    timeout = timedelta(seconds=timeout_s)
    store, rank, world_size = next(dist.rendezvous(init_method, rank, world_size,
                                                   timeout=timeout))
    store.set_timeout(timeout)
    store.set(f"placement/{rank}", f"{socket.gethostname()}/{dev}")
    refuse_shared_devices(backend, [store.get(f"placement/{r}").decode()
                                    for r in range(world_size)])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=timeout)
    return dev


def start_from_env(device="cuda", *, timeout_s: float = 300.0) -> torch.device:
    """Start this process's default group as ``torchrun`` describes it
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT`` in the environment, ``init_method="env://"``) through
    :func:`start_process_group`: ``nccl`` on ``cuda:$LOCAL_RANK``, or
    ``gloo`` where ``device`` is the CPU.  Returns the device."""
    rank, world, local = (int(os.environ[k]) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"))
    dev = resolve_device(device)
    if dev.type == "cuda":
        return start_process_group("nccl", rank, world, "env://",
                                   device=torch.device("cuda", local), timeout_s=timeout_s)
    return start_process_group("gloo", rank, world, "env://", device=dev, timeout_s=timeout_s)


def _rank_entry(fn, rank, world_size, boxed, results) -> None:
    # the arguments' only reference, so that CUDA tensors mapped from the
    # parent are released as soon as ``fn`` returns, before the parent
    # collects them (spawn_ranks): the parent holds every block it sent until
    # it sees the release and collects
    args = boxed.pop()
    try:
        out = fn(rank, world_size, *args)
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    del args
    results.put((rank, True, out))


def spawn_ranks(fn, world_size: int, args: tuple = (), *, timeout_s: float = 600.0) -> list:
    """``[fn(rank, world_size, *args) for each rank]``, each rank in a process
    of its own (``spawn``: no CUDA context crosses a fork).  ``fn`` is a
    module-level function; CUDA tensors in ``args`` reach the ranks through
    CUDA IPC, without a copy, and stay the caller's (a rank drops them when
    ``fn`` returns, and the caller's memory behind them is freed here once
    the caller drops them too).  Each result comes
    back pickled, so return host values.  A rank that raises, dies or does
    not finish within ``timeout_s`` ends every rank, and this raises."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_entry, args=(fn, rank, world_size, [args], results),
                         daemon=True) for rank in range(world_size)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    out = {}
    try:
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(out))} did not "
                                   f"finish within {timeout_s} s")
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode is not None and r not in out]
                if dead:
                    # a last result may still be in flight from a rank that just exited
                    try:
                        rank, ok, value = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} and no result") from None
                else:
                    continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=max(1.0, min(30.0, deadline - time.monotonic())))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        if torch.cuda.is_initialized():
            torch.cuda.ipc_collect()    # free what the ranks mapped and released
    return [out[r] for r in range(world_size)]


def make_mesh_compat(shape: tuple, axes: tuple, *, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over every rank of the
    default group, which must be started (:func:`start_process_group`) and
    hold exactly ``prod(shape)`` ranks."""
    dev = resolve_device(device)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {tuple(shape)} and axes {tuple(axes)} differ in length")
    if not dist.is_initialized():
        raise RuntimeError("no process group: start one first (start_process_group)")
    need, world = math.prod(shape), dist.get_world_size()
    if need != world:
        raise ValueError(f"a {tuple(shape)} mesh needs {need} ranks; the world has {world}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(axes))


def production_mesh_shape(*, multi_pod: bool = False, model_axis: int = 16) -> tuple:
    """``(shape, axes)`` of the production mesh: (data, model) with data *
    model = 256 ranks; multi-pod puts pod = 2 in front (512).

    ``model_axis`` is a per-architecture knob: 16 suits head counts that
    are multiples of 16; llama3.2-3b (24 heads) and whisper-tiny (6) want 8."""
    if model_axis <= 0 or 256 % model_axis:
        raise ValueError(f"model_axis {model_axis} does not divide 256")
    data = 256 // model_axis
    if multi_pod:
        return (2, data, model_axis), ("pod", "data", "model")
    return (data, model_axis), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, model_axis: int = 16, device="cuda"):
    """The production mesh (:func:`production_mesh_shape`); raises unless
    the world holds exactly its 256 (512) ranks."""
    shape, axes = production_mesh_shape(multi_pod=multi_pod, model_axis=model_axis)
    return make_mesh_compat(shape, axes, device=device)


def make_host_mesh(*, device="cuda"):
    """The degenerate one-rank ``("data", "model")`` mesh."""
    return make_mesh_compat((1, 1), ("data", "model"), device=device)
