"""Training launcher (twin of ``repro/launch/train.py``):
``python -m repro_torch.launch.train --arch <id> [--steps N --batch N --seq N
--lr X --full-size --mesh pod|multipod --ckpt PATH --log-every N --device
cuda|cpu]``.

Runs a reduced config, or the full one with ``--full-size``, end to end:
the synthetic token stream (``token_iter``, seed 0), ``make_train_step``
(loss, gradients, AdamW) from ``init_train_state`` (seed 0), and a
checkpoint of the parameters at the end.  Without ``--mesh`` on one device.
With ``--mesh pod|multipod`` one process a card under ``torchrun``
(``launch.mesh.start_from_env``) on the production mesh, which needs its
256 (512) ranks as the reference's needs its slice; the step is sharded by
the sharding rules (:func:`train_sharded`) and ``--ckpt`` saves the whole
tree from rank 0.
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.data.synthetic import token_iter
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import make_production_mesh, start_from_env
from repro_torch.models import transformer as T
from repro_torch.models.common import reduced
from repro_torch.sharding import rules
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train import init_train_state, make_train_step


def _train(step, params, opt, cfg, *, steps, batch, seq, log_every, device, log=True) -> tuple:
    """``steps`` steps on the token stream; returns ``(params, metrics of
    the last step)``.  ``log``: print the loss every ``log_every`` steps."""
    it = token_iter(batch, seq, cfg.vocab, seed=0)
    t0 = time.perf_counter()
    for i in range(steps):
        b = {k: torch.from_numpy(v).to(device) for k, v in next(it).items()}
        params, opt, m = step(params, opt, b)
        if log and i % log_every == 0:
            print(f"step {i:5d} loss {float(m['loss']):.4f} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    if log:
        print(f"final loss {float(m['loss']):.4f}")
    return params, m


def train_sharded(cfg, oc: OptConfig, mesh, *, steps=100, batch=8, seq=64, log_every=10,
                  ckpt=None, device="cuda") -> tuple:
    """The ``--mesh`` run on this rank of ``mesh`` (a ``DeviceMesh`` over a
    started group): the train state cut into this rank's blocks, the
    sharded ``make_train_step``, rank 0 printing the losses, and ``ckpt``
    saved whole.  Returns ``(this rank's parameter blocks, metrics of the
    last step)``."""
    dev = resolve_device(device)
    params, opt = init_train_state(0, cfg, oc, device=dev, mesh=mesh)
    step = make_train_step(cfg, oc, mesh=mesh)
    params, m = _train(step, params, opt, cfg, steps=steps, batch=batch, seq=seq,
                       log_every=log_every, device=dev, log=dist.get_rank() == 0)
    if ckpt:
        specs = rules.param_specs(T.param_spec(cfg), mesh, profile="train")
        checkpoint.save(ckpt, params, specs=specs, mesh=mesh)
        if dist.get_rank() == 0:
            print("saved", ckpt)
    return params, m


def main(argv=None) -> tuple:
    """Train ``--steps`` steps; returns ``(params, metrics of the last
    step)``, the parameters this rank's blocks under ``--mesh``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--full-size", action="store_true",
                    help="use the full config instead of the reduced one")
    ap.add_argument("--mesh", default=None, choices=[None, "pod", "multipod"])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = reduced(cfg)
    oc = OptConfig(lr=args.lr)
    run = dict(steps=args.steps, batch=args.batch, seq=args.seq, log_every=args.log_every)
    if args.mesh:
        dev = start_from_env(args.device)
        try:
            mesh = make_production_mesh(multi_pod=args.mesh == "multipod", device=dev)
            return train_sharded(cfg, oc, mesh, ckpt=args.ckpt, device=dev, **run)
        finally:
            dist.destroy_process_group()

    dev = resolve_device(args.device)
    params, opt = init_train_state(0, cfg, oc, device=dev)
    params, m = _train(make_train_step(cfg, oc), params, opt, cfg, device=dev, **run)
    if args.ckpt:
        checkpoint.save(args.ckpt, params)
        print("saved", args.ckpt)
    return params, m


if __name__ == "__main__":
    main()
