"""Training launcher (twin of ``repro/launch/train.py``):
``python -m repro_torch.launch.train --arch <id> [--steps N --batch N --seq N
--lr X --full-size --ckpt PATH --log-every N --device cuda|cpu]``.

Runs a reduced config, or the full one with ``--full-size``, end to end on
one device: the synthetic token stream (``token_iter``, seed 0),
``make_train_step`` (loss, gradients, AdamW) from ``init_train_state``
(seed 0), and a checkpoint of the parameters at the end.  The reference's
``--mesh pod|multipod`` shards the step over a production mesh by its
sharding rules; the port has no such rules yet (ROADMAP A14b), so it
refuses the option.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.synthetic import token_iter
from repro_torch.device import resolve_device
from repro_torch.models.common import reduced
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train import init_train_state, make_train_step


def main(argv=None) -> tuple:
    """Train ``--steps`` steps; returns ``(params, metrics of the last
    step)``."""
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
    if args.mesh:
        raise NotImplementedError(f"--mesh {args.mesh}: sharded training over several cards "
                                  f"needs the sharding rules, ROADMAP A14b, not ported yet")

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = reduced(cfg)
    oc = OptConfig(lr=args.lr)
    params, opt = init_train_state(0, cfg, oc, device=dev)
    step = make_train_step(cfg, oc)
    it = token_iter(args.batch, args.seq, cfg.vocab, seed=0)
    t0 = time.perf_counter()
    for i in range(args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(it).items()}
        params, opt, m = step(params, opt, batch)
        if i % args.log_every == 0:
            print(f"step {i:5d} loss {float(m['loss']):.4f} "
                  f"({time.perf_counter() - t0:.1f}s)", flush=True)
    print(f"final loss {float(m['loss']):.4f}")
    if args.ckpt:
        checkpoint.save(args.ckpt, params)
        print("saved", args.ckpt)
    return params, m


if __name__ == "__main__":
    main()
