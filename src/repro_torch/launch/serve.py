"""Serving launcher (twin of ``repro/launch/serve.py``):
``python -m repro_torch.launch.serve --arch <id> [--batch N --prompt-len N
--max-new N --full-size --device cuda|cpu]``.

Batched greedy decoding through ``ServingEngine`` (prefill + KV-cache
decode) on a reduced config, or the full one with ``--full-size``; random
weights from ``init_params`` with seed 0, prompts from
``np.random.default_rng(0)``, as the reference draws them.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.common import reduced
from repro_torch.serving.engine import Request, ServingEngine


def _device_name(dev: torch.device) -> str:
    """The card's name, or ``"the host CPU"``."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "the host CPU"


def main(argv=None) -> list:
    """Serve ``--batch`` requests; prints the first four's tokens and the
    rate, and returns the finished requests."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--full-size", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full_size:
        cfg = reduced(cfg)
    params = T.init_params(0, cfg, device=dev)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab, args.prompt_len).astype(np.int32),
                    max_new=args.max_new)
            for i in range(args.batch)]
    engine = ServingEngine(cfg, params, cache_slots=args.prompt_len + args.max_new + 8,
                           device=dev)
    t0 = time.perf_counter()
    done = engine.run(reqs)
    dt = time.perf_counter() - t0      # the tokens reached the host: the work is done
    total_new = sum(len(r.out) for r in done)
    for r in done[:4]:
        print(f"req {r.rid}: {r.out}")
    print(f"{total_new} tokens in {dt:.2f}s ({total_new / dt:.1f} tok/s on {_device_name(dev)})")
    return done


if __name__ == "__main__":
    main()
