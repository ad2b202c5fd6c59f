"""Continuous-batching serving: a slot-based scheduler over the zoo's decode
step (twin of ``repro/serving/continuous.py``).

A fixed pool of batch slots; requests arrive over (simulated) ticks, each
is prefilled alone into its slot's rows of the stacked cache, every tick's
decode step advances *all* slots, and finished slots are freed and refilled
on the next tick.  Every slot keeps its own absolute position: the decode
step uses each slot's rope position and cache row (``serve_step_multi``),
so slots at different points of their requests decode exactly as each
request would alone.

The reference jit-compiles the step once for the slot pool; the port runs
it eagerly, writing the stacked cache in place.  ``SlotPool``, the
discipline this batcher and ``runtime.engine.TailServer`` share, is a copy
of the reference's.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.common import ModelConfig


class SlotPool:
    """A static number of slots (so the batched step keeps one shape),
    occupancy tracked per slot, freed slots refilled immediately."""

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        self.n_slots = n_slots
        self.items: List[Optional[object]] = [None] * n_slots

    def free_slots(self) -> List[int]:
        return [i for i, it in enumerate(self.items) if it is None]

    def admit(self, item) -> int:
        """Place ``item`` in the first free slot; returns the slot index."""
        free = self.free_slots()
        if not free:
            raise RuntimeError("slot pool full")
        self.items[free[0]] = item
        return free[0]

    def release(self, slot: int):
        item, self.items[slot] = self.items[slot], None
        return item

    def occupied(self) -> List[tuple]:
        """(slot, item) pairs for every active slot."""
        return [(i, it) for i, it in enumerate(self.items) if it is not None]

    def any_active(self) -> bool:
        return any(it is not None for it in self.items)

    def __len__(self) -> int:
        return self.n_slots


# the families whose layers all run the same decode step (the reference's
# demo covers these only)
FAMILIES = ("dense", "moe", "ssm")


@dataclass
class StreamRequest:
    rid: int
    prompt: np.ndarray
    max_new: int = 16
    arrival: int = 0                  # tick at which the request arrives
    out: List[int] = field(default_factory=list)
    done: bool = False


def serve_step_multi(params, cfg: ModelConfig, cache: dict, token: torch.Tensor,
                     pos: torch.Tensor):
    """The reference's name for ``transformer.serve_step`` with a position
    for each slot.  token: (B,1) int; pos: (B,) int32, each row's new
    position.  The cache is updated in place (each row's k, v and
    ``kv_pos`` at its own ``pos % sc``) and returned with the (B,V) f32
    logits."""
    return T.serve_step(params, cfg, cache, token, pos)


class ContinuousBatcher:
    """Fixed slot pool; iteration-level scheduling.  ``params`` must lie on
    ``device``.  ``steps`` counts the decode steps run (ticks with a slot
    active)."""

    def __init__(self, cfg: ModelConfig, params, *, n_slots: int = 4,
                 cache_len: int = 128, device="cuda"):
        if cfg.family not in FAMILIES:
            raise ValueError(f"continuous batching covers the {FAMILIES} families, "
                             f"not {cfg.family!r}")
        self.cfg, self.params = cfg, params
        self.n_slots, self.cache_len = n_slots, cache_len
        self.device = resolve_device(device)
        self.cache = T.init_cache(cfg, n_slots, cache_len, device=self.device)
        self.pos = torch.zeros((n_slots,), dtype=torch.int32, device=self.device)
        self.pool = SlotPool(n_slots)
        self.token = torch.zeros((n_slots, 1), dtype=torch.int32, device=self.device)
        self.steps = 0

    @property
    def active(self) -> List[Optional[StreamRequest]]:
        return self.pool.items

    def _step(self, cache, token, pos):
        return serve_step_multi(self.params, self.cfg, cache, token, pos)

    def _admit(self, req: StreamRequest, slot: int):
        """Prefill the request alone and copy its cache into ``slot``'s rows."""
        batch = {"tokens": torch.from_numpy(np.asarray(req.prompt, np.int32)[None, :])
                 .to(self.device)}
        logits, rcache, pos = T.prefill(self.params, self.cfg, batch, self.cache_len)
        for name, layer in rcache.items():
            for key, single in layer.items():
                self.cache[name][key][:, slot] = single[:, 0]
        self.pos[slot] = pos
        nxt = int(torch.argmax(logits[0]))
        req.out.append(nxt)
        self.token[slot, 0] = nxt
        self.pool.items[slot] = req

    def run(self, requests: List[StreamRequest], max_ticks: int = 256) -> List[StreamRequest]:
        """Drive arrivals and decode until every request finishes; returns
        them in the order they finished."""
        pending = sorted(requests, key=lambda r: r.arrival)
        tick = 0
        finished = []
        with torch.inference_mode():
            while (pending or self.pool.any_active()) and tick < max_ticks:
                for slot in self.pool.free_slots():
                    if pending and pending[0].arrival <= tick:
                        self._admit(pending.pop(0), slot)
                if self.pool.any_active():
                    logits, self.cache = self._step(self.cache, self.token, self.pos)
                    self.steps += 1
                    nxt = torch.argmax(logits, -1).to(torch.int32)
                    self.pos += torch.tensor([r is not None for r in self.active],
                                             dtype=torch.int32, device=self.device)
                    self.token = nxt[:, None]
                    host = nxt.tolist()
                    for slot, req in self.pool.occupied():
                        req.out.append(host[slot])
                        if len(req.out) >= req.max_new:
                            req.done = True
                            finished.append(req)
                            self.pool.release(slot)
                tick += 1
        return finished
