"""Live split execution: head on the edge, tail on the server, the int8
wire in between (twin of ``repro/runtime/engine.py``).

* :class:`SplitRuntime` — one client end to end: stage forward, wire encode
  -> bytes -> (netsim-priced transfer) -> decode, next stage.  Every stage
  is timed on the host clock behind a ``torch.cuda.synchronize()`` fence.
  With a :class:`~repro_torch.runtime.faults.FaultPlan` the chain runs under
  the retry, backoff, codec-downgrade and local-fallback machinery of a
  :class:`~repro_torch.runtime.faults.RecoveryPolicy`.
* :class:`TailServer` — the server side under many clients: tail requests
  queue and are batched through a fixed :class:`SlotPool`, one batched tail
  forward per step; a fault plan makes it reject corrupted frames and go
  dark in blackout windows.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.netsim.channel import Channel
from repro_torch.netsim.protocols import simulate_transfer
from repro_torch.obs import NULL, Span, labelled
from repro_torch.runtime import wire as W
from repro_torch.runtime.faults import (FaultError, FaultPlan, RecoveryExhausted,
                                        RecoveryPolicy, downgrade_ladder)
from repro_torch.runtime.partition import Partition, make_partition
from repro_torch.serving.continuous import SlotPool


def _fence() -> None:
    """Wait for the card, where one is in use (kernels launch asynchronously)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def timeit_blocked(fn, *args, iters: int = 3, warmup: int = 1) -> tuple:
    """(best seconds, last output), warm-up excluded, fenced on the card.

    Min over iterations, not mean: the repeatable cost of the stage.
    """
    out = None
    for _ in range(max(1, warmup)):
        out = fn(*args)
        _fence()
    best = float("inf")
    for _ in range(max(1, iters)):
        t0 = time.perf_counter()
        out = fn(*args)
        _fence()
        best = min(best, time.perf_counter() - t0)
    return best, out


@dataclass
class RuntimeResult:
    """One timed end-to-end split inference.

    ``head_s`` is stage 0, ``tail_s`` sums the later stages, and
    ``encode_s``/``transfer_s``/``decode_s``/``wire_bytes`` sum over hops;
    ``stage_s`` and ``hops`` keep the breakdown, and ``trace`` holds it as
    a span tree.  ``total_s`` is transfer-inclusive and equals the root
    span's duration.
    """
    logits: np.ndarray
    split_layer: int                 # first (edge-side) cut
    head_s: float
    encode_s: float
    transfer_s: float                # netsim-priced wire time (0 w/o channel)
    decode_s: float
    tail_s: float
    wire_bytes: int
    meta: dict = field(default_factory=dict)
    splits: tuple = ()               # full ordered cut list
    stage_s: tuple = ()              # per-stage compute seconds (K+1)
    hops: tuple = ()                 # per-hop dicts: bytes/encode_s/...
    trace: Optional[Span] = None     # root span of the timing tree

    @property
    def compute_s(self) -> float:
        return self.head_s + self.encode_s + self.decode_s + self.tail_s

    @property
    def total_s(self) -> float:
        return self.compute_s + self.transfer_s


def build_infer_spans(stage_s, hops, splits, *, base: float = 0.0,
                      clock: str = "wall", tid: str = "runtime") -> Span:
    """The span tree of one timed split inference, laid out back to back
    from ``base``; the root's duration is the sum of its leaves."""
    total = sum(stage_s) + sum(h["encode_s"] + h["transfer_s"]
                               + h["decode_s"] for h in hops)
    root = Span("infer", base, base + total, clock, tid, "runtime",
                {"splits": list(splits)})
    t = base
    for k, s in enumerate(stage_s):
        root.children.append(Span(f"stage{k}", t, t + s, clock, tid,
                                  "runtime", {"k": k}))
        t += s
        if k >= len(hops):
            continue
        h = hops[k]
        hop = Span(f"hop{k}", t, t + h["encode_s"] + h["transfer_s"]
                   + h["decode_s"], clock, tid, "runtime",
                   {"cut": h["cut"], "bytes": h["bytes"]})
        root.children.append(hop)
        # a recovering hop carries its event log (timeouts, backoffs,
        # re-encodes); its buckets sum to encode_s/transfer_s/decode_s
        events = h.get("events") or [(part, part, h[f"{part}_s"])
                                     for part in ("encode", "transfer",
                                                  "decode")]
        for name, _bucket, d in events:
            hop.children.append(Span(name, t, t + d, clock, tid, "runtime"))
            t += d
    return root


class SplitRuntime:
    """Execute a model split at ``split_layer`` (one cut or an ordered cut
    list) end to end on ``device``.

    ``channel``/``protocol`` price the wire hops with the discrete-event
    transport models (the bytes are real, the network is simulated); one
    channel prices every hop, a sequence prices hop k with entry k.  The
    kind per hop is 'ae8' where the cut has an AE, else 'int8' ('f32' with
    ``quantize=False``).  ``fused=True`` runs each leg as one fused segment
    (``Partition.fused_segments``): the codec moves into ``stage_s`` and
    hop ``encode_s``/``decode_s`` shrink to framing and parsing; the bytes
    on the wire are the same.

    ``faults``/``recovery``: a fault plan runs every ``infer`` through
    :meth:`_run_recovering`; ``faults=None`` leaves the paths above and their
    SEI1 frames untouched.
    """

    def __init__(self, model, params, split_layer, *,
                 ae: Optional[dict] = None, channel=None, protocol: str = "tcp",
                 quantize: bool = True, fused: bool = False, obs=None,
                 faults: Optional[FaultPlan] = None,
                 recovery: Optional[RecoveryPolicy] = None, device="cuda"):
        self.part: Partition = make_partition(model, params, split_layer, ae,
                                              device=device)
        self.device = self.part.device
        self.channel, self.protocol = channel, protocol
        self.quantize = quantize
        self.fused = fused
        self.hops = self._resolve_hops(channel, protocol)
        self.obs = NULL if obs is None else obs
        self.faults = faults
        self.recovery = recovery if recovery is not None else RecoveryPolicy()

    def _resolve_hops(self, channel, protocol) -> list:
        """Per-hop (protocol, channel) pairs; None entries skip pricing."""
        n = len(self.part.splits)
        if channel is None:
            return [None] * n
        if isinstance(channel, Channel):
            return [(protocol, channel)] * n
        hops = []
        for h in channel:
            if isinstance(h, Channel):
                hops.append((protocol, h))
            elif h is None:
                hops.append(None)
            else:                            # a NetworkConfig-shaped hop
                hops.append((h.protocol, h.channel))
        if len(hops) != n:
            raise ValueError(f"{n} cuts need {n} priced hops, got {len(hops)}")
        return hops

    def _price_hop(self, k: int, nbytes: int, stream: int) -> tuple:
        """netsim-priced transfer of hop k: (transfer_s, transport meta)."""
        if self.hops[k] is None:
            return 0.0, {}
        proto, ch = self.hops[k]
        tr = simulate_transfer(proto, nbytes, ch, stream=stream + 137 * k)
        return tr.duration_s, {"n_packets": tr.n_packets,
                               "n_transmissions": tr.n_transmissions,
                               "loss_fraction": tr.loss_fraction}

    def _input(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def infer(self, x, *, iters: int = 3, stream: int = 0,
              rid: int = 0) -> RuntimeResult:
        """Timed stage -> wire -> stage ... execution of one input batch.
        ``rid`` keys the fault plan's draws (ignored without a plan)."""
        if self.faults is not None:
            logits, stage_s, hops, extra = self._run_recovering(
                self._input(x), iters=iters, stream=stream, rid=rid)
            return self._package(logits, stage_s, hops, extra)
        run = self._run_fused if self.fused else self._run_eager
        logits, stage_s, hops = run(self._input(x), iters=iters, stream=stream)
        return self._package(logits, stage_s, hops)

    def _run_eager(self, x, *, iters: int, stream: int) -> tuple:
        """Op-by-op path: stage, then the codec through host bytes (the
        exactness and accounting oracle for the fused path)."""
        cur = x
        stage_s, hops = [], []
        for k in range(self.part.n_stages):
            s, cur = timeit_blocked(self.part.stage(k), cur, iters=iters)
            stage_s.append(s)
            if k >= len(self.part.splits):
                break
            ae_k = self.part.ae_map.get(self.part.splits[k])
            encode_s, buf = timeit_blocked(
                lambda v: W.to_bytes(W.encode_activation(v, ae_k,
                                                         quantize=self.quantize)),
                cur, iters=iters)
            transfer_s, meta = self._price_hop(k, len(buf), stream)
            decode_s, cur = timeit_blocked(
                lambda b: W.decode_activation(W.from_bytes(b), ae_k,
                                              device=self.device),
                buf, iters=iters)
            hops.append({"cut": self.part.splits[k], "bytes": len(buf),
                         "encode_s": encode_s, "transfer_s": transfer_s,
                         "decode_s": decode_s, **meta})
        return cur, stage_s, hops

    def _run_fused(self, x, *, iters: int, stream: int) -> tuple:
        """Fused-boundary path: one segment per leg.  The middle and last
        legs are timed as ``seg(parse(buf))``; the parse is timed on its
        own and subtracted, so ``decode_s`` and ``stage_s`` stay apart."""
        segs = self.part.fused_segments(quantize=self.quantize)
        kinds = self.part.wire_kinds(self.quantize)
        parse = lambda b: W.parse_arrays(b, device=self.device)
        stage_s, hops = [], []
        s0, out = timeit_blocked(segs[0], x, iters=iters)
        stage_s.append(s0)
        for k in range(len(self.part.splits)):
            encode_s, buf = timeit_blocked(
                lambda d, s, kk=k: W.frame_arrays(kinds[kk], d, s),
                out[0], out[1], iters=iters)
            transfer_s, meta = self._price_hop(k, len(buf), stream)
            parse_s, _ = timeit_blocked(parse, buf, iters=iters)
            leg_s, out = timeit_blocked(lambda b, kk=k: segs[kk + 1](parse(b)),
                                        buf, iters=iters)
            stage_s.append(max(0.0, leg_s - parse_s))
            hops.append({"cut": self.part.splits[k], "bytes": len(buf),
                         "encode_s": encode_s, "transfer_s": transfer_s,
                         "decode_s": parse_s, **meta})
        return out, stage_s, hops

    # ------------------------------------------------------- recovery ----
    def _encode_rung(self, f, ae_k, kind: str) -> bytes:
        """The boundary activation at one degradation rung, as a checksummed
        (SEI2) frame; lower rungs re-encode from the same activation."""
        if kind == "ae8":
            pkt = W.encode_activation(f, ae_k, quantize=True)
        else:
            pkt = W.encode_activation(f, None, quantize=(kind == "int8"))
        return W.to_bytes(pkt, checksum=True)

    @staticmethod
    def _payload_lo(buf: bytes) -> int:
        """First payload byte of an SEI2 frame: corruption aims past the
        header, so the CRC, not the magic, has to catch it."""
        return 6 + 4 * buf[5] + 8

    def _run_stage_faulted(self, k: int, cur, *, iters, rid, plan,
                           counts, rec):
        """Stage k under injected stage exceptions: retried until the plan
        stops faulting (at most ``max_consecutive`` times), each crashed
        attempt charged one stage execution."""
        attempt = 0
        while True:
            try:
                if plan.stage_fault(rid, k, attempt):
                    raise FaultError(
                        f"injected fault in stage {k} (attempt {attempt})")
                s, out = timeit_blocked(self.part.stage(k), cur, iters=iters)
                break
            except FaultError:
                counts["stage"] += 1
                rec["retries"] += 1
                attempt += 1
        return s * (1 + attempt), out

    def _recover_hop(self, k: int, cur, *, iters, stream, rid,
                     counts, rec, t: float):
        """Hop k under the fault plan: attempts with RTO-derived timeouts,
        backoff, codec downgrade and local-fallback escalation.  Returns
        ``(boundary, hop_dict, t, fell_back)``; on a fall back the boundary
        is the exact activation, still on the device."""
        plan, pol = self.faults, self.recovery
        cut = self.part.splits[k]
        ae_k = self.part.ae_map.get(cut)
        ladder = downgrade_ladder(W.wire_kind(ae_k, self.quantize))
        ch_k = None if self.hops[k] is None else self.hops[k][1]
        last_hop = k == len(self.part.splits) - 1
        events, tmeta = [], {}
        rung, corruptions, attempt = 0, 0, 0
        fell_back = False

        def encode(rung_kind):
            return timeit_blocked(
                lambda v: self._encode_rung(v, ae_k, rung_kind), cur,
                iters=iters)

        enc_s, buf = encode(ladder[rung])
        events.append(("encode", "encode", enc_s))
        t += enc_s
        while True:
            if attempt >= pol.max_attempts or (
                    pol.deadline_s is not None and t >= pol.deadline_s):
                if not pol.local_fallback:
                    raise RecoveryExhausted(
                        f"hop {k}: {attempt} attempts, "
                        f"t={t:.3f}s of budget {pol.deadline_s}")
                rec["local_fallback"] = True
                fell_back = True
                break
            fate = plan.transfer_fault(rid, k, attempt)
            if last_hop and plan.blackout_at(t):
                fate = "blackout"     # the server leg is dark: a timeout
            if fate in ("drop", "blackout"):
                counts[fate] += 1
                lost_s = pol.timeout_s(ch_k, len(buf))
                back = pol.backoff_s(attempt, seed=plan.seed, rid=rid,
                                     hop=k, channel=ch_k)
                events.append((f"{fate}-timeout", "transfer", lost_s))
                events.append(("backoff", "transfer", back))
                t += lost_s + back
                rec["timeouts"] += 1
                rec["backoff_s"] += back
                rec["retries"] += 1
                attempt += 1
                continue
            transfer_s, tmeta = self._price_hop(k, len(buf),
                                                stream + 7919 * attempt)
            if fate == "corrupt":
                counts["corrupt"] += 1
                events.append(("transfer", "transfer", transfer_s))
                t += transfer_s
                bad = plan.corrupt_bytes(buf, rid, k, attempt,
                                         lo=self._payload_lo(buf))
                try:
                    W.from_bytes(bad)
                    raise AssertionError(
                        "corrupted SEI2 frame decoded cleanly")
                except W.WireError as e:
                    rec["log"].append(
                        {"event": "corrupt", "hop": k, "attempt": attempt,
                         "error": str(e)})
                corruptions += 1
                back = pol.backoff_s(attempt, seed=plan.seed, rid=rid,
                                     hop=k, channel=ch_k)
                events.append(("backoff", "transfer", back))
                t += back
                rec["backoff_s"] += back
                rec["retries"] += 1
                if corruptions >= pol.downgrade_after \
                        and rung + 1 < len(ladder):
                    rung += 1
                    corruptions = 0
                    rec["downgrades"].append(
                        {"hop": k, "to": ladder[rung], "attempt": attempt})
                    enc_s, buf = encode(ladder[rung])
                    events.append(("re-encode", "encode", enc_s))
                    t += enc_s
                attempt += 1
                continue
            # delivered, possibly late (a straggling tail server)
            if fate == "straggle":
                counts["straggle"] += 1
                events.append(("straggle", "transfer", plan.straggle_s))
                t += plan.straggle_s
            events.append(("transfer", "transfer", transfer_s))
            t += transfer_s
            dec_s, cur = timeit_blocked(
                lambda b, kk=ladder[rung]: W.decode_activation(
                    W.from_bytes(b), ae_k if kk == "ae8" else None,
                    device=self.device),
                buf, iters=iters)
            events.append(("decode", "decode", dec_s))
            t += dec_s
            break
        hop = {"cut": cut, "bytes": len(buf),
               "encode_s": sum(d for _, b, d in events if b == "encode"),
               "transfer_s": sum(d for _, b, d in events if b == "transfer"),
               "decode_s": sum(d for _, b, d in events if b == "decode"),
               "attempts": attempt + (0 if fell_back else 1),
               "kind": ladder[rung], "delivered": not fell_back,
               "events": events, **tmeta}
        return cur, hop, t, fell_back

    def _run_recovering(self, x, *, iters: int, stream: int,
                        rid: int) -> tuple:
        """The eager stage chain under the fault plan and the recovery
        policy.  Eager even under ``fused=True`` (``exec: "eager"`` in the
        record): a downgrade re-encodes from the raw boundary activation,
        which the fused segments never expose.  Frames ship as SEI2, so a
        corrupted one is caught by its CRC and never decoded."""
        plan = self.faults
        counts = {"drop": 0, "corrupt": 0, "straggle": 0, "stage": 0,
                  "blackout": 0}
        rec = {"retries": 0, "timeouts": 0, "backoff_s": 0.0,
               "downgrades": [], "local_fallback": False, "exec": "eager",
               "log": []}
        t = 0.0
        cur = x
        stage_s, hops = [], []
        for k in range(self.part.n_stages):
            s, cur = self._run_stage_faulted(k, cur, iters=iters, rid=rid,
                                             plan=plan, counts=counts,
                                             rec=rec)
            stage_s.append(s)
            t += s
            if k >= len(self.part.splits):
                break
            cur, hop, t, fell_back = self._recover_hop(
                k, cur, iters=iters, stream=stream, rid=rid,
                counts=counts, rec=rec, t=t)
            hops.append(hop)
            if fell_back:
                # the server leg is out of budget: the edge runs every
                # remaining stage on the exact boundary activation
                for j in range(k + 1, self.part.n_stages):
                    s, cur = self._run_stage_faulted(
                        j, cur, iters=iters, rid=rid, plan=plan,
                        counts=counts, rec=rec)
                    stage_s.append(s)
                    t += s
                break
        rec["t_virtual_s"] = t
        obs = self.obs
        if obs.enabled:
            now = obs.tracer.wall_now()
            for name, v in counts.items():
                if v:
                    obs.metrics.counter(f"runtime.fault.{name}").inc(v)
            obs.metrics.counter("runtime.retry.attempts").inc(rec["retries"])
            obs.metrics.counter("runtime.retry.timeouts").inc(rec["timeouts"])
            obs.metrics.counter("runtime.retry.backoff_s").inc(
                rec["backoff_s"])
            obs.metrics.counter("runtime.retry.downgrades").inc(
                len(rec["downgrades"]))
            if rec["local_fallback"]:
                obs.metrics.counter("runtime.retry.local_fallback").inc()
            obs.metrics.record("runtime.retry.t_virtual_s", now, t)
        extra = {"degraded": bool(rec["downgrades"]) or rec["local_fallback"],
                 "local_fallback": rec["local_fallback"],
                 "recovery": {**rec, "faults": counts}}
        return cur, stage_s, hops, extra

    def _package(self, logits, stage_s, hops,
                 extra_meta: Optional[dict] = None) -> RuntimeResult:
        result = RuntimeResult(
            logits.cpu().numpy(), self.part.split_layer,
            stage_s[0],
            sum(h["encode_s"] for h in hops),
            sum(h["transfer_s"] for h in hops),
            sum(h["decode_s"] for h in hops),
            sum(stage_s[1:]),
            sum(h["bytes"] for h in hops),
            {**(dict(hops[0]) if len(hops) == 1 else {"hops": hops}),
             "fused": self.fused, **(extra_meta or {})},
            splits=self.part.splits, stage_s=tuple(stage_s),
            hops=tuple(hops))
        obs = self.obs
        if obs.enabled:
            # anchor the reconstructed timeline so successive infers on one
            # recorder don't overlap
            end = obs.tracer.wall_now()
            result.trace = build_infer_spans(
                stage_s, hops, self.part.splits,
                base=max(0.0, end - result.total_s))
            obs.tracer.extend(result.trace.walk())
            for k, s in enumerate(stage_s):
                obs.metrics.record(labelled("runtime.stage_s", k=k), end, s)
            for k, h in enumerate(hops):
                obs.metrics.record(labelled("runtime.hop_bytes", k=k), end,
                                   h["bytes"])
        else:
            result.trace = build_infer_spans(stage_s, hops, self.part.splits)
        return result

    def reference(self, x) -> np.ndarray:
        """Unsplit forward of the same params (equivalence oracle)."""
        return self.part.full(self._input(x)).cpu().numpy()


# -------------------------------------------------------- multi-client ----
@dataclass
class TailRequest:
    client_id: int
    payload: bytes                   # serialized wire packet
    t_submit: float = 0.0


class TailServer:
    """Server side of the split runtime under N edge clients.

    Requests (wire byte strings) queue; each :meth:`step` admits up to
    ``n_slots`` of them into the slot pool, decodes them, and runs one
    batched tail forward for the whole pool (empty slots padded with zeros,
    their outputs discarded), so the tail always sees one shape.  With a
    fault plan, :meth:`submit` checks each frame's CRC and rejects a
    corrupted one, and :meth:`step` serves nothing inside a blackout window.
    """

    def __init__(self, part: Partition, *, n_slots: int = 4,
                 client_batch: int = 1,
                 faults: Optional[FaultPlan] = None, device="cuda"):
        dev = resolve_device(device)
        if part.device != dev:
            raise ValueError(f"the partition lives on {part.device}, the "
                             f"server was asked for {dev}")
        self.part = part
        self.device = dev
        self.pool = SlotPool(n_slots)
        self.queue: deque = deque()
        self.client_batch = client_batch
        self._feat = part.boundary_shape(client_batch)[1:]
        self.n_batches = 0
        self.n_served = 0
        self.occupancy: list = []
        self.faults = faults
        self.n_rejected = 0
        self.rejected: list = []
        self.n_blackout_steps = 0

    def submit(self, client_id: int, payload: bytes, t: float = 0.0) -> bool:
        """Queue one wire payload; returns whether it was accepted.  With a
        fault plan a frame that fails its integrity check is rejected and
        counted (the client's retry loop re-sends it)."""
        if self.faults is not None:
            try:
                W.from_bytes(payload)
            except W.WireError:
                self.n_rejected += 1
                self.rejected.append(client_id)
                return False
        self.queue.append(TailRequest(client_id, payload, t))
        return True

    def step(self, now: Optional[float] = None) -> dict:
        """Serve up to ``n_slots`` queued requests in one batched forward.
        Returns ``{client_id: logits}`` for the requests served.  ``now``, a
        virtual-clock time, lets the fault plan's blackout windows apply: a
        step inside one serves nothing."""
        if (self.faults is not None and now is not None
                and self.faults.blackout_at(now)):
            self.n_blackout_steps += 1
            return {}
        while self.queue and self.pool.free_slots():
            self.pool.admit(self.queue.popleft())
        active = self.pool.occupied()
        if not active:
            return {}
        fb = torch.zeros((len(self.pool), self.client_batch) + self._feat,
                         device=self.device)
        for slot, req in active:
            fb[slot] = W.decode_activation(W.from_bytes(req.payload),
                                           self.part.ae, device=self.device)
        logits = self.part.tail(
            fb.reshape((len(self.pool) * self.client_batch,) + self._feat))
        logits = logits.cpu().numpy().reshape(
            (len(self.pool), self.client_batch) + tuple(logits.shape[1:]))
        out = {}
        for slot, req in active:
            out[req.client_id] = logits[slot]
            self.pool.release(slot)
        self.n_batches += 1
        self.n_served += len(active)
        self.occupancy.append(len(active))
        return out

    def drain(self) -> dict:
        """Step until the queue and pool are empty; merged results."""
        results = {}
        while self.queue or self.pool.any_active():
            results.update(self.step())
        return results


def run_clients(model, params, split_layer: int, client_inputs, *,
                ae: Optional[dict] = None, n_slots: int = 4,
                quantize: bool = True, device="cuda") -> tuple:
    """N clients each run the head locally; one TailServer serves their
    wire payloads.  Returns ``({client_id: logits}, server)``."""
    part = make_partition(model, params, split_layer, ae, device=device)
    xs = [torch.as_tensor(x, dtype=torch.float32, device=part.device)
          for x in client_inputs]
    server = TailServer(part, n_slots=n_slots, client_batch=xs[0].shape[0],
                        device=part.device)
    for cid, x in enumerate(xs):
        pkt = W.encode_activation(part.head(x), part.ae, quantize=quantize)
        server.submit(cid, W.to_bytes(pkt))
    return server.drain(), server
