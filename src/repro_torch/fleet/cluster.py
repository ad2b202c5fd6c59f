# Copied from src/repro/fleet/cluster.py.
"""Discrete-event cluster model: admission queue, dynamic batching,
replicas.

One server deployment = ``n_replicas`` identical replicas, each costed by
the :class:`repro_torch.serving.engine.BatchCostModel` (fixed per-batch
dispatch/prefill overhead + per-item FLOPs at the platform's effective
throughput).  Requests land in a bounded FIFO admission queue; a dynamic
batching window collects them — a batch dispatches the moment it is full
(the window timer is *cancelled*, exercising the shared engine's event
handles) or when the window expires with work waiting.

Runs on the same :class:`repro_torch.netsim.events.EventQueue` the transport
models use — there is a single event-loop implementation in the repo, and
a cluster can be embedded in an outer simulation by passing its queue in.

Telemetry (``obs=``, a ``repro_torch.obs.Recorder``): every served request
becomes a lifecycle span on the simulated clock (``request`` =
transfer + queue wait + service, with ``wire``/``queue_wait`` child
intervals), every dispatched batch a span on its replica's track, and a
windowed sampler records the fleet's live signals every
``obs.window_s`` simulated seconds — ``fleet.arrival_rate_hz``,
``fleet.queue_depth``, ``fleet.drop_fraction``, ``fleet.utilization``,
``fleet.inflight_bytes``, ``fleet.latency_p50_s`` / ``_p99_s`` (from a
per-window streaming histogram).  With the default null recorder every
telemetry branch is one ``enabled`` check.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.netsim.events import EventQueue
from repro_torch.obs import NULL
from repro_torch.serving.engine import BatchCostModel


@dataclass(frozen=True)
class ClusterConfig:
    n_replicas: int = 1
    max_batch: int = 8
    batch_window_s: float = 2e-3     # dynamic batching window
    queue_limit: int = 4096          # admission queue bound (then: drop)


@dataclass
class RequestRecord:
    rid: int
    t_offer: float                   # arrival at the admission queue
    t_dispatch: float = -1.0
    t_done: float = -1.0
    dropped: bool = False

    @property
    def latency_s(self) -> float:    # queue wait + batch service
        assert self.t_done >= 0, "request not served"
        return self.t_done - self.t_offer

    @property
    def wait_s(self) -> float:
        assert self.t_dispatch >= 0, "request not dispatched"
        return self.t_dispatch - self.t_offer


@dataclass
class ClusterStats:
    served: list = field(default_factory=list)    # RequestRecord
    dropped: int = 0
    batches: int = 0
    busy_s: float = 0.0

    def latencies(self) -> np.ndarray:
        return np.array([r.latency_s for r in self.served])

    def percentile(self, p: float) -> float:
        """``nan`` on an empty run (never raises from ``np.percentile``
        on a zero-length array)."""
        lat = self.latencies()
        return float(np.percentile(lat, p)) if len(lat) else float("nan")

    def drop_fraction(self) -> float:
        n = len(self.served) + self.dropped
        return self.dropped / n if n else 0.0

    def mean_batch(self) -> float:
        """Mean served batch size; ``nan`` when no batch ever ran (an
        empty run has no meaningful batch size — 0 would read as a
        real, catastrophic measurement)."""
        return len(self.served) / self.batches if self.batches \
            else float("nan")

    def utilization(self, n_replicas: int, horizon_s: float) -> float:
        return self.busy_s / (n_replicas * horizon_s) if horizon_s > 0 else 0.0


class ClusterSim:
    """Offer requests with :meth:`offer`, then :meth:`run` the queue."""

    def __init__(self, cost: BatchCostModel, cfg: ClusterConfig,
                 queue: Optional[EventQueue] = None, obs=None,
                 window_s: Optional[float] = None):
        assert cfg.n_replicas >= 1 and cfg.max_batch >= 1
        self.cost, self.cfg = cost, cfg
        self.obs = NULL if obs is None else obs
        self.q = queue if queue is not None else EventQueue(obs=self.obs)
        self.stats = ClusterStats()
        self._waiting = []           # RequestRecord FIFO
        # free replica *indices* (not a count), so batch spans land on a
        # stable per-replica track in the exported trace
        self._free = list(range(cfg.n_replicas))
        self._n_live = cfg.n_replicas   # live pool size (set_replicas)
        self._next_rid = cfg.n_replicas  # fresh track ids for grown pool
        self._retire = 0             # busy replicas to retire on _on_done
        self._window_timer = None    # live EventHandle or None
        self._due = False            # window expired with work still waiting
        # ------------------------------------------------- telemetry ----
        self.window_s = (window_s if window_s is not None
                         else self.obs.window_s)
        self._sampling = False
        self._win = {"t0": 0.0, "arrivals": 0, "drops": 0, "offered": 0,
                     "busy_s": 0.0}
        self._win_lat = self.obs.metrics.histogram("fleet.window_latency_s")
        self._inflight_bytes = 0
        self._pre = {}               # rid -> (t_tx_start, tx_bytes)

    # ---------------------------------------------------- live controls ----
    @property
    def queue_depth(self) -> int:
        """Requests admitted but not yet dispatched — the live signal
        the adaptive controller samples."""
        return len(self._waiting)

    @property
    def n_replicas(self) -> int:
        """Live replica-pool size (``set_replicas`` moves it; ``cfg``
        keeps the configured starting point)."""
        return self._n_live

    def set_replicas(self, k: int) -> None:
        """Resize the replica pool in place (fail/recover injection).

        Growth adds fresh replicas immediately (new trace track ids, so
        a recovered replica is visibly a different machine) and
        dispatches any ready work.  Shrinkage retires idle replicas
        first; busy ones finish their in-flight batch and then leave —
        graceful failover, a failure never kills a running batch.
        """
        assert k >= 1
        while k > self._n_live:
            if self._retire > 0:     # un-cancel a pending retirement
                self._retire -= 1
            else:
                self._free.append(self._next_rid)
                self._next_rid += 1
            self._n_live += 1
        while k < self._n_live:
            if self._free:
                self._free.pop()
            else:
                self._retire += 1    # consumed by the next _on_done
            self._n_live -= 1
        self._dispatch_ready()

    # ------------------------------------------------------------ intake ----
    def offer(self, rid: int, t_arrival: float, *, tx_s: float = 0.0,
              tx_bytes: int = 0) -> None:
        """Schedule one request's arrival at the admission queue.

        ``tx_s``/``tx_bytes`` describe the wire transfer that *precedes*
        the arrival (the request is in flight over the link during
        ``[t_arrival - tx_s, t_arrival]`` carrying ``tx_bytes``): purely
        telemetry — it feeds the ``fleet.inflight_bytes`` gauge and the
        per-request ``wire`` span, and changes nothing when tracing is
        off."""
        if self.obs.enabled and tx_bytes > 0:
            self._pre[rid] = (t_arrival - tx_s, tx_bytes)
            gauge = self.obs.metrics.gauge("fleet.inflight_bytes")
            self.q.schedule_named(max(0.0, t_arrival - tx_s),
                                  lambda b=tx_bytes: gauge.add(b),
                                  "tx-start")
        self.q.schedule_named(t_arrival, lambda r=rid: self._on_arrival(r),
                              "arrival")

    def offer_trace(self, arrivals) -> None:
        """arrivals: iterable of ``(rid, t_arrival)`` or
        ``(rid, t_arrival, tx_s, tx_bytes)`` rows.  The 4-field form
        forwards the wire metadata :meth:`offer` supports — without it,
        trace-driven runs silently lost the ``wire`` span and the
        ``fleet.inflight_bytes`` gauge."""
        for row in arrivals:
            if len(row) == 2:
                rid, t = row
                self.offer(rid, t)
            else:
                rid, t, tx_s, tx_bytes = row
                self.offer(rid, t, tx_s=tx_s, tx_bytes=int(tx_bytes))

    def run(self, until: float = float("inf")) -> ClusterStats:
        if self.obs.enabled and not self._sampling and not self.q.empty():
            self._sampling = True
            self._win["t0"] = self.q.now
            self.q.schedule_named(self.q.now + self.window_s,
                                  self._sample_window, "metrics-window")
        self.q.run(until=until)
        return self.stats

    # ------------------------------------------------------------ events ----
    def _on_arrival(self, rid: int) -> None:
        obs = self.obs
        if obs.enabled:
            self._win["offered"] += 1
            self._win["arrivals"] += 1
            obs.metrics.counter("fleet.arrivals").inc()
            if rid in self._pre:
                obs.metrics.gauge("fleet.inflight_bytes").add(
                    -self._pre[rid][1])
        if len(self._waiting) >= self.cfg.queue_limit:
            self.stats.dropped += 1
            if obs.enabled:
                self._win["drops"] += 1
                obs.metrics.counter("fleet.drops").inc()
                self._pre.pop(rid, None)
            return
        self._waiting.append(RequestRecord(rid, self.q.now))
        if len(self._waiting) >= self.cfg.max_batch:
            self._dispatch_ready()
        elif self._window_timer is None and not self._due:
            self._window_timer = self.q.schedule_named(
                self.q.now + self.cfg.batch_window_s, self._on_window,
                "batch-window")

    def _on_window(self) -> None:
        self._window_timer = None
        self._due = True
        self._dispatch_ready()

    def _dispatch_ready(self) -> None:
        """Start batches while a replica is free and a batch is ready
        (full, or the window has expired on a partial one)."""
        while (self._free and self._waiting
               and (self._due or len(self._waiting) >= self.cfg.max_batch)):
            batch = self._waiting[:self.cfg.max_batch]
            del self._waiting[:self.cfg.max_batch]
            replica = self._free.pop()
            svc = self.cost.service_time(len(batch))
            self.stats.batches += 1
            self.stats.busy_s += svc
            if self.obs.enabled:
                self._win["busy_s"] += svc
                self.obs.metrics.counter("fleet.batches").inc()
            for r in batch:
                r.t_dispatch = self.q.now
            self.q.schedule_named(self.q.now + svc,
                                  lambda b=batch, i=replica:
                                  self._on_done(b, i),
                                  "batch-done")
        if not self._waiting:
            self._due = False
            if self._window_timer is not None:
                self._window_timer.cancel()  # batch filled before the window
                self._window_timer = None
        # invariant: anything still waiting is covered by a live window
        # timer, by _due (window already expired), or is a full batch that
        # dispatches as soon as a replica frees up

    def _on_done(self, batch, replica: int) -> None:
        if self._retire > 0:         # deferred shrink: retire, don't free
            self._retire -= 1
        else:
            self._free.append(replica)
        for r in batch:
            r.t_done = self.q.now
        self.stats.served.extend(batch)
        if self.obs.enabled:
            self._record_batch(batch, replica)
        self._dispatch_ready()

    # --------------------------------------------------------- telemetry ----
    def _record_batch(self, batch, replica: int) -> None:
        tracer = self.obs.tracer
        t_dispatch, t_done = batch[0].t_dispatch, batch[0].t_done
        tracer.add(f"batch[n={len(batch)}]", t_dispatch, t_done,
                   clock="sim", tid=f"replica{replica}", cat="fleet",
                   args={"n": len(batch)})
        self.obs.metrics.counter("fleet.served").inc(len(batch))
        for r in batch:
            self._win_lat.observe(r.latency_s)
            pre = self._pre.pop(r.rid, None)
            t0 = pre[0] if pre is not None else r.t_offer
            root = tracer.add("request", t0, r.t_done, clock="sim",
                              tid="requests", cat="fleet",
                              args={"rid": r.rid, "wait_s": r.wait_s,
                                    "batch": len(batch)})
            if pre is not None:
                tracer.add("wire", t0, r.t_offer, clock="sim",
                           tid="requests", cat="fleet",
                           args={"bytes": pre[1]}, parent=root)
            if r.wait_s > 0:
                tracer.add("queue_wait", r.t_offer, r.t_dispatch,
                           clock="sim", tid="requests", cat="fleet",
                           parent=root)
            tracer.add("service", r.t_dispatch, r.t_done, clock="sim",
                       tid="requests", cat="fleet", parent=root)

    def _sample_window(self) -> None:
        """One windowed sample of the live fleet signals, self-scheduled
        every ``window_s`` while other events remain (the chain ends
        itself when the simulation drains, so ``run(until=inf)``
        terminates)."""
        m, t, w = self.obs.metrics, self.q.now, self._win
        dt = max(t - w["t0"], 1e-12)
        m.record("fleet.arrival_rate_hz", t, w["arrivals"] / dt)
        m.record("fleet.queue_depth", t, len(self._waiting))
        m.record("fleet.drop_fraction", t,
                 w["drops"] / w["offered"] if w["offered"] else 0.0)
        m.record("fleet.utilization", t,
                 w["busy_s"] / (self._n_live * dt))
        m.record("fleet.inflight_bytes", t,
                 m.gauge("fleet.inflight_bytes").value)
        if self._win_lat.n:
            m.record("fleet.latency_p50_s", t, self._win_lat.percentile(50))
            m.record("fleet.latency_p99_s", t, self._win_lat.percentile(99))
        self._win = {"t0": t, "arrivals": 0, "drops": 0, "offered": 0,
                     "busy_s": 0.0}
        self._win_lat.reset()
        if self.q.peek() < float("inf"):
            self.q.schedule_named(t + self.window_s, self._sample_window,
                                  "metrics-window")
        else:
            self._sampling = False
